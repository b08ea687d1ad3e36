"""The mean milliseconds a request waits in serve's dispatcher queue, from
``submit`` to the dispatcher taking it (lr-lift-sat), over the window: the
program's counter ``Coalescer.stats['queue_wait_s']`` over its
``merged_requests``. None where the program keeps no such counter."""


def read(r: dict):
    c = r.get("coalescer")
    if not c or not c.get("merged_requests") or "queue_wait_s" not in c:
        return None
    return 1e3 * c["queue_wait_s"] / c["merged_requests"]


LAYER = "dispatcher (cli/serve.py:Coalescer)"
UNIT = "ms"
SOURCE = "program_counter"
MOVES = "lift_poses_per_s"
