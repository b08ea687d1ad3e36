"""Windows per device run of the windowed dispatcher (dst-lift-sat): the
program's counters ``WindowCoalescer.stats['windows']`` over
``['device_batches']``, over the window. None where the program keeps no
such counter."""


def read(r: dict):
    c = r.get("coalescer")
    if not c or not c.get("device_batches") or "windows" not in c:
        return None
    return c["windows"] / c["device_batches"]


LAYER = "dispatcher (cli/serve.py:Coalescer)"
UNIT = "count"
SOURCE = "program_counter"
MOVES = "lift_poses_per_s"
