"""The host milliseconds serve's dispatcher spends on one run outside the
wait and the device work (lr-lift-sat), over the window: its ``serve.merge``
and ``serve.reply`` spans (the drain and concatenation of the requests; the
outputs' concatenation, the callers' slices and their wake-up), which the
program sums in ``Coalescer.stats['dispatch_host_s']``, over its
``device_batches``. Where the host blocks on the device (a full launch
queue), that time shows in the span that blocked. None where the program
keeps no such sum."""


def read(r: dict):
    c = r.get("coalescer")
    if not c or not c.get("device_batches") or "dispatch_host_s" not in c:
        return None
    return 1e3 * c["dispatch_host_s"] / c["device_batches"]


LAYER = "dispatcher (cli/serve.py:Coalescer)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "lift_poses_per_s"
