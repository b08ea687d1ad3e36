"""The share of the frames the windowed dispatcher ran that were padding
(dst-lift-sat): the program's counters ``WindowCoalescer.stats
['frames_padded']`` over ``['frames_run']``, over the window, in %. None
where the program keeps no such counters."""


def read(r: dict):
    c = r.get("coalescer")
    if not c or not c.get("frames_run") or "frames_padded" not in c:
        return None
    return 100.0 * c["frames_padded"] / c["frames_run"]


LAYER = "dispatcher (cli/serve.py:Coalescer)"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "lift_poses_per_s"
