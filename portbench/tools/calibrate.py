"""The readings the correctness limits are set from, on the card, in one
process per cell.

    python3 portbench/tools/calibrate.py --cell lr3a-train --seeds 1 2 ... 12 --control 3

For every seed one JSON line with the program's numbers (set-up and the
recorded first steps, or a short window at the cell's load, as a run makes
them); for the last ``--control`` seeds also the control's (the reference in
the precision below the configuration's, in the program's place) and, for
training cells, a planted fault's (half of each batch left out).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from portbench import spec  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cell", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    args = p.parse_args()
    cell = spec.cell(args.cell)
    drv = spec.runner(cell.traffic["kind"])
    dev = torch.device("cuda", 0)
    for k, seed in enumerate(args.seeds):
        out = drv.calibrate(cell, seed, dev, control=k >= len(args.seeds) - args.control)
        print(json.dumps({"cell": cell.name, "seed": seed, **out}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
