"""On the card, at each cell's own size: the control (the reference one
precision below the configuration's, in the program's place) fails at least
one of the cell's checks on three seeds, and so does a training cell's
planted fault (half of each batch left out), while the program passes them
all.

    python -m pytest -m cuda portbench/tests/test_portbench_card.py

Skips without a CUDA device (decided inside the test)."""

from __future__ import annotations

import pytest
import torch

from portbench import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size runs on the card")
    cell = spec.cell(name)
    drv = spec.runner(cell.traffic["kind"])
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        got = drv.calibrate(cell, seed, torch.device("cuda", 0), control=True)
        assert all(got["program"][k] <= limit for k, limit in cell.limits.items()), got
        wrong = [v for k, v in got.items() if k.startswith(("control", "fault"))]
        assert wrong and all(any(w[k] > limit for k, limit in cell.limits.items())
                             for w in wrong), got
