"""The traffic generator and the data: deterministic under the seed, the
same sizes and gaps for every seed, and large seeds taken."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import core, data, spec, traffic

CLOSED = spec.cell("lr-lift-sat").traffic
# the same clips as open-loop arrivals (the generator's other mode)
MIX = dict({k: v for k, v in CLOSED.items() if k != "callers"}, rate_per_s=800.0)
BIG = 2 ** 31 + 12345


def test_same_seed_same_schedule():
    assert traffic.schedule(MIX, BIG, 5.0) == traffic.schedule(MIX, BIG, 5.0)
    assert traffic.schedule(MIX, BIG, 5.0) != traffic.schedule(MIX, BIG + 1, 5.0)


def test_every_seed_same_sizes_and_gaps():
    n = MIX["sizes"]
    for seed in (0, 7, BIG, 2 ** 62):
        mix = dict(MIX)
        seconds = float(traffic.gap_set(mix).sum()) * 2 + 1.0
        s = traffic.schedule(mix, seed, seconds)
        assert sorted(x[1] for x in s[:n]) == sorted(traffic.size_set(mix).tolist())
        dues = np.diff([0.0] + [x[0] for x in s[:n]])
        assert np.allclose(sorted(dues), sorted(traffic.gap_set(mix)))
        assert all(0 <= ofs <= mix["pool_poses"] - size for _, size, ofs in s)


def test_closed_loop_sequence():
    """A closed loop's order: deterministic under the seed, every cycle of
    ``sizes`` requests the same set of sizes."""
    n = CLOSED["sizes"]
    a = traffic.sequence(CLOSED, BIG, 3 * n)
    assert a == traffic.sequence(CLOSED, BIG, 3 * n) != traffic.sequence(CLOSED, BIG + 1, 3 * n)
    for k in range(3):
        assert sorted(s for s, _ in a[k * n:(k + 1) * n]) == traffic.size_set(CLOSED).tolist()
    assert all(0 <= ofs <= CLOSED["pool_poses"] - size for size, ofs in a)


def test_sizes_span_the_mix():
    sizes = traffic.size_set(MIX)
    assert sizes.min() >= MIX["min_poses"] and sizes.max() <= MIX["max_poses"]
    assert 4400 < sizes.mean() < 4800  # log-uniform on [512, 16384]: mean 4580


def test_derive_is_stable_and_63_bit():
    assert core.derive(BIG, "weights") == core.derive(BIG, "weights")
    assert core.derive(BIG, "weights") != core.derive(BIG, "data")
    assert 0 <= core.derive(2 ** 70, "x") < 2 ** 63


@pytest.mark.parametrize("make", [data.train_poses, data.test_poses])
def test_poses_deterministic(make):
    a = make(256, torch.Generator().manual_seed(core.derive(BIG, "data")))
    b = make(256, torch.Generator().manual_seed(core.derive(BIG, "data")))
    c = make(256, torch.Generator().manual_seed(core.derive(BIG + 1, "data")))
    assert a.shape == (256, 34) and torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()
    assert torch.all(a.reshape(-1, 2, 17)[:, :, 0] == 0)  # root-centred


def test_poses_keep_bone_lengths():
    cam = data.camera_poses(64, torch.Generator().manual_seed(3))
    rest = torch.tensor(data.REST, dtype=torch.float32)
    for j in range(1, 17):
        p = data.PARENT[j]
        want = torch.linalg.vector_norm(rest[j] - rest[p])
        got = torch.linalg.vector_norm(cam[:, :, j] - cam[:, :, p], dim=1)
        assert torch.allclose(got, want.expand_as(got), rtol=1e-4)
