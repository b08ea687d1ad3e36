"""The CPU side of the fused serving kernel (K2): its tile plan, its
once-checked weights, and the build's source hash. The kernel itself runs
on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from _torch_suite import one_cpu_thread  # noqa: F401  (an autouse fixture)
from links_tpu_torch.models.lifters import Lifter, StackedLifter
from links_tpu_torch.ops import _build
from links_tpu_torch.ops import fused_infer as K2

H100_SMS = 132


@pytest.fixture(scope="module")
def prep():
    g = torch.Generator().manual_seed(0)
    return K2.prepare_fused_weights(StackedLifter(Lifter(11, 128, generator=g),
                                                  Lifter(11, 128, generator=g)))


@pytest.mark.parametrize("hidden", [128, 1024])
def test_plan_covers_every_output_once(hidden):
    """Each block owns one tile in every layer, so one layer's cover is every
    layer's: each (side, row, column) of a layer's output lies in exactly
    one block's tile, for every batch the kernel takes."""
    for batch in range(1, K2.MAX_BATCH + 1):
        p = K2.plan(batch, hidden, H100_SMS)
        seen = np.zeros((2, batch, hidden), np.int32)
        assert len(p.tiles) == p.grid
        for side, tm, tn in p.tiles:
            assert tm * p.rows < batch
            seen[side, tm * p.rows:(tm + 1) * p.rows, tn * p.cols:(tn + 1) * p.cols] += 1
        assert (seen == 1).all(), batch


@pytest.mark.parametrize("hidden", [128, 1024])
def test_plan_fits_the_card(hidden):
    """The rings, their barriers and the constants fit a block's 227 KB of
    shared memory, one block per SM; one A box covers the tile's rows below
    B; a
    ring slot is a whole number of a layer's K tiles, each ring has two
    slots or more (one chunk's products run while the next chunk's wait),
    and the activation ring holds the upscale's inputs."""
    for batch in range(1, K2.MAX_BATCH + 1):
        p = K2.plan(batch, hidden, H100_SMS)
        assert p.smem == K2.smem_bytes(p.rows, p.cols, p.a_rows, p.chunk, p.a_chunks,
                                       p.w_chunks)
        assert p.smem <= K2.SMEM_BYTES and p.grid <= H100_SMS
        assert p.row_tiles <= K2.MAX_ROW_TILES and p.a_chunks >= 2 and p.w_chunks >= 2
        assert (p.rows, p.cols, p.chunk) in {*K2.SHAPES, (64, 16, 2)}
        assert (hidden // 64) % p.chunk == 0
        assert p.a_rows % 8 == 0 and min(batch, p.rows) <= p.a_rows <= p.rows
        assert p.w_chunks * p.chunk <= max(2 * p.chunk, K2.MAX_W_LAYERS * hidden // 64)
        a_ring = p.a_chunks * p.chunk * p.a_rows * 128
        assert a_ring >= K2.scratch_bytes(p.rows, p.cols, K2.FusedWeights.MAX_IN)


@pytest.mark.parametrize("batch,shape,grid", [
    (1, (64, 16, 4), 128), (37, (64, 16, 4), 128), (64, (64, 16, 4), 128),
    (65, (64, 64, 2), 64), (256, (64, 64, 2), 128), (257, (128, 64, 1), 96),
    (512, (128, 64, 1), 128)])
def test_plan_at_full_width(batch, shape, grid):
    """At hidden 1024 on 132 SMs: three tile shapes, ~128 blocks at the
    serving batches (1, 256, 512), each shape's ring slots, and a weight ring
    that holds a whole layer of the tile (16 K tiles), so a layer's weights
    can arrive during the barrier before it."""
    p = K2.plan(batch, 1024, H100_SMS)
    assert ((p.rows, p.cols, p.chunk), p.grid) == (shape, grid)
    assert p.w_chunks * p.chunk >= 1024 // 64
    assert ({tuple(K2.plan(b, 1024, H100_SMS)[:2]) for b in range(1, 513)}
            == {s[:2] for s in K2.SHAPES})


@pytest.mark.parametrize("batch,hidden,sms", [(0, 1024, 132), (513, 1024, 132),
                                              (4, 100, 132), (4, 192, 132), (512, 1024, 64)])
def test_plan_rejects_what_the_kernel_does_not_take(batch, hidden, sms):
    with pytest.raises(ValueError):
        K2.plan(batch, hidden, sms)


def test_prepared_weights_are_checked_once(monkeypatch, prep):
    made = []
    init = K2.FusedWeights.__init__
    monkeypatch.setattr(K2.FusedWeights, "__init__",
                        lambda self, t: (made.append(1), init(self, t))[1])
    g = torch.Generator().manual_seed(1)
    got = K2.prepare_fused_weights(StackedLifter(Lifter(11, 128, generator=g),
                                                 Lifter(11, 128, generator=g)))
    assert isinstance(got, K2.FusedWeights) and len(made) == 1
    with pytest.raises(TypeError):
        got["w_chain"] = got["w_chain"]  # read-only: a call need not check it again
    assert dict(got).keys() == K2.FusedWeights._SHAPES.keys()


@pytest.mark.parametrize("name,change", [
    ("w_chain", lambda t: t.float()),
    ("b_up", lambda t: t[:, :64].contiguous()),
    ("w_down", lambda t: t.mT),
    ("b_chain", lambda t: t.double()),
    ("w_up", lambda t: torch.zeros(2, 40, t.shape[-1], dtype=t.dtype)),
])
def test_fused_weights_reject_what_the_kernel_does_not_take(prep, name, change):
    with pytest.raises(ValueError, match=name):
        K2.FusedWeights({**prep, name: change(prep[name])})


def test_fused_weights_reject_a_missing_tensor(prep):
    with pytest.raises(ValueError, match="b_ang"):
        K2.FusedWeights({k: v for k, v in prep.items() if k != "b_ang"})


def test_build_hash_follows_included_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n#include "a.cuh"\nint f();\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    assert [p.name for p in _build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = _build._target("k")
    (tmp_path / "other.cuh").write_text("// changed\n")
    assert _build._target("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert _build._target("k") != first


def test_both_kernel_sources_share_the_hopper_header():
    for name in ("fused_infer", "resblock"):
        assert [p.name for p in _build.sources(name)] == [f"{name}.cu", "hopper.cuh"]
