"""A run of each cell, its look for a card skipped, on the CPU at hidden 256,
first sound (``correct`` true), then with its timed path broken underneath
(``correct`` false): a step that leaves the state unchanged, half of each
batch left out with the mean over the rest, an answer altered where it is
produced. (One card: no exchange between chips to leave out.)"""

from __future__ import annotations

import pytest
import torch
from conftest import small_cell

from portbench import spec

CPU = torch.device("cpu")


def _run(name: str, seed: int = 2 ** 31 + 9, open_loop: bool = False):
    cell = small_cell(name, open_loop=open_loop)
    return spec.runner(cell.traffic["kind"]).run(cell, seed, 0.3, False, CPU, {})


@pytest.mark.parametrize("name,open_loop", [("lr3a-train", False), ("occ4-train", False),
                                            ("lr-lift-sat", False), ("lr-lift-sat", True)])
def test_sound_run_is_correct(name, open_loop):
    out = _run(name, open_loop=open_loop)
    assert out.correct, [(c.name, c.value, c.limit) for c in out.checks]
    assert out.attempted > 0 and out.failed == 0


@pytest.mark.parametrize("name", ["lr3a-train", "occ4-train"])
def test_state_left_unchanged(name, monkeypatch):
    from links_tpu_torch.train import optim

    monkeypatch.setattr(optim.Adam, "step", lambda self, grads, norm=None: None)
    assert not _run(name).correct


def _half_rows(n: int) -> torch.Tensor:
    """The first half of each of the two blocks [batch; samples] of n rows."""
    b, h = n // 2, n // 4
    return torch.cat([torch.arange(h), torch.arange(b, b + h)])


def test_half_batch_left_right(monkeypatch):
    from links_tpu_torch.objectives import lifter as lifter_obj

    real = lifter_obj.left_right_loss

    def half(model, frozen, inp, u, e, *args, **kw):
        keep = _half_rows(inp.shape[0]).to(inp.device)
        return real(model, frozen, inp[keep], u[keep], e[keep], *args, **kw)

    monkeypatch.setattr(lifter_obj, "left_right_loss", half)
    assert not _run("lr3a-train").correct


def test_half_batch_occlusion(monkeypatch):
    from links_tpu_torch.objectives import occlusion as occ_obj

    real = occ_obj.occlusion_loss

    def half(model, pose_3d, u_rot, *args, **kw):
        k = pose_3d.shape[0] // 2
        return real(model, pose_3d[:k], u_rot[:, :k], *args, **kw)

    monkeypatch.setattr(occ_obj, "occlusion_loss", half)
    assert not _run("occ4-train").correct


@pytest.mark.parametrize("open_loop", [False, True])
def test_answer_altered(open_loop, monkeypatch):
    from links_tpu_torch.cli import lift

    real = lift.build_serving_fn

    def altered(*args, **kw):
        fn, batch, mods = real(*args, **kw)

        def call(p2d):
            out = fn(p2d)
            return torch.cat([out[:, :-1], out[:, -1:] * (1 + 1e-3)], dim=1)

        return call, batch, mods

    monkeypatch.setattr(lift, "build_serving_fn", altered)
    assert not _run("lr-lift-sat", open_loop=open_loop).correct


@pytest.mark.parametrize("open_loop", [False, True])
def test_answer_missing(open_loop, monkeypatch):
    from links_tpu_torch.cli import lift

    real, armed = lift.build_serving_fn, []

    def failing(*args, **kw):
        fn, batch, mods = real(*args, **kw)

        def call(p2d):
            if armed:  # past the set-up: every run fails, and its retries
                raise RuntimeError("a lost device run")
            return fn(p2d)

        return call, batch, mods

    drv = spec.runner("serving")
    real_build = drv.build

    def build(*args, **kw):
        prog = real_build(*args, **kw)
        armed.append(True)
        return prog

    monkeypatch.setattr(lift, "build_serving_fn", failing)
    monkeypatch.setattr(drv, "build", build)
    out = drv.run(small_cell("lr-lift-sat", open_loop=open_loop), 2 ** 31 + 9, 0.3, False, CPU,
                  {})
    assert not out.correct and out.failed > 0
