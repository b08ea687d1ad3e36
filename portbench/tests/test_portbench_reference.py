"""The plain reference held to the port at hidden 256 on the CPU, with the
benchmark's shared weights, rows and draws: the 3a step, the stage-4 step
(three steps each, losses, first gradients, changes) and the f32 lift."""

from __future__ import annotations

import pytest
import torch
from conftest import small_cell

from portbench import core, spec
from portbench.reference import model as ref

CPU = torch.device("cpu")


def _three_steps(cell, seed):
    drv = spec.runner("train_epochs")
    prog = drv.build(cell, seed, CPU)
    drv.epoch(prog)
    record = drv.program_record(prog)
    args = (cell, seed, CPU, prog["sds"], prog["pool"], prog["batch"])
    refr = drv.reference_steps(*args)
    return dict(drv.compare(record, refr, prog["sds"]),
                **drv.grad_rel(record["grad1"], drv.matched_grad1(*args)))


@pytest.mark.parametrize("name", ["lr3a-train", "occ4-train"])
def test_reference_follows_the_f32_step(name):
    """Under F32 products the port's step and the reference are one function."""
    cell = small_cell(name)
    cell.config["train"].update(precision="f32", adam_moments="f32")
    gaps = _three_steps(cell, 2 ** 31 + 3)
    assert gaps["loss1_gap"] < 1e-6
    assert gaps["grad_gap"] < 1e-5
    assert gaps["change_gap"] < 1e-4 and gaps["change_med_gap"] < 1e-5


@pytest.mark.parametrize("name", ["lr3a-train", "occ4-train"])
def test_bf16_step_within_the_cell_limits(name):
    cell = small_cell(name)
    gaps = _three_steps(cell, 17)
    for key, limit in cell.limits.items():
        assert gaps[key] <= limit, (key, gaps[key])
    assert gaps["loss1_gap"] > 0  # bf16 products are not the f32 reference's


@pytest.mark.parametrize("name", ["lr3a-train", "occ4-train"])
def test_reference_at_bf16_follows_the_first_gradient(name):
    """At the configuration's own precision (bf16 products, and the cell's
    moments) the reference's first gradient is the port's up to the order
    of the sums; half of the batch is far from both."""
    cell = small_cell(name)
    drv = spec.runner("train_epochs")
    prog = drv.build(cell, 2 ** 31 + 5, CPU)
    drv.epoch(prog)
    args = (cell, 2 ** 31 + 5, CPU, prog["sds"], prog["pool"], prog["batch"])
    matched = drv.matched_grad1(*args)
    sound = drv.grad_rel(drv.program_record(prog)["grad1"], matched)
    assert sound["grad_rel"] < 1e-4
    half = drv.grad_rel(drv.matched_grad1(*args, half=True), matched)
    assert half["grad_rel_med"] > 100 * sound["grad_rel"]


def test_bf16_products_round_operands_and_operand_gradients():
    g = torch.Generator().manual_seed(4)
    x = torch.randn(8, 16, generator=g, requires_grad=True)
    w = torch.randn(4, 16, generator=g, requires_grad=True)
    dy = torch.randn(8, 4, generator=g)
    y = ref.BF16.mm(x, w)
    y.backward(dy)
    xq, wq = x.detach().bfloat16().float(), w.detach().bfloat16().float()
    assert torch.equal(y, xq @ wq.T)
    assert torch.equal(x.grad, (dy @ wq).bfloat16().float())
    assert torch.equal(w.grad, (dy.T @ xq).bfloat16().float())


def test_reference_follows_the_f32_lift():
    from links_tpu_torch.models.lifters import Lifter, StackedLifter
    from links_tpu_torch.objectives.lifter import lift_left_right_eval

    cell = small_cell("lr-lift-sat")
    drv = spec.runner("serving")
    sds = drv._lifters(cell.config, 5, CPU)
    sides = []
    for side in ("left", "right"):
        with torch.device("meta"):
            m = Lifter(11, cell.config["hidden"])
        m.load_state_dict({k: v.clone() for k, v in sds[side].items()}, assign=True)
        sides.append(m)
    x = torch.randn(300, 34, generator=torch.Generator().manual_seed(1)) * 0.1
    with torch.no_grad():
        got = lift_left_right_eval(StackedLifter(*sides), x, 10.0, "right")
        want = ref.lift(sds, x, 10.0, "right", ref.F32)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-6


def test_controls_round_their_operands():
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    tf = ref.round_tf32(x)
    assert torch.all((tf.view(torch.int32) & 0x1FFF) == 0)
    assert float((tf - x).abs().max() / x.abs().max()) < 2 ** -10
    f8 = ref.round_fp8(x)
    err = float((f8 - x).abs().max() / x.abs().max())
    assert 2 ** -8 < err < 2 ** -3


def test_gap_measure():
    assert core.gap(1.0, 1.0) == 0.0
    assert core.gap(1.1, 1.0) == pytest.approx(0.1)
