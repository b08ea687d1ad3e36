"""Int8 serving (links_tpu_torch/ops/quant.py) against links_tpu/ops/quant.py
on the CPU: the int8 weights and scales, one int8 dense, whole quantized
lifters and the eight completers, static calibration with its coverage
rules, the attention lifter's float leaves, and ``lift``/``eval_h36m
--quant`` against the JAX CLIs. Both packages get the same weights through
``*_params_from_jax``."""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_suite import one_cpu_thread  # noqa: F401  (an autouse fixture)
from links_tpu import models as jmodels
from links_tpu.cli import eval_h36m as jeval
from links_tpu.cli import lift as jlift
from links_tpu.core import nn as jnn
from links_tpu.core.skeleton import split_data_left_right as j_split_lr
from links_tpu.models.attention import init_attention_lifter
from links_tpu.objectives import lift_left_right_eval as j_left_right
from links_tpu.ops import quant as jquant
from links_tpu_torch.ckpt.torch_io import (
    attention_lifter_params_from_jax,
    lifter_from_state_dict,
    lifter_params_from_jax,
)
from links_tpu_torch.cli import eval_h36m as teval
from links_tpu_torch.cli import lift as tlift
from links_tpu_torch.core.nn import Linear
from links_tpu_torch.core.skeleton import split_data_left_right
from links_tpu_torch.models import lifters as tlifters
from links_tpu_torch.models.lifters import StackedLifter
from links_tpu_torch.objectives.lifter import lift_left_right_eval
from links_tpu_torch.ops import quant as tquant
from test_torch_eval import model_dirs  # noqa: F401  (a fixture)
from test_torch_occlusion import _port_completers, models  # noqa: F401  (models: a fixture)
from test_torch_train_step import _poses

HID = 128
# A quantized model against the JAX package's, jitted as its CLIs run it.
# XLA fuses the f32 rescale (acc * (x_scale * w_scale) + b) into one
# multiply-add, which rounds once where the port rounds twice, so a
# pre-activation can differ by one ulp; where that value sits at a tie of
# the next layer's int8 rounding (x / x_scale at k + 1/2), the activation
# quantizes one step apart and every output of that row moves by about one
# int8 step of that layer's scale (3.0e-3 on outputs up to 0.59 observed,
# in one row of the torso completer's 16). So: the coordinates of a row
# without such a flip within QUANT_TOL; a row with one within
# QUANT_FLIP_ATOL; at most QUANT_FLIP_SHARE of the rows flipped (the share
# is printed). Against the JAX package run op by op (no fusion) the port is
# bitwise equal.
QUANT_TOL = {"rtol": 1e-5, "atol": 1e-5}
QUANT_FLIP_ATOL = 1e-2
QUANT_FLIP_SHARE = 0.15
# eval's metrics, means over the split: a flipped row moves its pose's error
# by at most a few int8 steps
QUANT_METRIC_RTOL = 1e-3


def _jax_lifter(seed, joints, hidden=HID):
    return jax.tree.map(np.asarray, jmodels.init_lifter(jax.random.PRNGKey(seed), joints,
                                                        hidden=hidden))


def _port(tree):
    return lifter_from_state_dict(lifter_params_from_jax(tree))


def _jax_linear(tree, name: str) -> dict:
    for part in name.split("."):
        tree = tree[part]
    return tree


def _quant_linears(module) -> dict:
    return {n: m for n, m in module.named_modules() if isinstance(m, tquant.QuantLinear)}


def _close(got, want, what: str) -> float:
    """Hold ``got`` to ``want`` (rows of outputs) by QUANT_TOL, QUANT_FLIP_ATOL
    and QUANT_FLIP_SHARE; -> the share of rows with a flip (printed)."""
    got, want = np.asarray(got), np.asarray(want)
    got, want = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    flipped = (~np.isclose(got, want, **QUANT_TOL)).any(axis=1)
    share = float(flipped.mean())
    print(f"{what}: {flipped.sum()} of {len(flipped)} rows with an int8 rounding flip "
          f"(share {share:.4f}), max abs err {np.abs(got - want).max():.3e}")
    assert share <= QUANT_FLIP_SHARE, (what, share)
    np.testing.assert_allclose(got, want, rtol=0, atol=QUANT_FLIP_ATOL, err_msg=what)
    return share


@pytest.mark.parametrize("joints", [11, 7, 10])
def test_quantized_weights_match_jax(joints):
    """w_q bitwise (JAX's transposed), w_scale within 1 ulp, biases kept;
    every Linear converted, none left."""
    tree = _jax_lifter(joints, joints)
    qtree = jquant.quantize_params(tree)
    q = tquant.quantize_params(_port(tree))
    lins = _quant_linears(q)
    assert len(lins) == 17 and not any(isinstance(m, Linear) for m in q.modules())
    assert tquant.is_quantized(q) and not tquant.is_quantized(_port(tree))
    for name, m in lins.items():
        want = _jax_linear(qtree, name)
        assert m.w_q.dtype == torch.int8 and m.x_scale is None
        np.testing.assert_array_equal(m.w_q.numpy(), np.asarray(want["w_q"]).T, err_msg=name)
        np.testing.assert_array_max_ulp(m.w_scale.numpy(), np.asarray(want["w_scale"])[0],
                                        maxulp=1)
        np.testing.assert_array_equal(m.b.numpy(), np.asarray(want["b"]))


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("fan_in,fan_out,rows", [(22, HID, 13), (HID, HID, 64), (HID, 11, 1),
                                                 (HID, 1, 5)])
def test_int8_dense_is_bitwise_the_jax_one(rng, static, fan_in, fan_out, rows):
    """One int8 dense, dynamic or static scale: bitwise JAX's ``_dense_int8``
    (called op by op)."""
    lin = jax.tree.map(np.asarray, jnn.init_linear(jax.random.PRNGKey(fan_out), fan_in,
                                                     fan_out))
    q = jquant.quantize_params(lin)
    x = rng.normal(size=(rows, fan_in)).astype(np.float32)
    x_scale = None
    if static:
        x_scale = np.float32(np.abs(x).max() * 0.8 / 127.0)  # some rows clip at +-127
        q = dict(q, x_scale=jnp.float32(x_scale))
    want = np.asarray(jnn._dense_int8(q, jnp.asarray(x)))
    w_q, w_scale = tquant.quantize_weight(torch.from_numpy(lin["w"].T.copy()))
    got = tquant.dense_int8(torch.from_numpy(x), w_q, w_scale, torch.from_numpy(lin["b"]),
                            None if x_scale is None else torch.tensor(x_scale))
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_dense_of_tokens(rng):
    """A (B, J, 2) input (the attention lifter's joint tokens): dynamic scales
    per token, bitwise JAX's."""
    lin = jax.tree.map(np.asarray, jnn.init_linear(jax.random.PRNGKey(4), 2, 64))
    q = jquant.quantize_params(lin)
    x = rng.normal(size=(3, 11, 2)).astype(np.float32)
    want = np.asarray(jnn._dense_int8(q, jnp.asarray(x)))
    w_q, w_scale = tquant.quantize_weight(torch.from_numpy(lin["w"].T.copy()))
    got = tquant.dense_int8(torch.from_numpy(x), w_q, w_scale, torch.from_numpy(lin["b"]))
    assert got.shape == (3, 11, 64)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,k,n", [(3, 22, 11), (1, 2, 64), (40, 128, 1), (17, 24, 16)])
def test_int8_matmul_pads_exactly(m, k, n):
    """The padding of the int8 product to what the card takes (more than 16
    rows, K and N multiples of 8) adds nothing: the product sliced back is
    the integer product."""
    g = torch.Generator().manual_seed(m)
    x = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    assert tquant._pad_to(tquant._pad_to(x, 1, 24), 0, 17).shape == (max(m, 17), max(k, 24))
    assert torch.equal(tquant.int8_matmul(x, w), x.int() @ w.int().T)


@pytest.mark.parametrize("joints", [11, 7])
def test_quantized_lifter_matches_jax(rng, joints):
    """A whole quantized lifter: bitwise the JAX one op by op, and held by
    ``_close`` to it jitted (as its CLIs serve)."""
    tree = _jax_lifter(joints + 1, joints)
    qtree = jquant.quantize_params(tree)
    x = rng.normal(size=(32, 2 * joints)).astype(np.float32) * 0.1
    with torch.no_grad():
        got = tquant.quantize_params(_port(tree))(torch.from_numpy(x))
    eager = jmodels.lifter_apply(qtree, jnp.asarray(x))
    jitted = jax.jit(jmodels.lifter_apply)(qtree, jnp.asarray(x))
    for g, e, j, what in zip(got, eager, jitted, ("depth", "angle")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e), err_msg=what)
        _close(g.numpy(), j, f"quantized lifter {joints} {what}, jitted")


def test_quantized_completers_match_jax(models, rng):  # noqa: F811
    """All eight quantized completers: bitwise op by op, held by ``_close``
    to the jitted JAX forward."""
    trees, _ = models
    qtrees = jquant.quantize_params(trees)
    port = tquant.quantize_params(_port_completers(trees))
    for name, completer in port.items():
        x = rng.normal(size=(16, completer.upscale.w_q.shape[1])).astype(np.float32) * 0.5
        with torch.no_grad():
            got = completer(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jmodels.completer_apply(qtrees[name], jnp.asarray(x))), err_msg=name)
        _close(got, jax.jit(jmodels.completer_apply)(qtrees[name], jnp.asarray(x)),
               f"quantized completer {name}, jitted")


def test_quantized_block_calls_no_kernel(monkeypatch, rng):
    """A quantized residual block composes its int8 linears and never reaches
    the residual-block kernel's wrapper."""
    q = tquant.quantize_params(_port(_jax_lifter(3, 11)))

    def boom(*a, **k):
        raise AssertionError("the residual-block kernel was called")

    monkeypatch.setattr(tlifters, "res_block", boom)
    with torch.no_grad():
        depth, angle = q(torch.from_numpy(rng.normal(size=(4, 22)).astype(np.float32)))
    assert depth.shape == (4, 11) and angle.shape == (4, 1)


def _jax_static(tree, calib):
    return jquant.quantize_params_static(tree, lambda p: jmodels.lifter_apply(p, calib))


@pytest.mark.parametrize("runner", ["full", "none"])
def test_static_calibration_matches_jax(rng, runner):
    """The recorded x_scale of every linear within 1 ulp of JAX's, the same
    static/dynamic counts; a runner that reaches nothing leaves every linear
    dynamic."""
    tree = _jax_lifter(7, 11)
    calib = rng.normal(size=(64, 22)).astype(np.float32) * 0.1
    if runner == "full":
        qtree, ns, nd = _jax_static(tree, calib)
        q, ts, td = tquant.quantize_params_static(_port(tree),
                                                  lambda m: m(torch.from_numpy(calib)))
    else:
        qtree, ns, nd = jquant.quantize_params_static(tree, lambda p: None)
        q, ts, td = tquant.quantize_params_static(_port(tree), lambda m: None)
    assert (ts, td) == (ns, nd) == ((17, 0) if runner == "full" else (0, 17))
    for name, m in _quant_linears(q).items():
        want = _jax_linear(qtree, name)
        assert (m.x_scale is None) == ("x_scale" not in want), name
        if m.x_scale is not None:
            np.testing.assert_array_max_ulp(m.x_scale.numpy(), np.asarray(want["x_scale"]),
                                            maxulp=1)
    x = rng.normal(size=(16, 22)).astype(np.float32) * 0.1
    with torch.no_grad():
        got = q(torch.from_numpy(x))
    for g, w in zip(got, jmodels.lifter_apply(qtree, jnp.asarray(x))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("coverage", ["uniform", "nonuniform"])
def test_static_pair_coverage_matches_jax(rng, coverage):
    """``quantize_stacked_static`` on the (left, right) pair: each side
    calibrated on its half of the poses; a linear calibrated in only one side
    serves dynamic scales in both (here: the right side reaches only its
    upscale), with JAX's counts and scales."""
    left, right = _jax_lifter(8, 11), _jax_lifter(9, 11)
    stacked = jax.tree.map(lambda a, b: np.stack([a, b]), left, right)
    calib = _poses(64, seed=3)
    j_sides = j_split_lr(calib)
    t_sides = split_data_left_right(torch.from_numpy(calib))

    def jrun(p, i):
        if coverage == "uniform" or i == 0:
            jmodels.lifter_apply(p, np.asarray(j_sides[i]))
        else:
            jnn.dense(p["upscale"], np.asarray(j_sides[i]))

    def trun(host, i):
        if coverage == "uniform" or i == 0:
            host(t_sides[i])
        else:
            host.upscale(t_sides[i])

    qtree, ns, nd = jquant.quantize_stacked_static(stacked, jrun)
    q, ts, td = tquant.quantize_stacked_static(StackedLifter(_port(left), _port(right)), trun)
    assert (ts, td) == (ns, nd) == ((34, 0) if coverage == "uniform" else (2, 32))
    for i, side in enumerate((q.left, q.right)):
        for name, m in _quant_linears(side).items():
            want = _jax_linear(qtree, name)
            assert (m.x_scale is None) == ("x_scale" not in want), (i, name)
            if m.x_scale is not None:
                np.testing.assert_array_max_ulp(m.x_scale.numpy(),
                                                np.asarray(want["x_scale"])[i], maxulp=1)
    poses = _poses(16, seed=4)
    with torch.no_grad():
        got = lift_left_right_eval(q, torch.from_numpy(poses)).numpy()
    _close(got, jax.jit(j_left_right)(qtree, jnp.asarray(poses)),
           f"int8-static pair ({coverage} coverage), jitted")


def test_attention_qkv_and_pos_stay_float(rng):
    """The attention lifter's qkv and pos stay float (JAX keeps its 4-D qkv
    leaf and pos), its Linears convert; the quantized forward matches the
    JAX one op by op and stays near the float one."""
    tree = jax.tree.map(np.asarray, init_attention_lifter(jax.random.PRNGKey(6), 11))
    port = lifter_from_state_dict(attention_lifter_params_from_jax(tree))
    q = tquant.quantize_params(port)
    assert torch.equal(q.qkv.weight, port.qkv.weight) and q.qkv.weight.dtype == torch.float32
    assert torch.equal(q.pos, port.pos)
    assert set(_quant_linears(q)) == {"embed", "proj", "upscale", "downscale", "angles"} | {
        f"{b}.{l}" for b in ("res_common", "res_pose1", "res_pose2", "res_angle1",
                             "res_angle2") for l in ("l1", "l2")}
    qtree = jquant.quantize_params(tree)
    x = rng.normal(size=(4, 22)).astype(np.float32) * 0.1
    with torch.no_grad():
        got, exact = q(torch.from_numpy(x)), port(torch.from_numpy(x))
    for g, w in zip(got, jmodels.lifter_apply(qtree, jnp.asarray(x))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    rel = float((got[0] - exact[0]).norm() / exact[0].norm())
    assert rel < 0.1, rel


# --- the CLIs ----------------------------------------------------------------

LIFT_CASES = {
    "int8": ["--quant", "int8"],
    "int8-static": ["--quant", "int8-static"],
    "leg_torso int8": ["--mode", "leg_torso", "--quant", "int8"],
    "leg_torso int8-static": ["--mode", "leg_torso", "--quant", "int8-static"],
    "scenario ll int8": ["--scenario", "ll", "--quant", "int8"],
}


@pytest.mark.parametrize("case", list(LIFT_CASES))
def test_lift_quant_matches_jax(model_dirs, case, monkeypatch, capsys, tmp_path):  # noqa: F811
    """``lift --quant`` of the port against the JAX package's on the same
    weights and poses, held by ``_close``; int8-static says what it
    calibrated."""
    ws, port, jdir = model_dirs
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    common = ["--data", str(ws / "synthetic.pkl"), "--calib-rows", "32", *LIFT_CASES[case]]
    want = jlift.main([*common, "--model-dir", str(jdir), "--out", str(tmp_path / "j.npz")])
    capsys.readouterr()
    got = tlift.main([*common, "--model-dir", str(port), "--device", "cpu",
                      "--out", str(tmp_path / "t.npz")])
    captured = capsys.readouterr()
    assert json.loads(captured.out.strip().splitlines()[-1])["quant"] == LIFT_CASES[case][-1]
    if case.endswith("int8-static"):
        assert "int8-static: 34 linears calibrated on 32 train rows, 0 dynamic fallback" \
            in captured.err
    assert got.shape == want.shape
    _close(got, want, f"lift {case}")


EVAL_CASES = {
    "int8": ["--quant", "int8"],
    "int8-static": ["--quant", "int8-static"],
    "leg_torso int8-static": ["--mode", "leg_torso", "--quant", "int8-static"],
    "occlusion int8-static": ["--occlusion", "--quant", "int8-static"],
}


def _eval_json(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results = main(argv)
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == results
    return results


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_eval_quant_matches_jax(model_dirs, case, monkeypatch):  # noqa: F811
    """``eval_h36m --quant``: the JAX eval's keys in its order (with
    ``quant_fallback_dynamic`` for the occlusion paths under int8-static),
    its values within QUANT_METRIC_RTOL."""
    ws, port, jdir = model_dirs
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    common = ["--data", str(ws / "synthetic.pkl"), "--json", "--calib-rows", "32",
              *EVAL_CASES[case]]
    want = _eval_json(jeval.main, [*common, "--model-dir", str(jdir)])
    got = _eval_json(teval.main, [*common, "--model-dir", str(port), "--device", "cpu"])
    assert list(got) == list(want)
    assert ("quant_fallback_dynamic" in got) == case.startswith("occlusion")
    for k, w in want.items():
        if isinstance(w, (str, list)):
            assert got[k] == w, k
        else:
            np.testing.assert_allclose(got[k], w, rtol=QUANT_METRIC_RTOL, err_msg=k)
