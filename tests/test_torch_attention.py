"""The attention lifter of links_tpu_torch (models/attention.py) against
links_tpu/models/attention.py on the CPU: shapes and the head count carried
by ``qkv``'s shape, the forward under both policies, the ``.pt`` round trip,
the stage-3a loss and gradients of an attention pair, the residual-block
calls of one 3a step, and ``train_left_right_lifter --attention`` whose
files ``lift``, ``lift --scenario`` and ``eval_h36m`` read and ``lift
--fused`` refuses. Both packages get the same weights through
``attention_lifter_params_from_jax``."""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_suite import module_scratch, one_cpu_thread, scratch  # noqa: F401  (fixtures)
from links_tpu import models as jmodels
from links_tpu.config import LifterTrainConfig as JLifterTrainConfig
from links_tpu.core import nn as jnn
from links_tpu.models.attention import attention_lifter_apply, init_attention_lifter
from links_tpu.objectives import lifter as jlifter_obj
from links_tpu_torch.ckpt.torch_io import (
    attention_lifter_params_from_jax,
    lifter_from_state_dict,
    load_lifter_pt,
    save_completer_pt,
    save_lifter_pt,
)
from links_tpu_torch.cli import eval_h36m as teval
from links_tpu_torch.cli import lift as tlift
from links_tpu_torch.cli import train_left_right_lifter as ttrain
from links_tpu_torch.config import LifterTrainConfig
from links_tpu_torch.core import nn as tnn
from links_tpu_torch.models.attention import BLOCKS, AttentionLifter
from links_tpu_torch.models.completers import COMPLETER_SPECS, Completer
from links_tpu_torch.models.lifters import LEG_JOINTS, TORSO_JOINTS, Lifter, StackedLifter
from links_tpu_torch.objectives import lifter as tlifter_obj
from links_tpu_torch.ops import resblock as tresblock
from links_tpu_torch.train.steps import build_left_right_grads
from test_torch_train_cli import _args, run  # noqa: F401  (run: a fixture)
from test_torch_train_step import (  # noqa: F401  (models: a fixture)
    BF16_TOL,
    GRAD_REL,
    _draws,
    _pin_jax_draws,
    _poses,
    _port_side,
    models,
)

HID = 128
# f32: the same function in another summation order (the einsums, the
# softmax's sum and the matmuls), through 5 blocks
F32_TOL = {"rtol": 1e-5, "atol": 2e-5}
TOL = {"F32": F32_TOL, "BF16": BF16_TOL}


def _jax_attention(seed: int, hidden: int = HID, num_heads: int = 2) -> dict:
    """A links_tpu attention lifter at hidden width ``hidden``: the JAX
    package's init (fixed at width 1024) with its residual-MLP part drawn at
    ``hidden`` (``attention_lifter_apply`` reads the widths from the
    shapes), as numpy."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    tree = dict(init_attention_lifter(k1, 11, num_heads=num_heads))
    mlp = jmodels.init_lifter(k2, 11, hidden=hidden)
    tree.update({k: mlp[k] for k in ("downscale", "angles", *BLOCKS)})
    tree["upscale"] = jnn.init_linear(k3, 11 * 64, hidden)
    return jax.tree.map(np.asarray, tree)


def _port(tree) -> AttentionLifter:
    return lifter_from_state_dict(attention_lifter_params_from_jax(tree))


def test_attention_lifter_shapes():
    g = torch.Generator().manual_seed(0)
    lifter = AttentionLifter(11, num_heads=2, hidden=HID, generator=g)
    depth, angle = lifter(torch.randn(4, 22, generator=torch.Generator().manual_seed(1)))
    assert depth.shape == (4, 11) and angle.shape == (4, 1)
    assert lifter.num_heads == 2 and lifter.qkv.weight.shape == (3, 2, 32, 64)


def test_attention_num_heads_shape_encoded():
    """The head count is carried by qkv's weight shape, through a state dict
    too; a head count that does not divide 64 is refused."""
    g = torch.Generator().manual_seed(0)
    lifter = AttentionLifter(11, num_heads=4, hidden=HID, generator=g)
    assert lifter.qkv.weight.shape == (3, 4, 16, 64) and lifter.qkv.bias.shape == (3, 4, 16)
    again = lifter_from_state_dict(lifter.state_dict())
    assert isinstance(again, AttentionLifter) and again.num_heads == 4
    depth, angle = again(torch.randn(4, 22))
    assert depth.shape == (4, 11) and angle.shape == (4, 1)
    with pytest.raises(ValueError, match="must divide"):
        AttentionLifter(11, num_heads=5, hidden=HID)


@pytest.mark.parametrize("num_heads", [2, 4])
@pytest.mark.parametrize("policy", ["F32", "BF16"])
def test_forward_matches_attention_lifter_apply(rng, num_heads, policy):
    tree = _jax_attention(num_heads, num_heads=num_heads)
    x = rng.normal(size=(13, 22)).astype(np.float32) * 0.1
    with torch.no_grad():
        got = _port(tree)(torch.from_numpy(x), getattr(tnn, policy))
    want = attention_lifter_apply(tree, jnp.asarray(x), getattr(jnn, policy))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL[policy])


def test_pt_round_trip(tmp_path, rng):
    """An attention lifter's .pt is its state dict: saved and loaded back it
    is the same module, and ``load_lifter_pt`` tells it from an MLP lifter
    by its qkv key."""
    port = _port(_jax_attention(3))
    save_lifter_pt(port, tmp_path / "a.pt")
    sd = torch.load(tmp_path / "a.pt", weights_only=True)
    assert "qkv.weight" in sd and not any(".bn" in k for k in sd)
    back = load_lifter_pt(tmp_path / "a.pt")
    assert isinstance(back, AttentionLifter)
    for k, v in port.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    x = torch.from_numpy(rng.normal(size=(5, 22)).astype(np.float32))
    with torch.no_grad():
        for a, b in zip(port(x), back(x)):
            assert torch.equal(a, b)
    save_lifter_pt(Lifter(11, HID), tmp_path / "m.pt")
    assert type(load_lifter_pt(tmp_path / "m.pt")) is Lifter


def _jax_grad(tree, side: int, name: str) -> np.ndarray:
    """A JAX attention-pair gradient in the port's layout, for the port's
    parameter ``name``."""
    *path, leaf = name.split(".")
    if path == ["qkv"]:
        g = np.asarray(tree["qkv"]["w" if leaf == "weight" else "b"][side])
        if leaf == "weight":
            d, _, nh, dh = g.shape
            g = g.reshape(d, 3 * d).T.reshape(3, nh, dh, d)
        return g
    if leaf == "pos":
        return np.asarray(tree["pos"][side])
    for p in path:
        tree = tree[p]
    g = np.asarray(tree["w" if leaf == "weight" else "b"][side])
    return g.T if leaf == "weight" else g


@pytest.mark.parametrize("policy", ["F32", "BF16"])
def test_left_right_loss_and_gradients(models, monkeypatch, policy):  # noqa: F811
    """The 3a objective of an attention pair: every loss term and the
    gradient of every parameter (qkv and pos included) against JAX's, with
    the same draws."""
    trees = [_jax_attention(10), _jax_attention(11)]  # before the draws are pinned
    poses = _poses(16, seed=5)
    draws = _draws(np.random.default_rng(2), 16)
    _pin_jax_draws(monkeypatch, {"draws": draws})
    jstacked = jax.tree.map(lambda a, b: jnp.stack([a, b]), *trees)
    _, frozen = _port_side(models)
    _, fl = models
    jfrozen = jlifter_obj.LifterFrozen(*fl)
    stacked = StackedLifter(*(_port(t) for t in trees))
    jpol, tpol = getattr(jnn, policy), getattr(tnn, policy)
    cfg_j, cfg_t = JLifterTrainConfig(nll_cap=500.0), LifterTrainConfig(nll_cap=500.0)

    inp_j = jlifter_obj.augment_with_samples(jfrozen.full_flow, jnp.asarray(poses), None,
                                             cfg_j.noise_factor, jpol)
    (_, jaux), jgrads = jax.value_and_grad(jlifter_obj.left_right_loss, has_aux=True)(
        jstacked, jfrozen, inp_j, None, cfg_j, jpol)
    inp_t = tlifter_obj.augment_with_samples(frozen.full_flow, torch.from_numpy(poses),
                                             draws.eps_noise, cfg_t.noise_factor, tpol)
    loss, aux = tlifter_obj.left_right_loss(stacked, frozen, inp_t, draws.u_azim,
                                            draws.eps_elev, cfg_t, tpol)
    loss.backward()
    for k, v in jaux.items():
        np.testing.assert_allclose(float(aux[k].detach()), float(v), err_msg=k, **TOL[policy])
    names = [n for n, _ in stacked.left.named_parameters()]
    assert {"qkv.weight", "qkv.bias", "pos"} <= set(names)
    for side, lifter in enumerate((stacked.left, stacked.right)):
        for name, p in lifter.named_parameters():
            want = _jax_grad(jgrads, side, name)
            err = np.linalg.norm(p.grad.numpy() - want) / max(np.linalg.norm(want), 1e-12)
            assert err < GRAD_REL[policy], (side, name, err)


def test_one_3a_step_makes_20_forward_and_16_backward_block_calls(  # noqa: F811
        models, monkeypatch):
    """One 3a step of an attention pair: 5 blocks x 2 sides x (lift + re-lift)
    forward calls of the residual block, and a backward for all but the
    re-lift's 2 angle blocks per side (no loss reads the re-lift's angles)."""
    calls = {"forward": 0, "backward": 0}

    def counted(fn, which):
        def wrapped(*a, **k):
            calls[which] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tresblock, "res_block_forward_reference",
                        counted(tresblock.res_block_forward_reference, "forward"))
    monkeypatch.setattr(tresblock, "res_block_backward_reference",
                        counted(tresblock.res_block_backward_reference, "backward"))
    _, frozen = _port_side(models)
    stacked = StackedLifter(_port(_jax_attention(12)), _port(_jax_attention(13)))
    grads = build_left_right_grads(frozen, LifterTrainConfig(nll_cap=500.0))
    aux, g = grads(stacked, torch.from_numpy(_poses(16, seed=6)),
                   _draws(np.random.default_rng(3), 16))
    assert calls == {"forward": 20, "backward": 16}
    assert len(g) == len(list(stacked.parameters())) and np.isfinite(float(aux["loss"]))


def test_attention_trainer_files_serve(run, scratch):  # noqa: F811
    """3a --attention for one epoch writes attention-layout files (final and
    best), which lift, lift --scenario (with legs/torso lifters and
    completers beside them) and eval_h36m read; lift --fused refuses them."""
    for name in ("full_flow", "flow_left", "flow_right"):
        (scratch / f"{name}.pt").write_bytes((run / f"{name}.pt").read_bytes())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = ttrain.main(_args(run, "--attention") + ["--model-dir", str(scratch)])
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    assert state.step == 2 and np.isfinite(summary["last"]["pa_left"])
    assert isinstance(state.model.left, AttentionLifter)
    for f in ("left_side_lifter_final.pt", "right_side_lifter_best.pt"):
        assert isinstance(load_lifter_pt(scratch / f), AttentionLifter), f
    data = ["--data", str(run / "synthetic.pkl"), "--model-dir", str(scratch), "--device", "cpu"]
    pred = tlift.main(data + ["--use-final", "--out", str(scratch / "o.npz")])
    final = StackedLifter(*(load_lifter_pt(scratch / f"{s}_side_lifter_final.pt")
                            for s in ("left", "right")))
    with np.load(scratch / "o.npz") as z, torch.no_grad():
        want = tlifter_obj.lift_left_right_eval(final, torch.from_numpy(z["poses_2d"]))
    np.testing.assert_array_equal(pred.reshape(-1, 51), want.numpy())
    g = torch.Generator().manual_seed(0)
    save_lifter_pt(Lifter(LEG_JOINTS, 64, generator=g), scratch / "leg_lifter.pt")
    save_lifter_pt(Lifter(TORSO_JOINTS, 64, generator=g), scratch / "torso_lifter.pt")
    (scratch / "occlusion_model_weights").mkdir()
    for name, spec in COMPLETER_SPECS.items():
        save_completer_pt(Completer(*spec, 64, generator=g),
                          scratch / "occlusion_model_weights" / f"{name}_estimator.pt")
    occ = tlift.main(data + ["--scenario", "ll", "--out", str(scratch / "s.npz")])
    assert occ.shape == pred.shape and np.isfinite(occ).all()
    with contextlib.redirect_stdout(io.StringIO()):
        results = teval.main(data + ["--json"])
    assert np.isfinite(results["pa_mpjpe"])
    with pytest.raises(ValueError, match="attention lifters"):
        tlift.main(data + ["--fused", "--out", str(scratch / "f.npz")])
