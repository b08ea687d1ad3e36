"""The stage-3a training slice of links_tpu_torch against links_tpu on the CPU:
the five-loss objective with the gradients of both lifters, the optimizer
alone, whole steps, and the epoch loop. Both packages get the same weights
(``lifter_params_from_jax``, ``flow_params_from_jax``) and the same random
draws: the port takes them as tensors, and the JAX side is pinned by
monkeypatching its noise draw and its rotation sampler, as
tests/test_reference_parity.py does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_suite import one_cpu_thread  # noqa: F401  (an autouse fixture)
from links_tpu import flows as jflows
from links_tpu import models as jmodels
from links_tpu.config import FlowTrainConfig as JFlowTrainConfig
from links_tpu.config import LifterTrainConfig as JLifterTrainConfig
from links_tpu.config import OptimConfig as JOptimConfig
from links_tpu.config import PartFlowTrainConfig as JPartFlowTrainConfig
from links_tpu.core import geometry as jgeo
from links_tpu.core import nn as jnn
from links_tpu.objectives import lifter as jlifter_obj
from links_tpu.train import build_left_right_step as j_build_step
from links_tpu.train import make_optimizer
from links_tpu.train.steps import init_state
from links_tpu_torch.ckpt.torch_io import (
    flow_from_state_dict,
    flow_params_from_jax,
    lifter_from_state_dict,
    lifter_params_from_jax,
)
from links_tpu_torch.config import (
    FlowTrainConfig,
    LifterTrainConfig,
    OptimConfig,
    PartFlowTrainConfig,
)
from links_tpu_torch.core import geometry as tgeo
from links_tpu_torch.core import nn as tnn
from links_tpu_torch.data.synthetic import generate_poses
from links_tpu_torch.models.lifters import CHAIN, StackedLifter
from links_tpu_torch.objectives import lifter as tlifter_obj
from links_tpu_torch.train.loop import run_epoch
from links_tpu_torch.train.optim import Adam
from links_tpu_torch.train.steps import StepDraws, TrainState, build_left_right_step

HID = 64
BATCH = 16
AUX_KEYS = ("likeli", "likeli_left", "likeli_right", "L3d", "rep_rot", "re_rot_3d",
            "bl_prior", "loss")
F32_TOL = {"rtol": 1e-4, "atol": 1e-5}
# bf16: both packages sum bf16 x bf16 products in f32 in different orders, so
# a hidden activation can round to the neighbouring bf16 value in one of them;
# 14 residual blocks and two lifts per loss carry such flips to the outputs
# (observed: 2.4e-7 relative on the loss terms, 8.5e-4 relative L2 on a
# gradient, which the rounded gradient products flip directly).
BF16_TOL = {"rtol": 1e-4, "atol": 1e-5}
# relative L2 error bound of a parameter's gradient (observed 9.4e-7 at f32)
GRAD_REL = {"F32": 1e-5, "BF16": 3e-3}
# the loss terms after Adam steps that differ on near-zero gradient coordinates
AFTER_STEPS_TOL = {"rtol": 2e-3, "atol": 1e-4}


def _poses(n, seed):
    p = generate_poses(n, seed=seed)["poses_2d"].astype(np.float32)
    return tgeo.normalize_head(torch.from_numpy(p.transpose(0, 2, 1).reshape(n, 34))).numpy()


def _draws(rng, b):
    return StepDraws(torch.from_numpy(rng.normal(size=(b, 34)).astype(np.float32)),
                     torch.from_numpy(rng.uniform(size=(2 * b, 1)).astype(np.float32)),
                     torch.from_numpy(rng.normal(size=(2 * b, 1)).astype(np.float32)))


@pytest.fixture(scope="module")
def models():
    """JAX lifters (left, right) and flows (full, left, right), as numpy."""
    keys = jax.random.split(jax.random.PRNGKey(0), 5)
    lifters = [jax.tree.map(np.asarray, jmodels.init_lifter(k, 11, hidden=HID))
               for k in keys[:2]]
    fl = [jflows.init_flow(k, d, n_blocks=4, hidden=HID) for k, d in zip(keys[2:], (34, 22, 22))]
    fl = [jflows.Flow(jax.tree.map(np.asarray, f.params), np.asarray(f.perm)) for f in fl]
    return lifters, fl


def _jax_side(models):
    lifters, fl = models
    stacked = jax.tree.map(lambda a, b: jnp.stack([a, b]), *lifters)
    return stacked, jlifter_obj.LifterFrozen(*fl)


def _port_side(models):
    lifters, fl = models
    stacked = StackedLifter(*(lifter_from_state_dict(lifter_params_from_jax(t)) for t in lifters))
    frozen = tlifter_obj.LifterFrozen(*(
        flow_from_state_dict(flow_params_from_jax(f.params, f.perm)).requires_grad_(False)
        for f in fl))
    return stacked, frozen


def _pin_jax_draws(monkeypatch, holder):
    """Make the JAX package's latent-noise draw and rotation sampler return
    the draws in ``holder['draws']``."""
    def normal(key, shape, dtype=jnp.float32):
        return jnp.asarray(holder["draws"].eps_noise.numpy())

    def rotation(key, props, use_elevation=True, axis_name=None):
        d = holder["draws"]
        r_comp = jgeo.rotation_about_x(props)
        x_ang = -props.mean() + props.std(ddof=1) * jnp.asarray(d.eps_elev.numpy())
        y_ang = (jnp.asarray(d.u_azim.numpy()) - 0.5) * 1.99 * jgeo.PI
        return jnp.matmul(jgeo.rotation_about_x(x_ang),
                          jnp.matmul(jgeo.rotation_about_y(y_ang), r_comp, precision="highest"),
                          precision="highest")

    monkeypatch.setattr(jgeo.jax.random, "normal", normal)
    monkeypatch.setattr(jlifter_obj, "sample_rotation", rotation)


def _grad_of(tree, side, name, leaf):
    """A JAX lifter gradient in the port's layout."""
    blk, lin = (name.split(".") + [None])[:2]
    g = tree[blk][lin] if lin else tree[blk]
    g = np.asarray(g[leaf][side])
    return g.T if leaf == "w" else g


def _port_param_names():
    names = ["upscale", "downscale", "angles"]
    return names + [f"{blk}.{lin}" for blk in CHAIN for lin in ("l1", "l2")]


def _assert_grads_close(stacked, jgrads, rel):
    for side, lifter in enumerate((stacked.left, stacked.right)):
        for name in _port_param_names():
            mod = lifter.get_submodule(name)
            for leaf, p in (("w", mod.weight), ("b", mod.bias)):
                want = _grad_of(jgrads, side, name, leaf)
                got = p.grad.numpy()
                err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)
                assert err < rel, (side, name, leaf, err)


@pytest.mark.parametrize("policy,tol", [("F32", F32_TOL), ("BF16", BF16_TOL)])
def test_left_right_loss_and_gradients(models, monkeypatch, policy, tol):
    rng = np.random.default_rng(1)
    poses = _poses(BATCH, seed=3)
    draws = _draws(rng, BATCH)
    holder = {"draws": draws}
    _pin_jax_draws(monkeypatch, holder)
    cfg_j = JLifterTrainConfig(nll_cap=500.0)
    cfg_t = LifterTrainConfig(nll_cap=500.0)
    jstacked, jfrozen = _jax_side(models)
    stacked, frozen = _port_side(models)
    jpol, tpol = getattr(jnn, policy), getattr(tnn, policy)

    inp_j = jlifter_obj.augment_with_samples(jfrozen.full_flow, jnp.asarray(poses), None,
                                             cfg_j.noise_factor, jpol)
    (jloss, jaux), jgrads = jax.value_and_grad(jlifter_obj.left_right_loss, has_aux=True)(
        jstacked, jfrozen, inp_j, None, cfg_j, jpol)

    inp_t = tlifter_obj.augment_with_samples(frozen.full_flow, torch.from_numpy(poses),
                                             draws.eps_noise, cfg_t.noise_factor, tpol)
    np.testing.assert_allclose(inp_t.numpy(), np.asarray(inp_j), **tol)
    loss, aux = tlifter_obj.left_right_loss(stacked, frozen, inp_t, draws.u_azim,
                                            draws.eps_elev, cfg_t, tpol)
    loss.backward()
    assert set(aux) == set(jaux) == set(AUX_KEYS)
    for k in AUX_KEYS:
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]), err_msg=k, **tol)
    _assert_grads_close(stacked, jgrads, GRAD_REL[policy])
    assert all(p.grad is None for p in frozen.full_flow.parameters())


def _opt_params(rng):
    return {"a": (rng.normal(size=(5, 3)) * 0.1).astype(np.float32),
            "b": (rng.normal(size=(4,)) * 0.1).astype(np.float32)}


@pytest.mark.parametrize("bf16_moments,tol", [(False, 1e-7), (True, 2e-6)])
@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_optimizer_matches_make_optimizer(bf16_moments, tol, clip):
    """Three updates on identical gradients; two steps per epoch, so the third
    update runs at the decayed learning rate. The second step's gradient is
    large enough to be clipped. With bf16 moments a last-bit difference of a
    moment can round it to the neighbouring bf16 value: up to 2**-8 of a
    step of at most lr."""
    rng = np.random.default_rng(2)
    params = _opt_params(rng)
    grads = [{k: (rng.normal(size=v.shape) * s).astype(np.float32) for k, v in params.items()}
             for s in (0.1, 10.0, 0.01)]
    jcfg = JOptimConfig(clip_grad_norm=clip, bf16_moments=bf16_moments)
    opt = make_optimizer(jcfg, steps_per_epoch=2)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = opt.init(jparams)
    tparams = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    topt = Adam(tparams, OptimConfig(clip_grad_norm=clip, bf16_moments=bf16_moments),
                steps_per_epoch=2)
    for g in grads:
        updates, jstate = opt.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        topt.step([torch.from_numpy(g[k]) for k in ("a", "b")])
        for k, t in zip(("a", "b"), tparams):
            np.testing.assert_allclose(t.numpy(), np.asarray(jparams[k]), rtol=0, atol=tol)
    assert topt.mu[0].dtype == (torch.bfloat16 if bf16_moments else torch.float32)
    assert topt.lr(2) == pytest.approx(2e-4 * 0.95, rel=1e-6)


@pytest.mark.parametrize("policy", ["F32", "BF16"])
def test_three_steps_match_the_jax_step(models, monkeypatch, policy):
    """Three whole steps (augmentation, loss, gradient, bf16-moment Adam) on
    the same batches and draws. Adam divides each gradient coordinate by its
    own running magnitude, so on a coordinate whose gradient is near zero a
    last-bit difference between the packages can change the update by up to
    2 lr per step; every other coordinate must agree closely (observed: at
    f32 4e-5 of the coordinates differ by more than 1e-6, at bf16 1.6%, the
    largest by 2.3e-4)."""
    rng = np.random.default_rng(4)
    data = _poses(3 * BATCH, seed=5)
    holder = {}
    _pin_jax_draws(monkeypatch, holder)
    kw = {"nll_cap": 500.0, "bf16": policy == "BF16", "batch_size": BATCH}
    cfg_j = JLifterTrainConfig(**kw, optim=JOptimConfig(bf16_moments=True))
    cfg_t = LifterTrainConfig(**kw, optim=OptimConfig(bf16_moments=True))
    jstacked, jfrozen = _jax_side(models)
    stacked, frozen = _port_side(models)
    opt = make_optimizer(cfg_j.optim, steps_per_epoch=2)
    jstep = j_build_step(jfrozen, opt, cfg_j)
    jstate = init_state(jstacked, opt)
    state = TrainState(stacked, Adam(stacked.parameters(), cfg_t.optim, steps_per_epoch=2))
    step = build_left_right_step(frozen, cfg_t)
    for i in range(3):
        batch = data[i * BATCH:(i + 1) * BATCH]
        holder["draws"] = draws = _draws(rng, BATCH)
        jstate, jaux = jstep(jstate, jnp.asarray(batch), jax.random.PRNGKey(i))
        aux = step(state, torch.from_numpy(batch), draws)
        tol = (F32_TOL if policy == "F32" else BF16_TOL) if i == 0 else AFTER_STEPS_TOL
        for k in AUX_KEYS:
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]), err_msg=f"{i} {k}", **tol)
    assert state.step == 3 and state.opt.count == 3
    lr = cfg_t.optim.learning_rate
    diffs = []
    for side, lifter in enumerate((stacked.left, stacked.right)):
        for name in _port_param_names():
            mod = lifter.get_submodule(name)
            for leaf, p in (("w", mod.weight), ("b", mod.bias)):
                diffs.append(np.abs(p.detach().numpy() - _grad_of(jstate.params, side, name,
                                                                  leaf)).ravel())
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 3 * 2 * lr
    assert (diffs > 1e-6).mean() < (0.001 if policy == "F32" else 0.05)


def test_epoch_loop_permutes_drops_the_remainder_and_averages():
    data = torch.arange(10, dtype=torch.float32)[:, None].repeat(1, 34)
    seen = []

    def fake_step(state, batch, draws):
        seen.append(batch[:, 0].tolist())
        assert draws.eps_noise.shape == (4, 34) and draws.u_azim.shape == (8, 1)
        state.step += 1
        return {"loss": batch[:, 0].mean(), "one": torch.tensor(1.0)}

    state = TrainState(model=None, opt=None)
    out = run_epoch(fake_step, state, data, 4, torch.Generator().manual_seed(0))
    rows = [r for b in seen for r in b]
    assert len(seen) == 2 and state.step == 2 and len(set(rows)) == 8
    assert out["one"] == 1.0
    assert out["loss"] == pytest.approx(np.mean(rows))
    again = []
    run_epoch(lambda s, b, d: again.append(b[:, 0].tolist()) or {"loss": b[:, 0].mean()},
              state, data, 4, torch.Generator().manual_seed(0))
    assert again == seen  # the generator alone decides the order


def test_config_defaults_match_the_jax_package():
    """The same defaults; the port's lifter config has no ``use_elevation``
    (always on)."""
    want = dataclasses.asdict(JLifterTrainConfig())
    assert want.pop("use_elevation") is True
    assert dataclasses.asdict(LifterTrainConfig()) == want
    assert dataclasses.asdict(OptimConfig()) == dataclasses.asdict(JOptimConfig())
    assert dataclasses.asdict(FlowTrainConfig()) == dataclasses.asdict(JFlowTrainConfig())
    assert dataclasses.asdict(PartFlowTrainConfig()) == dataclasses.asdict(JPartFlowTrainConfig())
