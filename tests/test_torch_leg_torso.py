"""The stage-3b slice of links_tpu_torch against links_tpu on the CPU: the
leg/torso loss with the gradients of both lifters under every bone-mean
choice, three whole steps, the PCK and AUC metrics of its validation, and the
bone means taken from data. Both packages get the same weights and draws, as
in tests/test_torch_train_step.py."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_suite import one_cpu_thread  # noqa: F401  (an autouse fixture)
from links_tpu import flows as jflows
from links_tpu import metrics as jmetrics
from links_tpu import models as jmodels
from links_tpu.cli import _common as jcommon
from links_tpu.config import LifterTrainConfig as JLifterTrainConfig
from links_tpu.config import OptimConfig as JOptimConfig
from links_tpu.core import nn as jnn
from links_tpu.core.skeleton import BONE_RELATIONS_MEAN_H36M
from links_tpu.objectives import lifter as jlifter_obj
from links_tpu.train import build_leg_torso_step as j_build_step
from links_tpu.train import make_optimizer
from links_tpu.train.steps import init_state
from links_tpu_torch import metrics as tmetrics
from links_tpu_torch.ckpt.torch_io import (
    flow_from_state_dict,
    flow_params_from_jax,
    lifter_from_state_dict,
    lifter_params_from_jax,
)
from links_tpu_torch.cli import _common as tcommon
from links_tpu_torch.config import LifterTrainConfig, OptimConfig
from links_tpu_torch.core import nn as tnn
from links_tpu_torch.data.synthetic import generate_poses
from links_tpu_torch.models.lifters import CHAIN, LegTorsoLifter, Lifter
from links_tpu_torch.objectives import lifter as tlifter_obj
from links_tpu_torch.train.optim import Adam
from links_tpu_torch.train.steps import TrainState, build_leg_torso_step
from test_torch_train_step import (
    AFTER_STEPS_TOL,
    BF16_TOL,
    F32_TOL,
    _draws,
    _pin_jax_draws,
    _port_param_names,
    _poses,
)

HID = 128
FLOW_HID = 64
BATCH = 16
AUX_KEYS = ("likeli", "leg_likeli", "torso_likeli", "L3d", "rep_rot", "re_rot_3d",
            "bl_prior", "loss")
# relative L2 error bound of a parameter's gradient, as for 3a (observed:
# 3.4e-6 at f32, 1.1e-3 at bf16, where the rounded products flip bf16
# roundings)
GRAD_REL = {"F32": 1e-5, "BF16": 3e-3}


def _bone_means_3d():
    """(N, 51) synthetic 3D poses in the (3, 17) flat layout."""
    p3 = generate_poses(64, seed=21)["poses_3d"].astype(np.float32)
    return p3.transpose(0, 2, 1).reshape(-1, 51)


def _bone_means(choice):
    """-> (JAX argument, port argument) for a ``--bone-means`` choice: the
    MPI means are both objectives' default."""
    if choice == "mpi_vnect_interesting":
        return None, None
    if choice == "h36m":
        return jnp.asarray(BONE_RELATIONS_MEAN_H36M, jnp.float32), \
            torch.as_tensor(BONE_RELATIONS_MEAN_H36M, dtype=torch.float32)
    means = tcommon.bone_means_from_data(SimpleNamespace(poses_3d=torch.from_numpy(
        _bone_means_3d())))
    return jnp.asarray(means.numpy()), means


@pytest.fixture(scope="module")
def models():
    """JAX lifters (legs, torso) and flows (full, legs, torso), as numpy."""
    keys = jax.random.split(jax.random.PRNGKey(6), 5)
    lifters = [jax.tree.map(np.asarray, jmodels.init_lifter(k, j, hidden=HID))
               for k, j in zip(keys[:2], (jmodels.LEG_JOINTS, jmodels.TORSO_JOINTS))]
    fl = [jflows.init_flow(k, d, n_blocks=3, hidden=FLOW_HID)
          for k, d in zip(keys[2:], (34, 14, 20))]
    fl = [jflows.Flow(jax.tree.map(np.asarray, f.params), np.asarray(f.perm)) for f in fl]
    return lifters, fl


def _port_side(models):
    lifters, fl = models
    model = LegTorsoLifter(*(lifter_from_state_dict(lifter_params_from_jax(t))
                             for t in lifters))
    frozen = tlifter_obj.LifterFrozen(*(
        flow_from_state_dict(flow_params_from_jax(f.params, f.perm)).requires_grad_(False)
        for f in fl))
    return model, frozen


def _leaf(tree, name, leaf):
    """A JAX lifter leaf in the port's layout."""
    blk, lin = (name.split(".") + [None])[:2]
    g = np.asarray((tree[blk][lin] if lin else tree[blk])[leaf])
    return g.T if leaf == "w" else g


def _port_leaves(model):
    for part in ("legs", "torso"):
        lifter = getattr(model, part)
        for name in _port_param_names():
            mod = lifter.get_submodule(name)
            for leaf, p in (("w", mod.weight), ("b", mod.bias)):
                yield part, name, leaf, p


@pytest.mark.parametrize("bone_means", ["h36m", "mpi_vnect_interesting", "data"])
@pytest.mark.parametrize("policy,tol", [("F32", F32_TOL), ("BF16", BF16_TOL)])
def test_leg_torso_loss_and_gradients(models, monkeypatch, policy, tol, bone_means):
    rng = np.random.default_rng(22)
    poses = _poses(BATCH, seed=23)
    draws = _draws(rng, BATCH)
    _pin_jax_draws(monkeypatch, {"draws": draws})
    cfg_j, cfg_t = JLifterTrainConfig(nll_cap=500.0), LifterTrainConfig(nll_cap=500.0)
    jmeans, tmeans = _bone_means(bone_means)
    lifters, fl = models
    jfrozen = jlifter_obj.LifterFrozen(*fl)
    model, frozen = _port_side(models)
    jpol, tpol = getattr(jnn, policy), getattr(tnn, policy)

    inp_j = jlifter_obj.augment_with_samples(jfrozen.full_flow, jnp.asarray(poses), None,
                                             cfg_j.noise_factor, jpol)
    (_, jaux), jgrads = jax.value_and_grad(
        lambda p: jlifter_obj.leg_torso_loss(p["legs"], p["torso"], jfrozen, inp_j, None, cfg_j,
                                             jpol, jmeans), has_aux=True)(
        {"legs": lifters[0], "torso": lifters[1]})
    inp_t = tlifter_obj.augment_with_samples(frozen.full_flow, torch.from_numpy(poses),
                                             draws.eps_noise, cfg_t.noise_factor, tpol)
    loss, aux = tlifter_obj.leg_torso_loss(model.legs, model.torso, frozen, inp_t, draws.u_azim,
                                           draws.eps_elev, cfg_t, tpol, tmeans)
    loss.backward()
    assert set(aux) == set(jaux) == set(AUX_KEYS)
    for k in AUX_KEYS:
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]), err_msg=k, **tol)
    for part, name, leaf, p in _port_leaves(model):
        want = _leaf(jgrads[part], name, leaf)
        err = np.linalg.norm(p.grad.numpy() - want) / max(np.linalg.norm(want), 1e-12)
        assert err < GRAD_REL[policy], (part, name, leaf, err)
    assert all(p.grad is None for f in frozen for p in f.parameters())


@pytest.mark.parametrize("policy", ["F32", "BF16"])
def test_three_leg_torso_steps_match_the_jax_step(models, monkeypatch, policy):
    """Three whole steps (augmentation, loss, gradient, bf16-moment Adam, two
    steps per epoch) on the same batches and draws, with the H36M means as
    the trainer's default passes them. Parameters after the steps are held
    as in tests/test_torch_train_step.py's three-step test."""
    rng = np.random.default_rng(24)
    data = _poses(3 * BATCH, seed=25)
    holder = {}
    _pin_jax_draws(monkeypatch, holder)
    kw = {"nll_cap": 500.0, "bf16": policy == "BF16", "batch_size": BATCH}
    cfg_j = JLifterTrainConfig(**kw, optim=JOptimConfig(bf16_moments=True))
    cfg_t = LifterTrainConfig(**kw, optim=OptimConfig(bf16_moments=True))
    jmeans, tmeans = _bone_means("h36m")
    lifters, fl = models
    model, frozen = _port_side(models)
    opt = make_optimizer(cfg_j.optim, steps_per_epoch=2)
    jstep = j_build_step(jlifter_obj.LifterFrozen(*fl), opt, cfg_j, jmeans)
    jstate = init_state({"legs": lifters[0], "torso": lifters[1]}, opt)
    state = TrainState(model, Adam(model.parameters(), cfg_t.optim, steps_per_epoch=2))
    step = build_leg_torso_step(frozen, cfg_t, tmeans)
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
    diffs = np.concatenate([np.abs(p.detach().numpy()
                                   - _leaf(jstate.params[part], name, leaf)).ravel()
                            for part, name, leaf, p in _port_leaves(model)])
    assert diffs.max() <= 3 * 2 * lr
    assert (diffs > 1e-6).mean() < (0.001 if policy == "F32" else 0.05)


def test_leg_torso_lifter_parameter_order():
    model = LegTorsoLifter(Lifter(7, 128), Lifter(10, 128))
    want = list(model.legs.parameters()) + list(model.torso.parameters())
    got = list(model.parameters())
    assert len(got) == len(want) == 2 * (3 + 2 * len(CHAIN)) * 2
    assert all(a is b for a, b in zip(got, want))


def _pair(rng, n):
    """Reference poses in mm and noisy predictions of them, close enough that
    PCK and AUC fall between their ends."""
    ref = rng.normal(size=(n, 51)).astype(np.float32) * 300.0
    pred = ref * 0.02 + rng.normal(size=ref.shape).astype(np.float32) * 2.0
    return ref, pred


@pytest.mark.parametrize("use_scaling", [True, False])
def test_pck_and_auc(rng, use_scaling):
    ref, pred = _pair(rng, 40)
    if not use_scaling:
        pred = pred * 50.0
    tr, tp = torch.from_numpy(ref), torch.from_numpy(pred)
    jr, jp = jnp.asarray(ref), jnp.asarray(pred)
    pck = float(tmetrics.pck(tr, tp, use_scaling))
    auc = float(tmetrics.auc(tr, tp, use_scaling))
    assert 5.0 < pck < 95.0 and 0.05 < auc < 0.95
    np.testing.assert_allclose(pck, float(jmetrics.pck(jr, jp, use_scaling)), rtol=1e-6)
    np.testing.assert_allclose(auc, float(jmetrics.auc(jr, jp, use_scaling)), rtol=1e-6)
    np.testing.assert_allclose(float(tmetrics.pck(tr, tp, use_scaling, thresh=50.0)),
                               float(jmetrics.pck(jr, jp, use_scaling, thresh=50.0)), rtol=1e-6)


def test_bone_means_from_data_matches_the_jax_package():
    p3 = _bone_means_3d()
    got = tcommon.bone_means_from_data(SimpleNamespace(poses_3d=torch.from_numpy(p3)))
    want = jcommon.bone_means_from_data(SimpleNamespace(poses_3d=jnp.asarray(p3)))
    assert got.shape == (16,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
