"""The flow-training slice of links_tpu_torch (stages 1 and 2) against
links_tpu on the CPU: both losses with their gradients, and three whole steps
of each stage. Both packages get the same weights (``flow_params_from_jax``)
and the same latent noise: the port takes it as a tensor, and the JAX side
is pinned by monkeypatching its noise draw, as tests/test_torch_train_step.py
does. Flows at hidden 32-64 with 3 blocks keep the tests fast."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_suite import one_cpu_thread  # noqa: F401  (an autouse fixture)
from links_tpu import flows as jflows
from links_tpu.config import FlowTrainConfig as JFlowTrainConfig
from links_tpu.config import PartFlowTrainConfig as JPartFlowTrainConfig
from links_tpu.core import geometry as jgeo
from links_tpu.core import nn as jnn
from links_tpu.objectives import flow_nll as jflow_nll
from links_tpu.train import build_full_flow_step as j_build_full_step
from links_tpu.train import build_part_flows_step as j_build_part_step
from links_tpu.train import make_optimizer
from links_tpu.train.steps import init_state
from links_tpu_torch import flows as tflows
from links_tpu_torch.ckpt.torch_io import flow_from_state_dict, flow_params_from_jax
from links_tpu_torch.config import FlowTrainConfig, PartFlowTrainConfig
from links_tpu_torch.core import geometry as tgeo
from links_tpu_torch.core import nn as tnn
from links_tpu_torch.core.skeleton import split_data_left_right
from links_tpu_torch.data.synthetic import generate_poses
from links_tpu_torch.objectives import flow_nll
from links_tpu_torch.train.optim import Adam
from links_tpu_torch.train.steps import (
    TrainState,
    build_full_flow_step,
    build_part_flows_step,
    draw_noise,
)

FULL_HID, PART_HID, BLOCKS = 64, 32, 3
BATCH = 16
PART_DIMS = {"left": 22, "right": 22, "legs": 14, "torso": 20}
FULL_KEYS = ("dist_2d", "dist_2d_sample", "loss")
PART_KEYS = tuple(f"dist_2d_{p}{s}" for s in ("", "_sample") for p in flow_nll.PARTS) + ("loss",)
# the loss terms: f32 sums in another order; under bf16 a subnet product summed
# in another order can flip one bf16 rounding of a hidden activation, as for
# the flows themselves (tests/test_torch_flows.py:BF16_TOL)
F32_TOL = {"rtol": 1e-4, "atol": 1e-5}
BF16_TOL = {"rtol": 1e-4, "atol": 1e-4}
# relative L2 error bound of a parameter's gradient (observed: 7.4e-7 at f32,
# 6.8e-7 at bf16; a flipped bf16 rounding of a hidden activation would move
# the bf16 gradients further, as in tests/test_torch_train_step.py)
GRAD_REL = {"F32": 1e-5, "BF16": 1e-3}
# the loss terms after Adam steps that differ on near-zero gradient coordinates
AFTER_STEPS_TOL = {"rtol": 2e-3, "atol": 1e-3}


def _poses(n, seed):
    p = generate_poses(n, seed=seed)["poses_2d"].astype(np.float32)
    return tgeo.normalize_head(torch.from_numpy(p.transpose(0, 2, 1).reshape(n, 34))).numpy()


def _np_flow(flow):
    return jflows.Flow(jax.tree.map(np.asarray, flow.params), np.asarray(flow.perm))


@pytest.fixture(scope="module")
def jax_flows():
    """The JAX full flow and the four part flows, as numpy."""
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    full = _np_flow(jflows.init_flow(keys[0], 34, n_blocks=BLOCKS, hidden=FULL_HID))
    parts = {name: _np_flow(jflows.init_flow(k, d, n_blocks=BLOCKS, hidden=PART_HID))
             for k, (name, d) in zip(keys[1:], PART_DIMS.items())}
    return full, parts


def _port(flow):
    return flow_from_state_dict(flow_params_from_jax(flow.params, flow.perm))


def _port_parts(parts):
    return flow_nll.PartFlows(*(_port(parts[name]) for name in flow_nll.PARTS))


def _pin_jax_noise(monkeypatch, holder):
    """Make the JAX package's latent-noise draw return ``holder['eps']``."""
    monkeypatch.setattr(jgeo.jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(holder["eps"]))


def _assert_grads_close(port_flow, jgrad_params, perm, rel):
    """Each gradient of ``port_flow`` against the JAX gradient pytree in the
    port's layout (``flow_params_from_jax`` maps gradients as it maps
    weights)."""
    want = flow_params_from_jax(jax.tree.map(np.asarray, jgrad_params), perm)
    for name, p in port_flow.named_parameters():
        w = want[name].numpy().reshape(p.shape)
        err = np.linalg.norm(p.grad.numpy() - w) / max(np.linalg.norm(w), 1e-12)
        assert err < rel, (name, err)


def _cap(nlls):
    """A cap that some per-sample NLLs pass and others do not."""
    cap = float(np.quantile(nlls, 0.5))
    assert cap != 0.0 and (nlls > cap).any() and (nlls < cap).any()
    return cap


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("policy,tol", [("F32", F32_TOL), ("BF16", BF16_TOL)])
def test_full_flow_loss_and_gradients(jax_flows, monkeypatch, policy, tol, capped):
    full, _ = jax_flows
    rng = np.random.default_rng(11)
    poses = _poses(BATCH, seed=12)
    eps = rng.normal(size=(BATCH, 34)).astype(np.float32)
    _pin_jax_noise(monkeypatch, {"eps": eps})
    jpol, tpol = getattr(jnn, policy), getattr(tnn, policy)
    port = _port(full)
    cap = 0.0
    if capped:
        with torch.no_grad():
            cap = _cap(tflows.nll(*tflows.forward(port, torch.from_numpy(poses), tpol)).numpy())

    (_, jaux), jgrads = jax.value_and_grad(jflow_nll.full_flow_loss, has_aux=True)(
        full.params, full.perm, jnp.asarray(poses), None, 0.2, jpol, cap)
    loss, aux = flow_nll.full_flow_loss(port, torch.from_numpy(poses), torch.from_numpy(eps),
                                        0.2, tpol, cap)
    loss.backward()
    assert set(aux) == set(jaux) == set(FULL_KEYS)
    for k in FULL_KEYS:
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]), err_msg=k, **tol)
    _assert_grads_close(port, jgrads, full.perm, GRAD_REL[policy])


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("policy,tol", [("F32", F32_TOL), ("BF16", BF16_TOL)])
def test_part_flows_loss_and_gradients(jax_flows, monkeypatch, policy, tol, capped):
    full, parts = jax_flows
    rng = np.random.default_rng(13)
    poses = _poses(BATCH, seed=14)
    eps = rng.normal(size=(BATCH, 34)).astype(np.float32)
    _pin_jax_noise(monkeypatch, {"eps": eps})
    jpol, tpol = getattr(jnn, policy), getattr(tnn, policy)
    port_full = _port(full).requires_grad_(False)
    port_parts = _port_parts(parts)
    cap = 0.0
    if capped:
        with torch.no_grad():
            left, _ = split_data_left_right(torch.from_numpy(poses))
            cap = _cap(tflows.nll(*tflows.forward(port_parts.left, left, tpol)).numpy())

    jparams = {n: f.params for n, f in parts.items()}
    jperms = {n: f.perm for n, f in parts.items()}
    (_, jaux), jgrads = jax.value_and_grad(jflow_nll.part_flows_loss, has_aux=True)(
        jparams, jperms, full, jnp.asarray(poses), None, 0.2, jpol, cap)
    loss, aux = flow_nll.part_flows_loss(port_parts, port_full, torch.from_numpy(poses),
                                         torch.from_numpy(eps), 0.2, tpol, cap)
    loss.backward()
    assert set(aux) == set(jaux) == set(PART_KEYS)
    for k in PART_KEYS:
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]), err_msg=k, **tol)
    for name in flow_nll.PARTS:
        _assert_grads_close(getattr(port_parts, name), jgrads[name], parts[name].perm,
                            GRAD_REL[policy])
    assert all(p.grad is None for p in port_full.parameters())


def _assert_params_after_steps(port_flow, jparams, perm, lr, steps, policy):
    """Adam divides each gradient coordinate by its own running magnitude, so
    on a coordinate whose gradient is near zero a last-bit difference between
    the packages can move the update by up to 2 lr per step; nearly every
    other coordinate agrees closely."""
    want = flow_params_from_jax(jax.tree.map(np.asarray, jparams), perm)
    diffs = np.concatenate([np.abs(p.detach().numpy() - want[n].numpy().reshape(p.shape)).ravel()
                            for n, p in port_flow.named_parameters()])
    assert diffs.max() <= steps * 2 * lr
    assert (diffs > 1e-6).mean() < (0.001 if policy == "F32" else 0.05)


@pytest.mark.parametrize("policy", ["F32", "BF16"])
def test_three_full_flow_steps_match_the_jax_step(jax_flows, monkeypatch, policy):
    """Three whole stage-1 steps (loss, gradient, f32-moment Adam, two steps
    per epoch so the third runs at the decayed rate) on the same batches and
    noise."""
    full, _ = jax_flows
    rng = np.random.default_rng(15)
    data = _poses(3 * BATCH, seed=16)
    holder = {}
    _pin_jax_noise(monkeypatch, holder)
    kw = {"bf16": policy == "BF16", "batch_size": BATCH}
    cfg_j, cfg_t = JFlowTrainConfig(**kw), FlowTrainConfig(**kw)
    opt = make_optimizer(cfg_j.optim, steps_per_epoch=2)
    jstep = j_build_full_step(full.perm, opt, cfg_j)
    jstate = init_state(full.params, opt)
    port = _port(full)
    state = TrainState(port, Adam(port.parameters(), cfg_t.optim, steps_per_epoch=2))
    step = build_full_flow_step(cfg_t)
    for i in range(3):
        batch = data[i * BATCH:(i + 1) * BATCH]
        holder["eps"] = eps = rng.normal(size=(BATCH, 34)).astype(np.float32)
        jstate, jaux = jstep(jstate, jnp.asarray(batch), jax.random.PRNGKey(i))
        aux = step(state, torch.from_numpy(batch), torch.from_numpy(eps))
        tol = (F32_TOL if policy == "F32" else BF16_TOL) if i == 0 else AFTER_STEPS_TOL
        for k in FULL_KEYS:
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]), err_msg=f"{i} {k}", **tol)
    assert state.step == 3 and state.opt.count == 3
    assert state.opt.mu[0].dtype == torch.float32
    _assert_params_after_steps(port, jstate.params, full.perm, cfg_t.optim.learning_rate, 3,
                               policy)


@pytest.mark.parametrize("policy", ["F32", "BF16"])
def test_three_part_flow_steps_match_the_jax_step(jax_flows, monkeypatch, policy):
    full, parts = jax_flows
    rng = np.random.default_rng(17)
    data = _poses(3 * BATCH, seed=18)
    holder = {}
    _pin_jax_noise(monkeypatch, holder)
    kw = {"bf16": policy == "BF16", "batch_size": BATCH}
    cfg_j, cfg_t = JPartFlowTrainConfig(**kw), PartFlowTrainConfig(**kw)
    opt = make_optimizer(cfg_j.optim, steps_per_epoch=2)
    jperms = {n: f.perm for n, f in parts.items()}
    jstep = j_build_part_step(jperms, full, opt, cfg_j)
    jstate = init_state({n: f.params for n, f in parts.items()}, opt)
    port_parts = _port_parts(parts)
    state = TrainState(port_parts, Adam(port_parts.parameters(), cfg_t.optim, steps_per_epoch=2))
    step = build_part_flows_step(_port(full).requires_grad_(False), cfg_t)
    for i in range(3):
        batch = data[i * BATCH:(i + 1) * BATCH]
        holder["eps"] = eps = rng.normal(size=(BATCH, 34)).astype(np.float32)
        jstate, jaux = jstep(jstate, jnp.asarray(batch), jax.random.PRNGKey(i))
        aux = step(state, torch.from_numpy(batch), torch.from_numpy(eps))
        tol = (F32_TOL if policy == "F32" else BF16_TOL) if i == 0 else AFTER_STEPS_TOL
        for k in PART_KEYS:
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]), err_msg=f"{i} {k}", **tol)
    assert state.step == 3 and state.opt.count == 3
    for name in flow_nll.PARTS:
        _assert_params_after_steps(getattr(port_parts, name), jstate.params[name],
                                   parts[name].perm, cfg_t.optim.learning_rate, 3, policy)


def test_part_flows_parameter_order_is_left_right_legs_torso():
    g = torch.Generator().manual_seed(0)
    flows_ = [tflows.Flow(d, 1, 8, generator=g) for d in PART_DIMS.values()]
    parts = flow_nll.PartFlows(*flows_)
    want = [p for f in flows_ for p in f.parameters()]
    assert all(a is b for a, b in zip(parts.parameters(), want))
    assert len(list(parts.parameters())) == len(want)


def test_draw_noise_is_one_normal_of_the_pose_width():
    g = torch.Generator().manual_seed(5)
    eps = draw_noise(g, 7, "cpu")
    assert eps.shape == (7, 34)
    torch.testing.assert_close(eps, torch.randn(7, 34, generator=torch.Generator().manual_seed(5)))

