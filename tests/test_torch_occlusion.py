"""The stage-4 slice of links_tpu_torch against links_tpu on the CPU: the
skeleton pieces, the completers' inputs and targets, one completer, the
frozen lifters' pseudo-3D, the occlusion loss with the gradient of every
completer parameter, three whole steps with Adam, the scenario poses and
the keypoint dropout, and the completer ``.pt`` files both ways. Both
packages get the same weights (``completer_params_from_jax``,
``lifter_params_from_jax``) and the same draws: the port takes the
uniforms and normals that the JAX package draws from its key."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_suite import one_cpu_thread  # noqa: F401  (an autouse fixture)
from links_tpu import ckpt as jckpt
from links_tpu import models as jmodels
from links_tpu.config import OcclusionTrainConfig as JOcclusionTrainConfig
from links_tpu.core import nn as jnn
from links_tpu.core import skeleton as jskel
from links_tpu.objectives import occlusion as jocc
from links_tpu.train import build_occlusion_step as j_build_step
from links_tpu.train import make_optimizer
from links_tpu.train.steps import init_state
from links_tpu_torch.ckpt.torch_io import (
    completer_from_state_dict,
    completer_params_from_jax,
    lifter_from_state_dict,
    lifter_params_from_jax,
    load_completer_pt,
    save_completer_pt,
)
from links_tpu_torch.cli import _common as tcommon
from links_tpu_torch.config import OcclusionTrainConfig, OptimConfig
from links_tpu_torch.core import nn as tnn
from links_tpu_torch.core import skeleton as tskel
from links_tpu_torch.models.completers import COMPLETER_SPECS, Completer, Completers
from links_tpu_torch.objectives import occlusion as tocc
from links_tpu_torch.train.optim import Adam
from links_tpu_torch.train.steps import (
    OcclusionDraws,
    TrainState,
    build_occlusion_grads,
    build_occlusion_step,
    draw_occlusion,
)
from test_torch_train_step import _poses

HID = 128
BATCH = 16
F32_TOL = {"rtol": 1e-5, "atol": 1e-5}
# bf16: the packages sum bf16 x bf16 products in f32 in different orders, so
# a hidden activation can round to the neighbouring bf16 value in one of them
# (tests/test_torch_lifters.py:BF16_TOL)
BF16_TOL = {"rtol": 1e-4, "atol": 1e-4}
TOL = {"F32": F32_TOL, "BF16": BF16_TOL}
# bf16 scenario poses: every element within SCENARIO_BF16_TOL (absolute: a
# systematic error on camera-frame z near 10 must not pass by a relative
# bound), and fewer than SCENARIO_BF16_SHARE of them past BF16_TOL
SCENARIO_BF16_TOL = {"rtol": 0.0, "atol": 1e-3}
SCENARIO_BF16_SHARE = 0.02
# relative L2 error bound of a completer parameter's gradient; bf16 rounds
# the gradient products, where a flipped rounding moves a coordinate directly
GRAD_REL = {"F32": 1e-4, "BF16": 3e-3}
# the loss terms after Adam steps that differ on near-zero gradient coordinates
AFTER_STEPS_TOL = {"rtol": 2e-3, "atol": 1e-4}
SCENARIOS = tuple(jocc.DROPOUT_SCENARIO_JOINTS)
LIFTERS = {"left": 11, "right": 11, "legs": 7, "torso": 10}


@pytest.fixture(scope="module")
def models():
    """JAX completers {name: pytree} and lifters {left, right, legs, torso},
    as numpy."""
    keys = jax.random.split(jax.random.PRNGKey(7), 1 + len(LIFTERS))
    completers = jax.tree.map(np.asarray, jmodels.init_all_completers(keys[0], hidden=HID))
    lifters = {name: jax.tree.map(np.asarray, jmodels.init_lifter(k, j, hidden=HID))
               for k, (name, j) in zip(keys[1:], LIFTERS.items())}
    return completers, lifters


def _port_completers(tree) -> Completers:
    completers = Completers(HID)
    completers.load_state_dict({f"{name}.{k}": v for name in COMPLETER_SPECS
                                for k, v in completer_params_from_jax(tree[name]).items()})
    return completers


def _port_lifters(trees) -> dict:
    return {name: lifter_from_state_dict(lifter_params_from_jax(t)).requires_grad_(False)
            for name, t in trees.items()}


def _jax_leaf(tree, key: str) -> np.ndarray:
    """The JAX leaf of a port parameter name ('left_leg.res_pose1.l1.weight'),
    in the port's layout."""
    *path, leaf = key.split(".")
    for p in path:
        tree = tree[p]
    return np.asarray(tree["w"]).T if leaf == "weight" else np.asarray(tree["b"])


def _jax_draws(key, n: int, n_rot: int) -> OcclusionDraws:
    """The uniforms and the normal that links_tpu's occlusion_loss draws from
    ``key`` for a batch of ``n``, as tensors."""
    keys = jax.random.split(key, n_rot + 1)
    u = np.stack([np.asarray(jax.random.uniform(k, (n, 1))) for k in keys[:n_rot]])
    eps = np.asarray(jax.random.normal(keys[-1], ((n_rot + 1) * n, 3, 17)))
    return OcclusionDraws(torch.from_numpy(u), torch.from_numpy(eps.copy()))


def _pose_3d(models, n=BATCH, seed=31) -> np.ndarray:
    """Root-centered (n, 3, 17) pseudo-3D of synthetic 2D poses (JAX, f32)."""
    _, lifters = models
    return np.array(jocc.pseudo_3d_from_lifters(lifters["legs"], lifters["torso"],
                                                  jnp.asarray(_poses(n, seed))))


def _pose_stack(rng, n=BATCH) -> np.ndarray:
    return rng.normal(size=(3, n, 3, 17)).astype(np.float32)


@pytest.mark.parametrize("case", ["split_3d", "occluded_right", "occluded_left",
                                  "limb_ll", "limb_rl", "limb_la", "limb_ra"])
def test_skeleton_pieces_match_exactly(rng, case):
    if case == "split_3d":
        x = rng.normal(size=(BATCH, 51)).astype(np.float32)
        got = tskel.split_data_left_right_3d(torch.from_numpy(x))
        want = jskel.split_data_left_right_3d(jnp.asarray(x))
    elif case.startswith("occluded"):
        side = case.split("_")[1]
        occ = rng.normal(size=(BATCH, 18)).astype(np.float32)
        vis = rng.normal(size=(BATCH, 33)).astype(np.float32)
        got = [tskel.combine_left_right_occluded_3d(torch.from_numpy(occ), torch.from_numpy(vis),
                                                    side)]
        want = [jskel.combine_left_right_occluded_3d(jnp.asarray(occ), jnp.asarray(vis), side)]
    else:
        limb = case.split("_")[1]
        pose = rng.normal(size=(BATCH, 42)).astype(np.float32)
        part = rng.normal(size=(BATCH, 9)).astype(np.float32)
        got = [tskel.combine_pose_and_limb(torch.from_numpy(pose), torch.from_numpy(part), limb)]
        want = [jskel.combine_pose_and_limb(jnp.asarray(pose), jnp.asarray(part), limb)]
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_combine_pose_and_limb_refuses_an_unknown_limb():
    with pytest.raises(ValueError, match="unknown limb"):
        tskel.combine_pose_and_limb(torch.zeros(2, 42), torch.zeros(2, 9), "xx")


@pytest.mark.parametrize("which", ["inputs", "targets"])
def test_part_inputs_and_targets_match_exactly(rng, which):
    p = _pose_stack(rng)
    got = getattr(tocc, f"part_{which}")(torch.from_numpy(p))
    want = getattr(jocc, f"part_{which}")(jnp.asarray(p))
    assert set(got) == set(want) == set(COMPLETER_SPECS)
    for name in got:
        assert tuple(got[name].shape) == want[name].shape, name
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)


@pytest.mark.parametrize("name", ["left_leg", "both_legs", "torso"])
@pytest.mark.parametrize("policy", ["F32", "BF16"])
def test_completer_forward(models, rng, name, policy):
    tree = models[0][name]
    completer = completer_from_state_dict(completer_params_from_jax(tree))
    x = rng.normal(size=(BATCH, 3 * COMPLETER_SPECS[name][0])).astype(np.float32)
    with torch.no_grad():
        got = completer(torch.from_numpy(x), getattr(tnn, policy)).numpy()
    want = np.asarray(jmodels.completer_apply(tree, jnp.asarray(x), getattr(jnn, policy)))
    assert got.shape == (BATCH, 3 * COMPLETER_SPECS[name][1])
    np.testing.assert_allclose(got, want, **TOL[policy])


@pytest.mark.parametrize("policy", ["F32", "BF16"])
def test_pseudo_3d_from_lifters(models, policy):
    _, lifters = models
    port = _port_lifters(lifters)
    poses = _poses(BATCH, seed=32)
    with torch.no_grad():
        got = tocc.pseudo_3d_from_lifters(port["legs"], port["torso"], torch.from_numpy(poses),
                                          10.0, getattr(tnn, policy)).numpy()
    want = np.asarray(jocc.pseudo_3d_from_lifters(lifters["legs"], lifters["torso"],
                                                  jnp.asarray(poses), 10.0, getattr(jnn, policy)))
    assert got.shape == (BATCH, 3, 17)
    np.testing.assert_allclose(got, want, **TOL[policy])


@pytest.mark.parametrize("n_rot,input_noise", [(2, 0.0), (2, 0.3), (1, 0.0)])
@pytest.mark.parametrize("policy", ["F32", "BF16"])
def test_occlusion_loss_and_gradients(models, policy, n_rot, input_noise):
    """The loss terms and the gradient of every completer parameter against
    jax.grad, on the JAX package's own draws of one key."""
    trees, _ = models
    pose = _pose_3d(models)
    key = jax.random.PRNGKey(33)
    (_, jaux), jgrads = jax.value_and_grad(
        lambda p: jocc.occlusion_loss(p, jnp.asarray(pose), key, getattr(jnn, policy), n_rot,
                                      input_noise), has_aux=True)(trees)
    completers = _port_completers(trees)
    draws = _jax_draws(key, BATCH, n_rot)
    loss, aux = tocc.occlusion_loss(completers, torch.from_numpy(pose), draws.u_rot,
                                    draws.eps_input, getattr(tnn, policy), input_noise)
    loss.backward()
    assert set(aux) == set(jaux) == {f"threed_loss_{n}" for n in COMPLETER_SPECS} | {"loss"}
    for k in aux:
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]), err_msg=k,
                                   **TOL[policy])
    params = dict(completers.named_parameters())
    assert len(params) == 8 * (2 + 3 * 2) * 2
    for name, p in params.items():
        want = _jax_leaf(jgrads, name)
        err = np.linalg.norm(p.grad.numpy() - want) / max(np.linalg.norm(want), 1e-12)
        assert err < GRAD_REL[policy], (name, err)


def test_input_noise_moves_only_the_inputs(models):
    """With input noise the loss changes; the targets stay the clean poses,
    so zero noise gives the noiseless loss whatever ``eps_input`` holds."""
    completers = _port_completers(models[0])
    pose = torch.from_numpy(_pose_3d(models))
    draws = _jax_draws(jax.random.PRNGKey(34), BATCH, 2)
    with torch.no_grad():
        clean, _ = tocc.occlusion_loss(completers, pose, draws.u_rot)
        zero, _ = tocc.occlusion_loss(completers, pose, draws.u_rot, draws.eps_input,
                                      input_noise=0.0)
        noisy, _ = tocc.occlusion_loss(completers, pose, draws.u_rot, draws.eps_input,
                                       input_noise=0.3)
    assert float(clean) == float(zero) and float(noisy) != float(clean)


@pytest.mark.parametrize("policy", ["F32", "BF16"])
def test_three_occlusion_steps_match_the_jax_step(models, policy):
    """Three whole steps (frozen lifters' pseudo-3D, loss, gradient, f32-moment
    Adam, two steps per epoch) on the same batches, each on the draws of the
    JAX step's key."""
    trees, lifters = models
    data = _poses(3 * BATCH, seed=35)
    cfg_j = JOcclusionTrainConfig(batch_size=BATCH, bf16=policy == "BF16")
    cfg_t = OcclusionTrainConfig(batch_size=BATCH, bf16=policy == "BF16")
    opt = make_optimizer(cfg_j.optim, steps_per_epoch=2)
    jstep = j_build_step(lifters["legs"], lifters["torso"], opt, cfg_j)
    jstate = init_state(trees, opt)
    completers, port = _port_completers(trees), _port_lifters(lifters)
    state = TrainState(completers, Adam(completers.parameters(), cfg_t.optim, steps_per_epoch=2))
    step = build_occlusion_step(port["legs"], port["torso"], cfg_t)
    for i in range(3):
        batch = data[i * BATCH:(i + 1) * BATCH]
        key = jax.random.PRNGKey(100 + i)
        jstate, jaux = jstep(jstate, jnp.asarray(batch), key)
        aux = step(state, torch.from_numpy(batch), _jax_draws(key, BATCH, cfg_t.n_rot))
        tol = TOL[policy] if i == 0 else AFTER_STEPS_TOL
        for k in jaux:
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]), err_msg=f"{i} {k}", **tol)
    assert state.step == 3 and state.opt.count == 3
    assert all(p.grad is None for lifter in port.values() for p in lifter.parameters())
    lr = cfg_t.optim.learning_rate
    diffs = np.concatenate([np.abs(p.detach().numpy() - _jax_leaf(jstate.params, name)).ravel()
                            for name, p in completers.named_parameters()])
    assert diffs.max() <= 3 * 2 * lr
    assert (diffs > 1e-6).mean() < (0.001 if policy == "F32" else 0.05)


def test_occlusion_grads_leave_the_lifters_alone(models):
    """The pseudo-3D carries no gradient: only the completers get one."""
    trees, lifters = models
    port = _port_lifters(lifters)
    for lifter in port.values():
        lifter.requires_grad_(True)
    completers = _port_completers(trees)
    cfg = OcclusionTrainConfig(batch_size=BATCH, bf16=False)
    draws = draw_occlusion(torch.Generator().manual_seed(0), BATCH, "cpu", cfg.n_rot)
    aux, grads = build_occlusion_grads(port["legs"], port["torso"], cfg)(
        completers, torch.from_numpy(_poses(BATCH, seed=36)), draws)
    assert len(grads) == len(list(completers.parameters())) and np.isfinite(float(aux["loss"]))
    assert all(p.grad is None for lifter in port.values() for p in lifter.parameters())


@pytest.mark.parametrize("n_rot,input_noise,noise_shape", [(2, 0.0, None), (3, 0.1, (64, 3, 17))])
def test_draw_occlusion(n_rot, input_noise, noise_shape):
    g = torch.Generator().manual_seed(1)
    draws = draw_occlusion(g, BATCH, "cpu", n_rot, input_noise)
    assert draws.u_rot.shape == (n_rot, BATCH, 1)
    assert float(draws.u_rot.min()) >= 0.0 and float(draws.u_rot.max()) < 1.0
    assert (None if draws.eps_input is None else tuple(draws.eps_input.shape)) == noise_shape


@pytest.mark.parametrize("scenarios", [None, ("torso",), ("ll", "right")])
@pytest.mark.parametrize("policy", ["F32", "BF16"])
def test_occlusion_validation_poses(models, policy, scenarios):
    _check_validation_poses(models, policy, scenarios, seed=37)


@pytest.mark.parametrize("seed", [38, 39])
def test_occlusion_validation_poses_bf16_seeds(models, seed):
    """More inputs whose bf16 poses show isolated rounding flips, each held
    to the same bounds."""
    _check_validation_poses(models, "BF16", None, seed)


def _check_validation_poses(models, policy, scenarios, seed):
    trees, lifters = models
    poses = _poses(BATCH, seed=seed)
    want = jocc.occlusion_validation_poses(trees, lifters, jnp.asarray(poses), 10.0,
                                           getattr(jnn, policy), scenarios)
    with torch.no_grad():
        got = tocc.occlusion_validation_poses(_port_completers(trees), _port_lifters(lifters),
                                              torch.from_numpy(poses), 10.0,
                                              getattr(tnn, policy), scenarios)
    assert list(got) == list(want) and set(got) == set(scenarios or SCENARIOS)
    for name in got:
        g, w = got[name].numpy(), np.asarray(want[name])
        assert g.shape == (BATCH, 51)
        if policy == "F32":
            np.testing.assert_allclose(g, w, err_msg=name, **F32_TOL)
            continue
        # a scenario's pose runs 7 lifter and 3 completer blocks, so one bf16
        # rounding flip moves a few of its coordinates past BF16_TOL (observed
        # over seeds 37-44: at most 5.9e-4, on at most 1.7% of the elements
        # of a scenario)
        np.testing.assert_allclose(g, w, err_msg=name, **SCENARIO_BF16_TOL)
        assert (np.abs(g - w) > BF16_TOL["atol"] + BF16_TOL["rtol"] * np.abs(w)).mean() \
            < SCENARIO_BF16_SHARE, name


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_drop_keypoints(rng, scenario):
    x = rng.normal(size=(BATCH, 34)).astype(np.float32)
    joints = tocc.DROPOUT_SCENARIO_JOINTS[scenario]
    assert joints == jocc.DROPOUT_SCENARIO_JOINTS[scenario]
    got = tocc.drop_keypoints(torch.from_numpy(x), joints).numpy()
    np.testing.assert_array_equal(got, np.asarray(jocc.drop_keypoints(jnp.asarray(x), joints)))
    assert not got.reshape(-1, 2, 17)[:, :, list(joints)].any()


@pytest.mark.parametrize("name", list(COMPLETER_SPECS))
def test_completer_pt_round_trips_with_the_jax_package(models, tmp_path, name):
    """A file the port writes has the keys of the JAX package's
    completer_to_torch and loads into its load_completer_pt; a file the JAX
    package writes loads into the port's load_completer_pt. Both exactly."""
    tree = models[0][name]
    completer = completer_from_state_dict(completer_params_from_jax(tree))
    save_completer_pt(completer, tmp_path / "port.pt")
    written = torch.load(tmp_path / "port.pt", weights_only=True)
    assert set(written) == set(jckpt.completer_to_torch(tree))
    assert not any(bool(written[k].any()) for k in written if k.startswith("res_common.l"))
    back = jckpt.load_completer_pt(tmp_path / "port.pt")
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                 back, tree)
    jckpt.save_pt(tmp_path / "jax.pt", jckpt.completer_to_torch(tree))
    loaded = load_completer_pt(tmp_path / "jax.pt")
    assert isinstance(loaded, Completer)
    want = completer_params_from_jax(tree)
    got = loaded.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_completers_parameter_order():
    completers = Completers(64)
    assert list(completers) == list(COMPLETER_SPECS)
    want = [p for name in COMPLETER_SPECS for p in completers[name].parameters()]
    got = list(completers.parameters())
    assert len(got) == len(want) == 8 * (2 + 3 * 2) * 2
    assert all(a is b for a, b in zip(got, want))


def test_resolve_cfg_ignores_nll_cap_on_stage_4():
    """--nll-cap applies to the stages with a flow term and is ignored on
    stage 4's config, which has no such field, as the JAX package does."""
    args = SimpleNamespace(epochs=None, batch_size=None, f32=False, nll_cap=100.0,
                           bf16_opt_state=False, clip_grad=None)
    cfg = tcommon.resolve_cfg(args, OcclusionTrainConfig())
    assert cfg == OcclusionTrainConfig(optim=OptimConfig(bf16_moments=False))
    assert not hasattr(cfg, "nll_cap")
