"""links_tpu_torch lifters, eval objectives and .pt checkpoints against
links_tpu on the CPU. Both packages get the same weights through
``lifter_params_from_jax``; hidden width 128 keeps the tests fast."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_suite import one_cpu_thread  # noqa: F401  (an autouse fixture)
from links_tpu import ckpt as jckpt
from links_tpu import models as jmodels
from links_tpu.core import nn as jnn
from links_tpu.objectives import lift_leg_torso_eval as j_leg_torso
from links_tpu.objectives import lift_left_right_eval as j_left_right
from links_tpu_torch.ckpt.torch_io import (
    lifter_from_state_dict,
    lifter_params_from_jax,
    load_lifter_pt,
    save_lifter_pt,
)
from links_tpu_torch.core import nn as tnn
from links_tpu_torch.models.lifters import Lifter, StackedLifter
from links_tpu_torch.objectives.lifter import lift_leg_torso_eval, lift_left_right_eval

HID = 128
F32_TOL = {"rtol": 0, "atol": 2e-5}      # test_reference_parity.py's lifter tolerance
# The two packages sum bf16 x bf16 products in f32 in different orders; a
# last-bit difference can flip the bf16 rounding of a hidden activation,
# which moves an output by a few 1e-5. test_bf16_policy_is_not_f32 shows the
# tolerance still tells the bf16 policy from f32.
BF16_TOL = {"rtol": 1e-4, "atol": 1e-4}


def _jax_lifter(seed, joints, hidden=HID):
    tree = jmodels.init_lifter(jax.random.PRNGKey(seed), joints, hidden=hidden)
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return lifter_from_state_dict(lifter_params_from_jax(tree))


def _poses(rng, n):
    p = rng.normal(size=(n, 2, 17)).astype(np.float32) * 0.1
    p[:, :, 0] = 0.0
    return p.reshape(n, 34)


@pytest.mark.parametrize("joints", [11, 7, 10, 17])
@pytest.mark.parametrize("policy,tol", [("F32", F32_TOL), ("BF16", BF16_TOL)])
def test_lifter_matches_lifter_apply(rng, joints, policy, tol):
    tree = _jax_lifter(joints, joints)
    x = rng.normal(size=(13, 2 * joints)).astype(np.float32) * 0.1
    with torch.no_grad():
        got = _port(tree)(torch.from_numpy(x), getattr(tnn, policy))
    want = jmodels.lifter_apply(tree, jnp.asarray(x), getattr(jnn, policy))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def test_bf16_policy_is_not_f32(rng):
    lifter = _port(_jax_lifter(0, 11))
    x = torch.from_numpy(rng.normal(size=(64, 22)).astype(np.float32) * 0.1)
    with torch.no_grad():
        gap = (lifter(x, tnn.BF16)[0] - lifter(x, tnn.F32)[0]).abs().max()
    assert float(gap) > 5 * BF16_TOL["atol"]


def test_state_dict_keys_are_the_reference_layout():
    keys = set(Lifter(11, HID).state_dict())
    want = set(jckpt.lifter_to_torch(_jax_lifter(0, 11)))
    assert keys == {k for k in want if ".bn" not in k}


def test_lifter_init_is_seeded():
    a = Lifter(11, HID, generator=torch.Generator().manual_seed(7))
    b = Lifter(11, HID, generator=torch.Generator().manual_seed(7))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


@pytest.mark.parametrize("policy,tol", [("F32", F32_TOL), ("BF16", BF16_TOL)])
@pytest.mark.parametrize("choice", ["left", "right"])
def test_lift_left_right_eval(rng, policy, tol, choice):
    left, right = _jax_lifter(1, 11), _jax_lifter(2, 11)
    stacked_j = jax.tree.map(lambda a, b: jnp.stack([a, b]), left, right)
    stacked_t = StackedLifter(_port(left), _port(right))
    p = _poses(rng, 24)
    with torch.no_grad():
        got = lift_left_right_eval(stacked_t, torch.from_numpy(p), 10.0, choice,
                                   getattr(tnn, policy))
    want = j_left_right(stacked_j, jnp.asarray(p), 10.0, choice, getattr(jnn, policy))
    assert tuple(got.shape) == (24, 51)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("policy,tol", [("F32", F32_TOL), ("BF16", BF16_TOL)])
def test_lift_leg_torso_eval(rng, policy, tol):
    legs, torso = _jax_lifter(3, 7), _jax_lifter(4, 10)
    p = _poses(rng, 17)
    with torch.no_grad():
        got = lift_leg_torso_eval(_port(legs), _port(torso), torch.from_numpy(p), 8.0,
                                  getattr(tnn, policy))
    want = j_leg_torso(legs, torso, jnp.asarray(p), 8.0, getattr(jnn, policy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_load_lifter_pt_of_a_jax_export(rng, tmp_path):
    """A .pt written by links_tpu.ckpt.lifter_to_torch (bn* keys included)
    serves the same outputs in the port."""
    tree = _jax_lifter(5, 11)
    path = tmp_path / "left_lifter.pt"
    jckpt.save_pt(path, jckpt.lifter_to_torch(tree))
    x = rng.normal(size=(9, 22)).astype(np.float32) * 0.1
    with torch.no_grad():
        got = load_lifter_pt(path)(torch.from_numpy(x))
    want = jmodels.lifter_apply(tree, jnp.asarray(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)


def test_save_lifter_pt_loads_in_the_jax_package(tmp_path):
    lifter = Lifter(11, HID, generator=torch.Generator().manual_seed(9))
    path = tmp_path / "right_lifter.pt"
    save_lifter_pt(lifter, path)
    sd = torch.load(path, weights_only=True)
    assert torch.equal(sd["res_common.bn1.weight"], torch.ones(HID))
    tree = jckpt.load_lifter_pt(path)
    np.testing.assert_array_equal(np.asarray(tree["res_pose2"]["l1"]["w"]),
                                  lifter.res_pose2.l1.weight.detach().numpy().T)
    np.testing.assert_array_equal(np.asarray(tree["angles"]["b"]),
                                  lifter.angles.bias.detach().numpy())


def test_state_dict_mismatch_raises():
    sd = lifter_params_from_jax(_jax_lifter(0, 11))
    del sd["res_angle3.l2.bias"]
    with pytest.raises(RuntimeError, match="res_angle3.l2.bias"):
        lifter_from_state_dict(sd)
