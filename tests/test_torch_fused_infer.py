"""The fused serving forward of links_tpu_torch (ops/fused_infer.py) against
links_tpu's Pallas kernel, which runs here in interpret mode. On the CPU the
wrapper takes the plain PyTorch version; the CUDA kernel itself is held
against it on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_suite import one_cpu_thread  # noqa: F401  (an autouse fixture)
from links_tpu import models as jmodels
from links_tpu.core.skeleton import split_data_left_right as j_split
from links_tpu.ops import fused_sides_forward as j_fused
from links_tpu.ops import lift_left_right_eval_fused as j_lift_fused
from links_tpu.ops import prepare_fused_weights as j_prepare
from links_tpu_torch.ckpt.torch_io import lifter_from_state_dict, lifter_params_from_jax
from links_tpu_torch.core.nn import BF16
from links_tpu_torch.models.lifters import StackedLifter
from links_tpu_torch.ops import fused_infer as K2

HID = 128
TOL = {"rtol": 1e-4, "atol": 1e-4}


@pytest.fixture(scope="module")
def pair():
    """(JAX stacked pytree, port StackedLifter) with the same weights."""
    trees = [jax.tree.map(np.asarray, jmodels.init_lifter(jax.random.PRNGKey(s), 11,
                                                          hidden=HID)) for s in (0, 1)]
    stacked = jax.tree.map(lambda a, b: jnp.stack([a, b]), *trees)
    port = StackedLifter(*(lifter_from_state_dict(lifter_params_from_jax(t)) for t in trees))
    return stacked, port


def _poses(rng, n):
    p = rng.normal(size=(n, 2, 17)).astype(np.float32) * 0.1
    p[:, :, 0] = 0.0
    return p.reshape(n, 34)


@pytest.mark.parametrize("batch", [1, 20, 32])
def test_plain_version_matches_pallas_kernel(rng, pair, batch):
    stacked, port = pair
    p = _poses(rng, batch)
    left, right = j_split(jnp.asarray(p))
    want = j_fused(j_prepare(stacked), left, right, interpret=True)
    with torch.no_grad():
        got = K2.fused_sides_forward_reference(
            K2.prepare_fused_weights(port), torch.from_numpy(np.array(left)),
            torch.from_numpy(np.array(right)))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("choice", ["right", "left"])
def test_lift_left_right_eval_fused_matches_jax_twin(rng, pair, choice):
    stacked, port = pair
    p = _poses(rng, 24)
    want = j_lift_fused(j_prepare(stacked), jnp.asarray(p), 10.0, choice, interpret=True)
    with torch.no_grad():
        got = K2.lift_left_right_eval_fused(K2.prepare_fused_weights(port),
                                            torch.from_numpy(p), 10.0, choice)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_wrapper_takes_the_plain_version_and_counts_no_launch(rng, pair):
    _, port = pair
    prep = K2.prepare_fused_weights(port)
    left, right = (torch.from_numpy(rng.normal(size=(5, 22)).astype(np.float32))
                   for _ in range(2))
    before = K2.fused_sides_forward.launches
    with torch.no_grad():
        got = K2.fused_sides_forward(prep, left, right)
        want = port(left, right, BF16)
    assert K2.fused_sides_forward.launches == before
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6)


def test_prepare_fused_weights_layout(pair):
    _, port = pair
    prep = K2.prepare_fused_weights(port)
    for name, (dtype, shape) in K2.FusedWeights._SHAPES.items():
        assert prep[name].dtype == dtype and prep[name].is_contiguous()
        assert tuple(prep[name].shape) == shape(22, HID, 11)
    assert (prep.in_dim, prep.hidden, prep.n_out) == (22, HID, 11)
    # chain weights are torch's (out, in), K-major for wgmma: block res_pose2
    # (index 2), l2, right side; the upscale weight is (in, out)
    assert torch.equal(prep["w_chain"][1, 2, 1],
                       port.right.res_pose2.l2.weight.detach().bfloat16())
    assert torch.equal(prep["w_up"][0], port.left.upscale.weight.detach().T.bfloat16())


@pytest.mark.parametrize("batch", [513, 600])
def test_rejects_oversize_batch(rng, pair, batch):
    _, port = pair
    prep = K2.prepare_fused_weights(port)
    x = torch.zeros(batch, 22)
    with pytest.raises(ValueError, match="latency path"):
        K2.fused_sides_forward(prep, x, x)
    with pytest.raises(ValueError, match="latency path"):
        K2.fused_sides_forward_reference(prep, x, x)


def test_rejects_mismatched_sides(pair):
    _, port = pair
    prep = K2.prepare_fused_weights(port)
    with pytest.raises(ValueError, match="two"):
        K2.fused_sides_forward(prep, torch.zeros(4, 22), torch.zeros(3, 22))

