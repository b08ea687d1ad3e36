"""The residual block of links_tpu_torch (ops/resblock.py: the plain version
of the K1 kernel, with its hand-written backward) against links_tpu on the
CPU: the Pallas kernel in interpret mode at f32 (mirroring
tests/test_pallas_ops.py, with its tolerances), and jax.grad of
res_block_apply under the bf16 policy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_suite import one_cpu_thread  # noqa: F401  (an autouse fixture)
from links_tpu.core import nn as jnn
from links_tpu.experimental import fused_res_block
from links_tpu.models.lifters import init_res_block, res_block_apply
from links_tpu_torch.core import nn as tnn
from links_tpu_torch.models.lifters import ResBlock
from links_tpu_torch.ops import resblock as K1

D = 128  # small width for the interpreter; the kernel is width-generic
TILE = 64
GRAD_NAMES = ("dx", "dw1", "db1", "dw2", "db2")
# Under bf16 the four gradient products are rounded to bf16 after an f32 sum
# whose order differs between the packages, so a sum that lies within its
# rounding error of a bf16 rounding boundary rounds the other way: one bf16
# unit in the last place, at most 2**-7 of the value. Everything else
# differs by summation order only.
BF16_ULP = 2.0 ** -7
SUM_ORDER_TOL = 1e-5


def _setup(b=96, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), 5)
    x = jax.random.normal(keys[0], (b, D))
    w1 = jax.random.normal(keys[1], (D, D)) * 0.03
    b1 = jax.random.normal(keys[2], (D,)) * 0.01
    w2 = jax.random.normal(keys[3], (D, D)) * 0.03
    b2 = jax.random.normal(keys[4], (D,)) * 0.01
    return x, w1, b1, w2, b2


def _port_args(x, w1, b1, w2, b2):
    """JAX (in, out) weights -> the port's torch (out, in) layout, as leaf
    tensors that record gradients."""
    arrs = (x, np.asarray(w1).T, b1, np.asarray(w2).T, b2)
    return [torch.tensor(np.array(a), requires_grad=True) for a in arrs]


def _port_grads(args, dy, policy):
    y = K1.res_block_reference(*args, policy)
    y.backward(torch.tensor(np.array(dy)))
    dx, dw1, db1, dw2, db2 = (a.grad.numpy() for a in args)
    return y.detach().numpy(), (dx, dw1.T, db1, dw2.T, db2)  # weights back to (in, out)


def test_forward_matches_pallas_kernel():
    x, w1, b1, w2, b2 = _setup()
    got = K1.res_block_reference(*_port_args(x, w1, b1, w2, b2), tnn.F32)
    want = fused_res_block(x, w1, b1, w2, b2, TILE, True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


def test_forward_ragged_batch():
    x, w1, b1, w2, b2 = _setup(b=70)  # not a multiple of the tile
    got = K1.res_block_reference(*_port_args(x, w1, b1, w2, b2), tnn.F32)
    want = fused_res_block(x, w1, b1, w2, b2, TILE, True)
    assert tuple(got.shape) == (70, D)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("batch", [96, 70, 3 * TILE])
def test_gradients_match_pallas_kernel(batch):
    """All five gradients of sum(y**2); 3 * TILE rows exercise the Pallas
    kernel's accumulation of weight gradients over batch tiles."""
    x, w1, b1, w2, b2 = _setup(b=batch)
    y = fused_res_block(x, w1, b1, w2, b2, TILE, True)
    want = jax.grad(lambda *a: (fused_res_block(*a, TILE, True) ** 2).sum(),
                    argnums=(0, 1, 2, 3, 4))(x, w1, b1, w2, b2)
    _, got = _port_grads(_port_args(x, w1, b1, w2, b2), 2.0 * y, tnn.F32)
    for g, w, name in zip(got, want, GRAD_NAMES):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-4, rtol=2e-4, err_msg=name)


@pytest.mark.parametrize("policy", ["F32", "BF16"])
@pytest.mark.parametrize("batch", [70, 3 * TILE])
def test_matches_jax_grad_of_res_block_apply(policy, batch):
    """The block and its vjp against jax.vjp of the JAX package's
    res_block_apply, the function the training step differentiates."""
    p = jax.tree.map(np.asarray, init_res_block(jax.random.PRNGKey(batch), D))
    rng = np.random.default_rng(batch)
    x = rng.normal(size=(batch, D)).astype(np.float32)
    dy = rng.normal(size=(batch, D)).astype(np.float32)
    y, vjp = jax.vjp(lambda q, xx: res_block_apply(q, xx, getattr(jnn, policy)), p,
                     jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(dy))
    want = (gx, gp["l1"]["w"], gp["l1"]["b"], gp["l2"]["w"], gp["l2"]["b"])
    got_y, got = _port_grads(_port_args(x, p["l1"]["w"], p["l1"]["b"], p["l2"]["w"],
                                        p["l2"]["b"]), dy, getattr(tnn, policy))
    np.testing.assert_allclose(got_y, np.asarray(y), rtol=0, atol=SUM_ORDER_TOL)
    for g, w, name in zip(got, want, GRAD_NAMES):
        w = np.asarray(w)
        err = np.abs(g - w)
        if policy == "BF16" and name in ("dx", "dw1", "dw2"):
            assert err.max() <= BF16_ULP * np.abs(w).max(), name
            assert (err > SUM_ORDER_TOL).mean() < 0.01, name  # rounding flips only
        else:
            assert err.max() <= SUM_ORDER_TOL * max(1.0, np.abs(w).max()), name


def _one_term_backward(dy, x, w1, w2, a1, h, a2):
    """The bf16 backward with g1, g2 rounded to one bf16 term before each
    product, as the Pallas kernel does: -> (dx, dW1, dW2), torch layout."""
    def r(t):
        return t.bfloat16().float()

    g2 = r(dy * K1._dlrelu(a2))
    g1 = r(r(g2 @ r(w2)) * K1._dlrelu(a1))
    return dy + r(g1 @ r(w1)), r(g1.mT @ r(x)), r(g2.mT @ r(h))


@pytest.mark.parametrize("batch", [70, 3 * TILE])
def test_flip_check_rejects_one_term_gradient_operands(batch):
    """The ulp bound of the bf16 check passes one-term gradient operands too;
    the share of moved elements is what rejects them."""
    p = jax.tree.map(np.asarray, init_res_block(jax.random.PRNGKey(batch), D))
    rng = np.random.default_rng(batch)
    x = rng.normal(size=(batch, D)).astype(np.float32)
    dy = rng.normal(size=(batch, D)).astype(np.float32)
    _, vjp = jax.vjp(lambda q, xx: res_block_apply(q, xx, jnn.BF16), p, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(dy))
    want = (gx, gp["l1"]["w"].T, gp["l2"]["w"].T)  # weights to torch's (out, in)
    x_t, w1, b1, w2, b2 = (a.detach() for a in _port_args(x, p["l1"]["w"], p["l1"]["b"],
                                                           p["l2"]["w"], p["l2"]["b"]))
    _, a1, h, a2 = K1.res_block_forward_reference(x_t, w1, b1, w2, b2, tnn.BF16)
    got = _one_term_backward(torch.from_numpy(dy), x_t, w1, w2, a1, h, a2)
    for g, w, name in zip(got, want, ("dx", "dw1", "dw2")):
        err = np.abs(g.numpy() - np.asarray(w))
        assert err.max() <= BF16_ULP * np.abs(w).max(), name
        assert (err > SUM_ORDER_TOL).mean() > 0.1, name


def test_bf16_policy_is_not_f32():
    x, w1, b1, w2, b2 = _setup()
    args = _port_args(x, w1, b1, w2, b2)
    with torch.no_grad():
        gap = (K1.res_block_reference(*args, tnn.BF16)
               - K1.res_block_reference(*args, tnn.F32)).abs().max()
    assert float(gap) > 100 * SUM_ORDER_TOL


def test_lrelu_derivative_is_one_at_zero():
    """lrelu'(0) = 1, as jnp.where's gradient gives (F.leaky_relu's is 0.01)."""
    got = K1._dlrelu(torch.tensor([0.0, -1e-30, 2.0]))
    assert torch.equal(got, torch.tensor([1.0, 0.01, 1.0]))


def test_res_block_module_runs_the_plain_version_on_the_cpu():
    block = ResBlock(D, generator=torch.Generator().manual_seed(0))
    x = torch.randn(9, D, generator=torch.Generator().manual_seed(1))
    want = K1.res_block_reference(x, block.l1.weight, block.l1.bias, block.l2.weight,
                                  block.l2.bias, tnn.BF16)
    before = K1.res_block_forward.launches
    assert torch.equal(block(x, tnn.BF16), want)
    assert K1.res_block_forward.launches == before


@pytest.mark.parametrize("shape,message", [
    ((4, 100), "multiple of 64"),
    ((0, 128), "empty batch"),
    ((2, 4, 128), r"\(B, H\)"),
    ((4, 128), "CUDA tensors"),
])
def test_kernel_wrapper_rejects_what_it_does_not_take(shape, message):
    hid = shape[-1]
    x = torch.zeros(shape)
    w, b = torch.zeros(hid, hid), torch.zeros(hid)
    with pytest.raises(ValueError, match=message):
        K1.res_block_forward(x, w, b, w, b, tnn.BF16)
    if x.dim() == 2:
        with pytest.raises(ValueError, match=message):
            K1.res_block_backward(x, x, w, w, x, x, x, tnn.BF16)


def _linear_weights(seed):
    block = ResBlock(D, generator=torch.Generator().manual_seed(seed))
    return block, block.l1.weight


def test_weight_plane_is_cast_once_per_weight_version():
    block, w = _linear_weights(2)
    before = K1.weight_plane.casts
    plane = K1.weight_plane(w)
    assert plane.dtype == torch.bfloat16 and torch.equal(plane, w.detach().to(torch.bfloat16))
    assert K1.weight_plane(w) is plane
    assert K1.weight_plane.casts == before + 1


@pytest.mark.parametrize("change", ["adam_step", "load_state_dict", "copy_"])
def test_weight_plane_is_cast_again_after_the_weight_changes(change):
    from links_tpu_torch.config import OptimConfig
    from links_tpu_torch.train.optim import Adam

    block, w = _linear_weights(3)
    plane = K1.weight_plane(w)
    if change == "adam_step":
        Adam(block.parameters(), OptimConfig(), steps_per_epoch=1).step(
            [torch.ones_like(p) for p in block.parameters()])
    elif change == "load_state_dict":
        other, _ = _linear_weights(4)
        block.load_state_dict(other.state_dict())
    else:
        with torch.no_grad():
            w.copy_(torch.randn(w.shape, generator=torch.Generator().manual_seed(5)))
    before = K1.weight_plane.casts
    fresh = K1.weight_plane(w)
    assert fresh is not plane and not torch.equal(fresh, plane)
    assert torch.equal(fresh, w.detach().to(torch.bfloat16))
    assert K1.weight_plane.casts == before + 1
    assert K1.weight_plane(w) is fresh


@pytest.mark.parametrize("scale", [1e-3, 1.0, 3e4])
def test_two_term_split_holds_16_significant_bits(scale):
    v = torch.from_numpy(np.random.default_rng(6).normal(size=(37, D)).astype(np.float32)) * scale
    hi, lo = K1.split_reference(v, 2)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, v.bfloat16())
    err = (hi.double() + lo.double() - v.double()).abs()
    assert bool((err <= 2.0 ** -16 * v.double().abs()).all())
    # one term holds 8 bits only
    assert float(((hi.double() - v.double()).abs() / v.double().abs()).max()) > 2.0 ** -12


def test_split_masks_by_the_lrelu_derivative():
    rng = np.random.default_rng(7)
    dy, a2 = (torch.from_numpy(rng.normal(size=(9, D)).astype(np.float32)) for _ in "da")
    hi, lo = K1.split_planes(dy, 2, mask=a2)  # CPU tensors: the plain version
    g2 = dy * K1._dlrelu(a2)
    assert torch.equal(hi, g2.bfloat16()) and torch.equal(lo, (g2 - hi.float()).bfloat16())
    (x_plane,) = K1.split_planes(dy, 1)
    assert torch.equal(x_plane, dy.bfloat16())


def _pair_sum(a_planes, b_plane):
    """The sum over the term pairs (t, 0) of A_t @ B in f32: what the bf16
    kernels' mainloop computes from A's term planes and B's one plane."""
    return sum(a.float() @ b_plane.float() for a in a_planes)


@pytest.mark.parametrize("product", ["dh", "dx"])
def test_pair_list_sum_is_the_backward_product(product):
    """Sum over the pairs (0, 0), (1, 0) of g's hi and lo planes times W's one
    plane: res_block_backward_reference's g @ bf16(W), up to the 2**-17 of
    each |g| the lo plane drops and f32 summation order, both bounded by a
    share of |g| @ |bf16(W)|."""
    p = jax.tree.map(np.asarray, init_res_block(jax.random.PRNGKey(8), D))
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(70, D)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(70, D)).astype(np.float32))
    x_t, w1, b1, w2, b2 = (a.detach() for a in _port_args(x.numpy(), p["l1"]["w"], p["l1"]["b"],
                                                           p["l2"]["w"], p["l2"]["b"]))
    _, a1, _, a2 = K1.res_block_forward_reference(x_t, w1, b1, w2, b2, tnn.BF16)
    g2 = dy * K1._dlrelu(a2)
    g1 = (g2 @ w2.bfloat16().float()).bfloat16().float() * K1._dlrelu(a1)
    g, w = (g2, w2) if product == "dh" else (g1, w1)
    want = g @ w.bfloat16().float()
    bound = 2.0 ** -15 * (g.abs() @ w.bfloat16().float().abs())
    got = _pair_sum(K1.split_reference(g, 2), K1.weight_plane(w))
    assert bool(((got - want).abs() <= bound).all())
    # g2 needs its lo plane; g1 = bf16(dh) * lrelu'(a1) needs it only where a1 < 0
    one_term = _pair_sum(K1.split_reference(g, 1), K1.weight_plane(w))
    assert bool(((one_term - want).abs() > bound).any()) == (product == "dh")
    # rounded to bf16 as the backward rounds it: rounding flips only
    flips = (got.bfloat16().float() != want.bfloat16().float()).float().mean()
    assert float(flips) < 0.01


def test_weight_plane_of_an_inference_tensor_is_cast_once():
    with torch.inference_mode():
        w = torch.randn(D, D, generator=torch.Generator().manual_seed(9))
        before = K1.weight_plane.casts
        plane = K1.weight_plane(w)
        assert K1.weight_plane(w) is plane and K1.weight_plane.casts == before + 1
    assert torch.equal(plane, w.to(torch.bfloat16))
