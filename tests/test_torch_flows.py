"""links_tpu_torch flows against links_tpu.flows on the CPU. Both packages get
the same weights through ``flow_params_from_jax`` (or a FrEIA-layout .pt);
subnet width 64 and 4 blocks keep the tests fast."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_suite import one_cpu_thread  # noqa: F401  (an autouse fixture)
from links_tpu import ckpt as jckpt
from links_tpu import flows as jflows
from links_tpu.core import geometry as jgeo
from links_tpu.core import nn as jnn
from links_tpu_torch import flows as tflows
from links_tpu_torch.ckpt.torch_io import (
    flow_from_state_dict,
    flow_params_from_jax,
    load_flow_pt,
    save_flow_pt,
)
from links_tpu_torch.core import nn as tnn

HID = 64
F32_TOL = {"rtol": 1e-5, "atol": 1e-5}
# bf16 subnet products summed in another order can flip a bf16 rounding of
# the hidden activation (as for the lifters, tests/test_torch_lifters.py)
BF16_TOL = {"rtol": 1e-4, "atol": 1e-4}


def _jax_flow(dim, seed=0, n_blocks=4):
    flow = jflows.init_flow(jax.random.PRNGKey(seed), dim, n_blocks=n_blocks, hidden=HID)
    # move the global affine off its identity init so it is exercised
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, flow.params)
    params["global_scale"] = params["global_scale"] + rng.normal(
        size=params["global_scale"].shape).astype(np.float32)
    params["global_offset"] = rng.normal(size=params["global_offset"].shape).astype(
        np.float32) * 0.1
    return jflows.Flow(params=params, perm=np.asarray(flow.perm))


def _port(flow):
    return flow_from_state_dict(flow_params_from_jax(flow.params, flow.perm))


def _poses(rng, n, dim):
    return (rng.normal(size=(n, dim)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("dim", [34, 22])
@pytest.mark.parametrize("policy,tol", [("F32", F32_TOL), ("BF16", BF16_TOL)])
def test_forward_and_inverse_match_jax(rng, dim, policy, tol):
    flow = _jax_flow(dim, seed=dim)
    port = _port(flow)
    x = _poses(rng, 24, dim)
    with torch.no_grad():
        z, ld = tflows.forward(port, torch.from_numpy(x), getattr(tnn, policy))
        xi, ldi = tflows.inverse(port, z, getattr(tnn, policy))
    jz, jld = jflows.forward(flow, jnp.asarray(x), getattr(jnn, policy))
    jxi, jldi = jflows.inverse(flow, jz, getattr(jnn, policy))
    for got, want in ((z, jz), (ld, jld), (xi, jxi), (ldi, jldi)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("policy", ["F32", "BF16"])
def test_inverse_of_forward_is_identity(rng, policy):
    port = _port(_jax_flow(22, seed=3))
    x = torch.from_numpy(_poses(rng, 16, 22))
    with torch.no_grad():
        z, ld = tflows.forward(port, x, getattr(tnn, policy))
        back, ld_inv = tflows.inverse(port, z, getattr(tnn, policy))
    torch.testing.assert_close(back, x, rtol=0, atol=2e-6)
    torch.testing.assert_close(ld + ld_inv, torch.zeros_like(ld), rtol=0, atol=2e-5)


def test_nll_and_soft_cap(rng):
    z = _poses(rng, 12, 22) * np.linspace(10.0, 150.0, 12, dtype=np.float32)[:, None]
    ld = rng.normal(size=(12,)).astype(np.float32)
    got = tflows.nll(torch.from_numpy(z), torch.from_numpy(ld))
    want = jflows.nll(jnp.asarray(z), jnp.asarray(ld))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert float(got.min()) < 500.0 < float(got.max())  # both branches of the cap
    np.testing.assert_allclose(tflows.soft_cap_nll(got, 500.0).numpy(),
                               np.asarray(jflows.soft_cap_nll(want, 500.0)), rtol=1e-6)


@pytest.mark.parametrize("policy", ["F32", "BF16"])
def test_draw_samples_with_the_same_noise(rng, monkeypatch, policy):
    flow = _jax_flow(34, seed=5)
    x = _poses(rng, 10, 34)
    eps = rng.normal(size=(10, 34)).astype(np.float32)
    monkeypatch.setattr(jgeo.jax.random, "normal", lambda key, shape, dtype: jnp.asarray(eps))
    want = jflows.draw_samples(flow, jnp.asarray(x), None, 0.2, policy=getattr(jnn, policy))
    got = tflows.draw_samples(_port(flow), torch.from_numpy(x), torch.from_numpy(eps), 0.2,
                              policy=getattr(tnn, policy))
    assert not got.requires_grad
    assert torch.all(got.reshape(-1, 2, 17)[:, :, 0] == 0)
    tol = F32_TOL if policy == "F32" else BF16_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_gradient_flows_to_the_input_of_a_frozen_flow(rng):
    """The stage-3a loss differentiates the part flows' NLL with respect to
    their input while the flows stay frozen."""
    flow = _jax_flow(22, seed=7)
    port = _port(flow).requires_grad_(False)
    x = _poses(rng, 8, 22)
    xt = torch.from_numpy(x).requires_grad_(True)
    tflows.nll(*tflows.forward(port, xt)).mean().backward()
    want = jax.grad(lambda a: jflows.nll(*jflows.forward(flow, a)).mean())(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    assert all(p.grad is None for p in port.parameters())


def test_load_flow_pt_of_a_jax_export(rng, tmp_path):
    flow = _jax_flow(34, seed=9)
    path = tmp_path / "full_flow.pt"
    jckpt.save_pt(path, jckpt.flow_to_torch(flow))
    x = _poses(rng, 6, 34)
    with torch.no_grad():
        z, ld = tflows.forward(load_flow_pt(path), torch.from_numpy(x))
    jz, jld = jflows.forward(flow, jnp.asarray(x))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **F32_TOL)
    np.testing.assert_allclose(ld.numpy(), np.asarray(jld), **F32_TOL)


def test_save_flow_pt_loads_in_the_jax_package(tmp_path):
    port = tflows.Flow(22, 3, HID, generator=torch.Generator().manual_seed(4))
    path = tmp_path / "flow_left.pt"
    save_flow_pt(port, path)
    flow = jckpt.load_flow_pt(path, n_blocks=3)
    x = np.full((2, 22), 0.05, np.float32)
    with torch.no_grad():
        z, _ = tflows.forward(port, torch.from_numpy(x))
    np.testing.assert_allclose(z.numpy(), np.asarray(jflows.forward(flow, jnp.asarray(x))[0]),
                               **F32_TOL)


def test_state_dict_is_the_freia_layout():
    port = tflows.Flow(22, 2, HID)
    want = set(jckpt.flow_to_torch(_jax_flow(22, n_blocks=2)))
    assert set(port.state_dict()) == want
    assert port.module_list[0].global_scale.shape == (1, 22)


def test_random_mixing_matrix_is_a_rotation():
    w = tflows.Flow(34, 1, HID, generator=torch.Generator().manual_seed(0)).module_list[0].w_perm
    torch.testing.assert_close(w @ w.T, torch.eye(34), rtol=0, atol=1e-5)
    assert abs(float(torch.linalg.det(w)) - 1.0) < 1e-4
