"""links_tpu_torch.metrics against links_tpu.metrics on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_suite import one_cpu_thread  # noqa: F401  (an autouse fixture)
from links_tpu import metrics as jmetrics
from links_tpu_torch import metrics as tmetrics


def _pair(rng, n):
    """Reference poses in mm and noisy, rotated, scaled predictions of them."""
    ref = rng.normal(size=(n, 3, 17)).astype(np.float32) * 300.0
    ang = rng.uniform(-np.pi, np.pi, size=n)
    rot = np.zeros((n, 3, 3), np.float32)
    rot[:, 0, 0] = rot[:, 2, 2] = np.cos(ang)
    rot[:, 0, 2], rot[:, 2, 0] = np.sin(ang), -np.sin(ang)
    rot[:, 1, 1] = 1.0
    pred = (rot @ ref) * 0.01 + rng.normal(size=ref.shape).astype(np.float32) * 0.3
    pred[: n // 4, 0] *= -1.0  # mirrored poses: reflection='best' may reflect
    return ref.reshape(n, 51), pred.reshape(n, 51)


@pytest.mark.parametrize("n", [1, 33])
def test_pa_mpjpe(rng, n):
    ref, pred = _pair(rng, n)
    got = tmetrics.pa_mpjpe(torch.from_numpy(ref), torch.from_numpy(pred))
    want = jmetrics.pa_mpjpe(jnp.asarray(ref), jnp.asarray(pred))
    assert tuple(got.shape) == (n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-3)


def test_procrustes_align(rng):
    ref, pred = _pair(rng, 9)
    got = tmetrics.procrustes_align(torch.from_numpy(ref), torch.from_numpy(pred))
    want = jmetrics.procrustes_align(jnp.asarray(ref), jnp.asarray(pred))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("use_scaling", [True, False])
def test_n_mpjpe(rng, use_scaling):
    ref, pred = _pair(rng, 21)
    got = tmetrics.n_mpjpe(torch.from_numpy(ref), torch.from_numpy(pred), use_scaling)
    want = jmetrics.n_mpjpe(jnp.asarray(ref), jnp.asarray(pred), use_scaling)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_depth_tilt_score(rng):
    _, pred = _pair(rng, 15)
    got = tmetrics.depth_tilt_score(torch.from_numpy(pred))
    want = jmetrics.depth_tilt_score(jnp.asarray(pred))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-7)
