"""links_tpu_torch core, data and NN primitives against links_tpu on the CPU.

Inputs are made with numpy from a seed and handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from links_tpu.core import geometry as jgeo
from links_tpu.core import nn as jnn
from links_tpu.core import skeleton as jsk
from links_tpu.data import datasets as jdata
from links_tpu.data import synthetic as jsyn
from links_tpu_torch.core import geometry as tgeo
from links_tpu_torch.core import nn as tnn
from links_tpu_torch.core import skeleton as tsk
from links_tpu_torch.data import datasets as tdata
from links_tpu_torch.data import synthetic as tsyn


def _poses(rng, n, width=34):
    return rng.normal(size=(n, width)).astype(np.float32)


@pytest.mark.parametrize("name", [
    "NUM_JOINTS", "RIGHT_IDX", "LEFT_IDX", "RIGHT_IDX_V2", "LEFT_IDX_V2", "LEG_IDX",
    "TORSO_IDX", "_COMBINE_LR_COL", "_COMBINE_FROM_RIGHT_LEFT",
    "_COMBINE_FROM_RIGHT_RIGHT", "_OCCLUDED_COMBINE_RIGHT", "_OCCLUDED_COMBINE_LEFT",
    "BONE_MAP_ALL", "BONE_MAP_LEGS", "BONE_MAP_TORSO", "BONE_MAP_LEFT_RIGHT",
    "BONE_RELATIONS_MEAN_H36M", "BONE_RELATIONS_MEAN_MPI_VNECT_INTERESTING",
])
def test_skeleton_constants(name):
    np.testing.assert_array_equal(getattr(tsk, name), getattr(jsk, name))


@pytest.mark.parametrize("split", ["split_data_left_right", "split_data_legs_torso"])
def test_splits(rng, split):
    p = _poses(rng, 9)
    got = getattr(tsk, split)(torch.from_numpy(p))
    want = getattr(jsk, split)(jnp.asarray(p))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("choice", ["left", "right"])
def test_combine_left_right_pred_1d(rng, choice):
    left, right = _poses(rng, 7, 11), _poses(rng, 7, 11)
    got = tsk.combine_left_right_pred_1d(torch.from_numpy(left), torch.from_numpy(right), choice)
    want = jsk.combine_left_right_pred_1d(jnp.asarray(left), jnp.asarray(right), choice)
    assert tuple(got.shape) == (7, 1, 17)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", [
    "H36M_TEST_SCALE_INTERESTING", "H36M_TEST_SCALE_ALL", "H36M_TRAIN_GT_SCALE",
    "MPI_TEST_SCALE_CHEST", "MPI_TEST_SCALE_VNECT", "H36M_TEST_SCALE_TEMPORAL",
])
def test_test_scales(name):
    assert getattr(tgeo, name) == getattr(jgeo, name)


@pytest.mark.parametrize("fn,kwargs", [
    ("normalize_head_test", {}),
    ("normalize_head_test", {"scale": 123.5}),
    ("normalize_head_test_mpi_chest", {}),
    ("normalize_head_test_mpi_vnect", {}),
    ("normalize_head_test_temporal", {}),
])
def test_test_normalizers(rng, fn, kwargs):
    p = _poses(rng, 11) * 300.0
    got = getattr(tgeo, fn)(torch.from_numpy(p), **kwargs)
    want = getattr(jgeo, fn)(jnp.asarray(p), **kwargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


def test_normalize_maxabs(rng):
    p = rng.normal(size=(6, 17, 2)).astype(np.float32) * 300.0
    got = tgeo.normalize_maxabs(torch.from_numpy(p))
    want = jgeo.normalize_maxabs(jnp.asarray(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("policy", ["F32", "BF16"])
def test_dense_follows_the_policy(rng, policy):
    """bf16 inputs, f32 accumulation and output: equal to JAX's
    preferred_element_type=f32 dot up to summation order."""
    x = _poses(rng, 5, 48)
    w = rng.normal(size=(48, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    got = tnn.dense(torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(b),
                    getattr(tnn, policy))
    want = jnn.dense({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
                     getattr(jnn, policy))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_leaky_relu(rng):
    x = _poses(rng, 4, 64)
    np.testing.assert_array_equal(tnn.leaky_relu(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnn.leaky_relu(jnp.asarray(x))))


def test_linear_init_is_torch_default_and_seeded():
    a = tnn.Linear(100, 30, generator=torch.Generator().manual_seed(3))
    b = tnn.Linear(100, 30, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    assert a.weight.shape == (30, 100)
    bound = 1.0 / np.sqrt(100)
    assert float(a.weight.detach().abs().max()) <= bound
    assert float(a.bias.detach().abs().max()) <= bound


def test_generate_poses_matches_jax_package():
    got = tsyn.generate_poses(64, seed=5)
    want = jsyn.generate_poses(64, seed=5)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def pickle_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "synthetic.pkl"
    tsyn.write_synthetic_pickle(path, n_per_subject=12, seed=1, n_test_per_subject=40)
    return path


@pytest.mark.parametrize("loader,subjects,kwargs", [
    ("load_h36m", ("S9", "S11"), {"normalize_func": "normalize_head_test"}),
    ("load_h36m", ("S1", "S5"), {}),
    ("load_h36m", ("S9", "S11"), {"normalize_func": "normalize_head_test",
                                  "use_gt": False, "complete_only": True}),
    ("load_h36m", ("S9",), {"use_gt": False}),
    ("load_mpi_inf_3dhp", ("S7", "S8"), {"normalize_func": "normalize_head_test_mpi_vnect"}),
])
def test_dataset_loaders(pickle_path, loader, subjects, kwargs):
    norm = kwargs.pop("normalize_func", None)
    got = getattr(tdata, loader)(pickle_path, subjects,
                                 normalize_func=norm and getattr(tgeo, norm), **kwargs)
    want = getattr(jdata, loader)(pickle_path, subjects,
                                  normalize_func=norm and getattr(jgeo, norm), **kwargs)
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(got.poses_2d.numpy(), np.asarray(want.poses_2d),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got.poses_3d.numpy(), np.asarray(want.poses_3d))


def test_test_split_subjects():
    assert tdata.TEST_SUBJECTS == jdata.TEST_SUBJECTS
    assert tdata.TRAIN_SUBJECTS == jdata.TRAIN_SUBJECTS
    assert tdata.MPI_SUBJECTS == jdata.MPI_SUBJECTS
