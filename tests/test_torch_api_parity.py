"""The API-parity pieces of links_tpu_torch against links_tpu on the CPU,
none of which an entry point runs: LayerNorm and dropout, the residual
block, lifter and completer with them (and which blocks call the
residual-block kernel's wrapper), the pose discriminator, their ``.pt``
files with the ``bn1``/``bn2`` LayerNorm keys both ways, the skeleton and
geometry helpers, the PCA fits, the h36m-fetch preprocessing and its CLI,
and the profiling helpers. Both packages get the same weights
(``*_params_from_jax``) and the same draws (the port takes as tensors what
the JAX package draws from its key)."""

import contextlib
import io
import json
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_suite import one_cpu_thread  # noqa: F401  (an autouse fixture)
from links_tpu import ckpt as jckpt
from links_tpu import models as jmodels
from links_tpu.ckpt import torch_io as jtorch_io
from links_tpu.cli import preprocess as jpreprocess_cli
from links_tpu.core import geometry as jgeo
from links_tpu.core import nn as jnn
from links_tpu.core import skeleton as jskel
from links_tpu.data import datasets as jdatasets
from links_tpu.data import preprocess as jpreprocess
from links_tpu.train import profiling as jprof
from links_tpu_torch.ckpt import torch_io
from links_tpu_torch.cli import preprocess as tpreprocess_cli
from links_tpu_torch.core import geometry as tgeo
from links_tpu_torch.core import nn as tnn
from links_tpu_torch.core import skeleton as tskel
from links_tpu_torch.data import datasets as tdatasets
from links_tpu_torch.data import preprocess as tpreprocess
from links_tpu_torch.models import lifters as tlifters
from links_tpu_torch.models.completers import Completer
from links_tpu_torch.models.lifters import Lifter, PoseDiscriminator, ResBlock
from links_tpu_torch.train import profiling as tprof
from test_torch_occlusion import BF16_TOL, F32_TOL
from test_torch_train_step import _poses

HID = 128
BATCH = 16
RATE = 0.25
TOL = {"F32": F32_TOL, "BF16": BF16_TOL}
# bf16 with LayerNorm: the two packages reduce a LayerNorm's mean and
# variance in different orders, and its O(1) outputs are rounded to bf16 for
# the next product, so a last-bit difference flips a rounding (one bf16 unit,
# 2**-8 relative) more often than in a plain chain, and later blocks carry it
# on. Held by the relative L2 error of the output, within BF16_LN_REL: a
# quarter of what the bf16 policy itself moves the output from f32 (~4e-3 at
# hidden 128); up to 6.3e-4 observed over 6 seeds.
BF16_LN_REL = 1e-3


def _x(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _with_random_layernorms(tree, seed: int):
    """``tree`` with every LayerNorm's scale and bias drawn away from their
    defaults, so that a dropped or swapped LayerNorm shows."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict) and set(t) == {"scale", "bias"}:
            return {k: (1.0 if k == "scale" else 0.0)
                    + 0.3 * rng.normal(size=v.shape).astype(np.float32) for k, v in t.items()}
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return np.asarray(t)

    return walk(tree)


def _block_tree(use_layernorm: bool, seed: int = 0):
    return _with_random_layernorms(
        jmodels.init_res_block(jax.random.PRNGKey(seed), HID, use_layernorm=use_layernorm), seed)


def _port_block(tree, **kw) -> ResBlock:
    block = ResBlock(HID, use_layernorm="ln1" in tree, **kw)
    sd = torch_io._params_from_jax({"b": tree}, (), ("b",))
    block.load_state_dict({k[2:]: v for k, v in sd.items()})
    return block


@pytest.fixture
def res_block_calls(monkeypatch):
    """The calls that reach the residual-block kernel's wrapper from the
    models (the kernel on the card, its plain version here)."""
    calls = []
    real = tlifters.res_block

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(tlifters, "res_block", counted)
    return calls


def test_layernorm_matches_jax():
    x = _x((BATCH, HID)) * 3.0 + 1.0
    tree = _with_random_layernorms(jnn.init_layernorm(HID), 1)
    want = np.asarray(jnn.layernorm(tree, jnp.asarray(x)))
    got = tnn.layernorm(torch.from_numpy(x), torch.from_numpy(tree["scale"]),
                        torch.from_numpy(tree["bias"]))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    plain = np.asarray(jnn.layernorm(jnn.init_layernorm(HID), jnp.asarray(x)))
    np.testing.assert_allclose(tnn.LayerNorm(HID)(torch.from_numpy(x)).detach().numpy(), plain,
                               **F32_TOL)


def test_dropout_given_jax_mask():
    x = _x((BATCH, HID))
    key = jax.random.PRNGKey(4)
    keep = np.array(jax.random.bernoulli(key, 1.0 - RATE, x.shape))
    want = np.asarray(jnn.dropout(key, jnp.asarray(x), RATE, False))
    got = tnn.dropout(torch.from_numpy(x), RATE, keep=torch.from_numpy(keep))
    np.testing.assert_array_equal(got.numpy(), want)


def test_dropout_from_a_generator():
    """The generator draws each keep with probability 1 - rate, repeatably;
    rate 0 is the identity; no mask and no generator is an error."""
    x = torch.from_numpy(_x((256, HID)))
    got = tnn.dropout(x, RATE, generator=torch.Generator().manual_seed(3))
    again = tnn.dropout(x, RATE, generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, again)
    kept = got != 0
    assert abs(float(kept.float().mean()) - (1 - RATE)) < 0.01
    assert torch.equal(got[kept], x[kept] / (1 - RATE))
    assert tnn.dropout(x, 0.0) is x
    with pytest.raises(ValueError, match="keep-mask or a generator"):
        tnn.dropout(x, RATE)


def _assert_matches(got, want, policy: str, layernorm: bool):
    got, want = got.detach().numpy(), np.asarray(want)
    if policy == "BF16" and layernorm:
        assert np.linalg.norm(got - want) <= BF16_LN_REL * np.linalg.norm(want)
    else:
        np.testing.assert_allclose(got, want, **TOL[policy])


def _jax_dropout_masks(key, shape):
    """The two keep-masks res_block_apply draws from ``key``."""
    key, sub = jax.random.split(key)
    return tuple(torch.from_numpy(np.array(jax.random.bernoulli(k, 1.0 - RATE, shape)))
                 for k in (sub, key))


@pytest.mark.parametrize("policy", ["F32", "BF16"])
@pytest.mark.parametrize("layernorm,dropout", [(True, False), (False, True), (True, True)])
def test_res_block_matches_jax(policy, layernorm, dropout, res_block_calls):
    """LayerNorm and dropout blocks against res_block_apply (its dropout
    masks given), composing plain ops: no call reaches the kernel's
    wrapper."""
    tree = _block_tree(layernorm)
    x = _x((BATCH, HID), seed=1)
    key = jax.random.PRNGKey(9)
    want = jmodels.res_block_apply(tree, jnp.asarray(x), getattr(jnn, policy),
                                   dropout_rate=RATE if dropout else 0.0, key=key,
                                   deterministic=not dropout)
    block = _port_block(tree, dropout_rate=RATE if dropout else 0.0)
    masks = _jax_dropout_masks(key, x.shape) if dropout else None
    got = block(torch.from_numpy(x), getattr(tnn, policy), masks)
    _assert_matches(got, want, policy, layernorm)
    assert res_block_calls == []


def test_which_blocks_call_the_kernel(res_block_calls):
    """A block without LayerNorm calls the kernel's wrapper, with dropout
    built in and no masks given too (deterministic); LayerNorm, or dropout
    given masks or a generator, composes plain ops."""
    x = torch.from_numpy(_x((BATCH, HID)))
    plain, dropping = _port_block(_block_tree(False)), _port_block(_block_tree(False),
                                                                   dropout_rate=RATE)
    plain(x)
    dropping(x)
    assert len(res_block_calls) == 2
    _port_block(_block_tree(True))(x)
    dropping(x, dropout_masks=torch.Generator().manual_seed(0))
    dropping(x, dropout_masks=(torch.ones_like(x, dtype=torch.bool),) * 2)
    assert len(res_block_calls) == 2
    # all-kept masks drop nothing: the block then computes the plain block
    # scaled on its activations
    assert torch.equal(plain(x), dropping(x))


@pytest.mark.parametrize("policy", ["F32", "BF16"])
@pytest.mark.parametrize("joints", [11, 7])
def test_layernorm_lifter_matches_jax(policy, joints, res_block_calls):
    tree = _with_random_layernorms(
        jmodels.init_lifter(jax.random.PRNGKey(joints), joints, use_layernorm=True, hidden=HID),
        joints)
    x = _x((BATCH, 2 * joints), seed=2)
    want = jmodels.lifter_apply(tree, jnp.asarray(x), getattr(jnn, policy))
    lifter = torch_io.lifter_from_state_dict(torch_io.lifter_params_from_jax(tree),
                                             use_layernorm=True)
    assert isinstance(lifter, Lifter) and lifter.res_angle3.use_layernorm
    got = lifter(torch.from_numpy(x), getattr(tnn, policy))
    for g, w in zip(got, want):
        _assert_matches(g, w, policy, True)
    assert res_block_calls == []


@pytest.mark.parametrize("policy", ["F32", "BF16"])
def test_layernorm_completer_matches_jax(policy):
    tree = _with_random_layernorms(
        jmodels.init_completer(jax.random.PRNGKey(5), 7, 10, use_layernorm=True, hidden=HID), 5)
    x = _x((BATCH, 21), seed=3)
    want = jmodels.completer_apply(tree, jnp.asarray(x), getattr(jnn, policy))
    completer = torch_io.completer_from_state_dict(torch_io.completer_params_from_jax(tree),
                                                   use_layernorm=True)
    _assert_matches(completer(torch.from_numpy(x), getattr(tnn, policy)), want, policy, True)


def _discriminator_tree(use_layernorm: bool):
    return _with_random_layernorms(jmodels.init_pose_discriminator(
        jax.random.PRNGKey(6), 16, use_layernorm=use_layernorm, hidden=HID), 6)


@pytest.mark.parametrize("policy", ["F32", "BF16"])
@pytest.mark.parametrize("use_layernorm", [False, True])
def test_pose_discriminator_matches_jax(policy, use_layernorm, res_block_calls):
    """upscale, res_common, downscale to one score; res_pose1/2 built and
    not run: one call of the kernel's wrapper per forward without
    LayerNorm, none with it."""
    tree = _discriminator_tree(use_layernorm)
    x = _x((BATCH, 32), seed=4)
    want = jmodels.pose_discriminator_apply(tree, jnp.asarray(x), getattr(jnn, policy))
    disc = torch_io.pose_discriminator_from_state_dict(
        torch_io.pose_discriminator_params_from_jax(tree), use_layernorm=use_layernorm)
    assert isinstance(disc, PoseDiscriminator)
    assert {"res_pose1.l1.weight", "res_pose2.l2.bias"} <= set(disc.state_dict())
    got = disc(torch.from_numpy(x), getattr(tnn, policy))
    assert got.shape == (BATCH, 1)
    _assert_matches(got, want, policy, use_layernorm)
    assert len(res_block_calls) == (0 if use_layernorm else 1)


def _jax_file(tmp_path, name, state_dict) -> str:
    path = tmp_path / name
    jckpt.save_pt(path, state_dict)
    return str(path)


def test_layernorm_lifter_pt_both_ways(tmp_path):
    """A LayerNorm lifter's .pt written by links_tpu loads into the port
    with ``use_layernorm`` (and without it, its bn* keys dropped as JAX
    drops them); the port's file carries the JAX file's keys and loads into
    links_tpu with its LayerNorms."""
    tree = _with_random_layernorms(
        jmodels.init_lifter(jax.random.PRNGKey(1), 11, use_layernorm=True, hidden=HID), 1)
    x = _x((BATCH, 22), seed=5)
    jfile = _jax_file(tmp_path, "j.pt", jckpt.lifter_to_torch(tree))
    for use_ln in (True, False):
        want = jmodels.lifter_apply(jckpt.load_lifter_pt(jfile, use_layernorm=use_ln),
                                    jnp.asarray(x))
        got = torch_io.load_lifter_pt(jfile, use_layernorm=use_ln)(torch.from_numpy(x))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **F32_TOL)
    lifter = torch_io.load_lifter_pt(jfile, use_layernorm=True)
    torch_io.save_lifter_pt(lifter, tmp_path / "t.pt")
    saved = torch.load(tmp_path / "t.pt", weights_only=True)
    assert set(saved) == set(jckpt.lifter_to_torch(tree))
    back = jckpt.load_lifter_pt(str(tmp_path / "t.pt"), use_layernorm=True)
    for g, w in zip(lifter(torch.from_numpy(x)), jmodels.lifter_apply(back, jnp.asarray(x))):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **F32_TOL)
    # a lifter without LayerNorms writes the defaults, as links_tpu does
    plain = torch_io.load_lifter_pt(jfile)
    torch_io.save_lifter_pt(plain, tmp_path / "p.pt")
    np.testing.assert_array_equal(torch.load(tmp_path / "p.pt")["res_pose2.bn1.weight"],
                                  np.ones(HID, np.float32))


def test_layernorm_completer_pt_both_ways(tmp_path):
    tree = _with_random_layernorms(
        jmodels.init_completer(jax.random.PRNGKey(2), 14, 3, use_layernorm=True, hidden=HID), 2)
    x = _x((BATCH, 42), seed=6)
    jfile = _jax_file(tmp_path, "j.pt", jckpt.completer_to_torch(tree))
    completer = torch_io.load_completer_pt(jfile, use_layernorm=True)
    assert isinstance(completer, Completer)
    want = jmodels.completer_apply(tree, jnp.asarray(x))
    np.testing.assert_allclose(completer(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), **F32_TOL)
    torch_io.save_completer_pt(completer, tmp_path / "t.pt")
    assert set(torch.load(tmp_path / "t.pt")) == set(jckpt.completer_to_torch(tree))
    back = jckpt.load_completer_pt(str(tmp_path / "t.pt"), use_layernorm=True)
    np.testing.assert_allclose(np.asarray(jmodels.completer_apply(back, jnp.asarray(x))),
                               np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("use_layernorm", [False, True])
def test_pose_discriminator_pt_round_trip(tmp_path, use_layernorm):
    """The port's discriminator file is the reference layout of its three
    blocks (links_tpu's block reader takes it) and loads back bitwise."""
    tree = _discriminator_tree(use_layernorm)
    disc = torch_io.pose_discriminator_from_state_dict(
        torch_io.pose_discriminator_params_from_jax(tree), use_layernorm=use_layernorm)
    torch_io.save_pose_discriminator_pt(disc, tmp_path / "d.pt")
    saved = torch.load(tmp_path / "d.pt", weights_only=True)
    blocks = ("res_common", "res_pose1", "res_pose2")
    assert set(saved) == ({f"{p}.{k}" for p in ("upscale", "downscale")
                           for k in ("weight", "bias")}
                          | {f"{b}.{m}.{k}" for b in blocks for m in ("l1", "l2", "bn1", "bn2")
                             for k in ("weight", "bias")})
    sd = jtorch_io._to_np(saved)
    read = {"upscale": jtorch_io._linear_from_torch(sd, "upscale"),
            "downscale": jtorch_io._linear_from_torch(sd, "downscale"),
            **{b: jtorch_io._res_block_from_torch(sd, b, use_layernorm) for b in blocks}}
    x = _x((BATCH, 32), seed=7)
    want = jmodels.pose_discriminator_apply(read, jnp.asarray(x))
    back = torch_io.load_pose_discriminator_pt(tmp_path / "d.pt", use_layernorm=use_layernorm)
    got = back(torch.from_numpy(x))
    assert torch.equal(got, disc(torch.from_numpy(x)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32_TOL)


SPLITS = {
    "split_data_left_right_v2": 34, "temporal_split_data_left_right": 68,
}
BONES = {"get_bone_lengths_legs": 21, "get_bone_lengths_torso": 30,
         "get_bone_lengths_left_right": 33, "get_bone_lengths_all": 51}


@pytest.mark.parametrize("name", list(SPLITS))
def test_splits_match_jax(name):
    x = _x((BATCH, SPLITS[name]), seed=8)
    got = getattr(tskel, name)(torch.from_numpy(x))
    want = getattr(jskel, name)(jnp.asarray(x))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("choice", ["left", "right"])
@pytest.mark.parametrize("coords", [2, 3])
def test_combine_left_right_matches_jax(choice, coords):
    name = f"combine_left_right_pred_{coords}d"
    left, right = _x((BATCH, 11 * coords), seed=9), _x((BATCH, 11 * coords), seed=10)
    got = getattr(tskel, name)(torch.from_numpy(left), torch.from_numpy(right), choice)
    want = getattr(jskel, name)(jnp.asarray(left), jnp.asarray(right), choice)
    assert got.shape == (BATCH, 17 * coords)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", list(BONES))
def test_bone_lengths_match_jax(name):
    x = _x((BATCH, BONES[name]), seed=11)
    got = getattr(tskel, name)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jskel, name)(jnp.asarray(x))),
                               **F32_TOL)


@pytest.mark.parametrize("convention", ["XYZ", "ZYX", "YXZ", "XZY", "ZXY", "YZX", "XYX"])
def test_euler_angles_to_matrix_matches_jax(convention):
    a = _x((BATCH, 3), seed=12)
    got = tgeo.euler_angles_to_matrix(torch.from_numpy(a), convention)
    want = jgeo.euler_angles_to_matrix(jnp.asarray(a), convention)
    assert got.shape == (BATCH, 3, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("bad", [("XXY", 3), ("XY", 3), ("XYZ", 2), ("XYW", 3)])
def test_euler_angles_to_matrix_refuses(bad):
    convention, n = bad
    with pytest.raises(ValueError):
        tgeo.euler_angles_to_matrix(torch.zeros(2, n), convention)
    with pytest.raises(ValueError):
        jgeo.euler_angles_to_matrix(jnp.zeros((2, n)), convention)


@pytest.mark.parametrize("part,width", [("legs", 21), ("torso", 30), ("left_right", 33), ("", 51)])
def test_perspective_projection_matches_jax(part, width):
    name = "perspective_projection" + (f"_{part}" if part else "")
    x = _x((BATCH, width), seed=13)
    x[:, 2 * width // 3:] = np.abs(x[:, 2 * width // 3:]) + 5.0  # depths
    got = getattr(tgeo, name)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jgeo, name)(jnp.asarray(x))),
                               **F32_TOL)


def test_interpolate_gaussian_batch_matches_jax():
    z = _x((BATCH, 34), seed=14)
    for t in (0.0, 0.3, 1.0):
        got = tgeo.interpolate_gaussian_batch(torch.from_numpy(z), t)
        want = jgeo.interpolate_gaussian_batch(jnp.asarray(z), t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    with pytest.raises(ValueError, match="even"):
        tgeo.interpolate_gaussian_batch(torch.from_numpy(z[:3]), 0.5)


@pytest.mark.parametrize("limbs", [("left_leg",), ("right_arm", "left_leg"),
                                   ("left_leg", "right_leg", "left_arm", "right_arm")])
def test_occlusion_create_matches_jax(limbs):
    """The limb and count links_tpu draws from its key, given as tensors,
    zero the same keypoints; drawn from a generator, each pose loses 1-3
    trailing joints of one of ``limbs``, repeatably."""
    x = _x((64, 34), seed=15)
    key = jax.random.PRNGKey(16)
    k1, k2 = jax.random.split(key)
    limb = torch.from_numpy(np.asarray(jax.random.randint(k1, (64,), 0, len(limbs))))
    count = torch.from_numpy(np.asarray(jax.random.randint(k2, (64,), 0, 3)))
    want = jgeo.occlusion_create(key, jnp.asarray(x), limbs)
    got = tgeo.occlusion_create(torch.from_numpy(x), limbs, limb=limb, count=count)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    drawn = tgeo.occlusion_create(torch.from_numpy(x), limbs,
                                  generator=torch.Generator().manual_seed(1))
    again = tgeo.occlusion_create(torch.from_numpy(x), limbs,
                                  generator=torch.Generator().manual_seed(1))
    assert torch.equal(drawn, again)
    allowed = {tuple(j) for name in limbs for j in jgeo._OCC_SETS[name]}
    zeroed = (drawn.reshape(-1, 2, 17) == 0).all(dim=1)
    for row in zeroed:
        assert tuple(np.flatnonzero(row.numpy())) in allowed


def test_pca_fits_match_jax(monkeypatch):
    poses = _poses(64, seed=17)
    got = tdatasets.fit_part_pca(torch.from_numpy(poses))
    want = jdatasets.fit_part_pca(jnp.asarray(poses))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.components_, w.components_)
        np.testing.assert_array_equal(g.explained_variance_, w.explained_variance_)
    full = tdatasets.fit_full_pose_pca(torch.from_numpy(poses))
    np.testing.assert_array_equal(full.components_,
                                  jdatasets.fit_full_pose_pca(poses).components_)
    monkeypatch.setitem(sys.modules, "sklearn.decomposition", None)
    assert tdatasets.fit_part_pca(poses) is None
    assert tdatasets.fit_full_pose_pca(poses) is None


def _h5_tree(root, seed: int, frames: dict):
    """A small h36m-fetch tree: root/<subject>/<action>/annot.h5 with
    32-joint 2d, 3d and 3d-univ pose buffers."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(seed)
    for (subject, action), n in frames.items():
        d = root / subject / action
        d.mkdir(parents=True)
        with h5py.File(d / "annot.h5", "w") as f:
            g = f.create_group("pose")
            g["2d"] = rng.normal(size=(n, 32, 2))
            g["3d"] = rng.normal(size=(n, 32, 3))
            g["3d-univ"] = rng.normal(size=(n, 32, 3))


FRAMES = {("S1", "Walking"): 5, ("S1", "Eating"): 3, ("S9", "Walking"): 4, ("S9", "Sitting"): 2}


def test_preprocess_matches_jax(tmp_path):
    """The same walk, subset, order and pickle as links_tpu's."""
    _h5_tree(tmp_path / "processed", 0, FRAMES)
    (tmp_path / "processed" / "notes.txt").write_text("not a subject")
    got = tpreprocess.preprocess_h36m_fetch(str(tmp_path / "processed"), str(tmp_path / "t.pkl"))
    want = jpreprocess.preprocess_h36m_fetch(str(tmp_path / "processed"),
                                             str(tmp_path / "j.pkl"))
    assert tpreprocess.H36M_17_JOINTS == jpreprocess.H36M_17_JOINTS
    with open(tmp_path / "t.pkl", "rb") as f:
        written = pickle.load(f)
    assert list(got) == list(want) == list(written) == ["S1", "S9"]
    for s in want:
        assert list(got[s]) == list(want[s])
        for k in want[s]:
            np.testing.assert_array_equal(got[s][k], want[s][k])
            np.testing.assert_array_equal(written[s][k], want[s][k])
    assert got["S1"]["poses_2d"].shape == (8, 17, 2)
    ds = tdatasets.load_h36m(tmp_path / "t.pkl", subjects=("S9",), normalize_func=None)
    assert len(ds) == 6


def test_preprocess_cli_matches_jax(tmp_path):
    """The port's CLI takes the JAX CLI's flags and prints its lines (the
    last with the port's tag)."""
    _h5_tree(tmp_path / "processed", 1, {("S5", "Posing"): 4, ("S11", "Waiting"): 3})
    outs = {}
    for name, main in (("jax", jpreprocess_cli.main), ("port", tpreprocess_cli.main)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["--h36m-dir", str(tmp_path / "processed"),
                  "--out", str(tmp_path / f"{name}.pkl")])
        outs[name] = buf.getvalue().splitlines()
    assert outs["port"][:-1] == outs["jax"][:-1] == ["S11: 3 frames", "S5: 4 frames"]
    assert outs["jax"][-1] == f"[links_tpu] wrote {tmp_path / 'jax.pkl'}"
    assert outs["port"][-1] == f"[links_tpu_torch] wrote {tmp_path / 'port.pkl'}"
    assert (tmp_path / "port.pkl").read_bytes() == (tmp_path / "jax.pkl").read_bytes()


def test_preprocess_cli_refuses_without_h5py(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "h5py", None)
    out = tmp_path / "o.pkl"
    with pytest.raises(SystemExit) as exc:
        tpreprocess_cli.main(["--h36m-dir", str(tmp_path), "--out", str(out)])
    assert exc.value.code == 2
    assert "h5py" in capsys.readouterr().err
    assert not out.exists()


class _Clock:
    """A stand-in for the ``time`` module whose perf_counter reads a fixed
    sequence."""

    def __init__(self, readings):
        self._readings = iter(readings)

    def perf_counter(self):
        return next(self._readings)


def test_step_time_matches_jax(monkeypatch):
    """The median of the timed calls after the warm-up, as links_tpu's; the
    port's waits on its first output tensor."""
    readings = [0.0, 1.0, 1.0, 3.0] + [float(v) for v in
                                       np.cumsum([0, 0.5, 0, 0.2, 0, 0.9, 0, 0.4, 0, 0.7])]
    monkeypatch.setattr(tprof, "time", _Clock(readings))
    got = tprof.step_time(lambda a: (a * 2, "aux"), torch.ones(3), iters=5, warmup=2)
    monkeypatch.setattr(jprof, "time", _Clock(readings))
    want = jprof.step_time(lambda a: (a * 2, "aux"), jnp.ones(3), iters=5, warmup=2)
    assert got == want == pytest.approx(0.5)


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "prof")) as log_dir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert log_dir == str(tmp_path / "prof")
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
