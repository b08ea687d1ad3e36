"""Data parallelism of links_tpu_torch (train/parallel.py) on the CPU: 2 and 4
gloo ranks against one process on the same global batch and the same draws,
for one step of each stage (1, 2, 3a, 3b, 4) under both policies, and one
rank bit for bit as one process; 3a on 2
ranks against the JAX package's ``dp_jit_step`` on a 2-device mesh; the
global elevation statistics; ranks bitwise equal after three steps;
validation inside a group; and the layouts of the sharded draws and batches.

The JAX package's DP step is the one-device step on the global batch
(tests/test_parallel.py), so that is the bar: N ranks, each on its rows of
the batch and of the draws, must compute what one process computes on all
of them. The models are small (lifters and completers at hidden 128, flows
of 2 blocks at hidden 64); the ranks run ``tests/_torch_dp.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dp
from _torch_suite import module_scratch, one_cpu_thread  # noqa: F401  (fixtures)
from links_tpu import flows as jflows
from links_tpu import models as jmodels
from links_tpu.config import LifterTrainConfig as JLifterTrainConfig
from links_tpu.core import geometry as jgeo
from links_tpu.objectives import lifter as jlifter_obj
from links_tpu.train import build_left_right_step as j_build_step
from links_tpu.train import make_optimizer
from links_tpu.train import parallel as jparallel
from links_tpu.train.steps import init_state
from links_tpu_torch.ckpt.torch_io import (
    flow_from_state_dict,
    flow_params_from_jax,
    lifter_from_state_dict,
    lifter_params_from_jax,
)
from links_tpu_torch.config import (
    FlowTrainConfig,
    LifterTrainConfig,
    OcclusionTrainConfig,
    OptimConfig,
    PartFlowTrainConfig,
)
from links_tpu_torch.core import geometry as tgeo
from links_tpu_torch.core.skeleton import split_data_left_right
from links_tpu_torch.data.native_loader import PackedDataset, pack_dataset
from links_tpu_torch.data.synthetic import generate_poses
from links_tpu_torch.flows import Flow
from links_tpu_torch.models.completers import Completers
from links_tpu_torch.models.lifters import (
    LEG_JOINTS,
    TORSO_JOINTS,
    LegTorsoLifter,
    Lifter,
    StackedLifter,
)
from links_tpu_torch.objectives.flow_nll import PartFlows
from links_tpu_torch.train import parallel, steps
from links_tpu_torch.train.feed import PackedFeed
from links_tpu_torch.train.loop import tensor_batches

BATCH = 16   # global: 8 rows a rank at W = 2, 4 at W = 4 (even: the lifters pair rows)
HID = 128
STAGES = ("1", "2", "3a", "3b", "4")
POLICIES = ("f32", "bf16")
WORLDS = (2, 4)
INPUT_NOISE = 0.05  # stage 4 draws its input noise too, so its layout is held
LR = OptimConfig().learning_rate
# Ranks against one process. f32: the ranks sum each mean in parts, and the
# gradients once more over the ranks, so values move by a few ulp: loss
# terms within rtol = atol = 1e-5, each gradient within a relative L2 error
# of 1e-5, parameters after Adam within 1e-5 (observed on the CPU, at one
# thread and at eight, at most 1.8e-7 relative on a loss term, 3.0e-6 on a
# gradient and 4.3e-6 on a parameter, both 3b's).
F32 = {"aux": {"rtol": 1e-5, "atol": 1e-5}, "grad": 1e-5, "param": 1e-5}
# bf16: loss terms within tests/test_torch_lifters.py's BF16_TOL (observed
# 2.2e-5 relative). The bf16
# policy rounds each weight gradient product to bf16: a rank rounds its
# partial sum, the one process the whole sum, so an element can differ by
# one bf16 unit (2**-7 relative); gradients within 1e-2 relative L2
# (observed at most 2.7e-3). Adam moves a coordinate by about lr whatever its
# gradient's size (bf16 moments by up to 2**-8 more), so one whose gradient
# is near zero can land on the other side: within 3 lr (observed 2 lr), and
# fewer than 1% of the coordinates more than 1e-6 apart (observed 0.2%).
BF16 = {"aux": {"rtol": 1e-4, "atol": 1e-4}, "grad": 1e-2, "param": 3 * LR, "share": 0.01}
THREE_STEPS = 3


def _poses(n: int, seed: int, scale: float = 1.0) -> torch.Tensor:
    p = generate_poses(n, seed=seed)["poses_2d"].astype(np.float32)
    return tgeo.normalize_head(torch.from_numpy(p.transpose(0, 2, 1).reshape(n, 34))) * scale


def _stage_case(stage: str, policy: str, seed: int, n_steps: int = 1) -> dict:
    """One stage's model, frozen modules, config, global batches and draws,
    from seeded generators."""
    g = torch.Generator().manual_seed(seed)
    bf16 = policy == "bf16"

    def flow(dim):
        return Flow(dim, 2, 64, generator=g).requires_grad_(False)

    draw = steps.draw_step
    if stage == "1":
        # a global-norm clip, which must see the reduced gradient
        model, frozen = Flow(34, 2, 64, generator=g), ()
        cfg = FlowTrainConfig(batch_size=BATCH, bf16=bf16, optim=OptimConfig(clip_grad_norm=1.0))
        draw = steps.draw_noise
    elif stage == "2":
        model = PartFlows(*(Flow(d, 2, 64, generator=g) for d in (22, 22, 14, 20)))
        frozen, cfg = (flow(34),), PartFlowTrainConfig(batch_size=BATCH, bf16=bf16)
        draw = steps.draw_noise
    elif stage in ("3a", "3b"):
        if stage == "3a":
            model = StackedLifter(Lifter(11, HID, generator=g), Lifter(11, HID, generator=g))
            frozen = (flow(34), flow(22), flow(22))
        else:
            model = LegTorsoLifter(Lifter(LEG_JOINTS, HID, generator=g),
                                   Lifter(TORSO_JOINTS, HID, generator=g))
            frozen = (flow(34), flow(14), flow(20))
        cfg = LifterTrainConfig(nll_cap=500.0, batch_size=BATCH, bf16=bf16,
                                optim=OptimConfig(bf16_moments=True))
    else:
        model = Completers(HID, generator=g)
        frozen = tuple(Lifter(j, HID, generator=g).requires_grad_(False)
                       for j in (LEG_JOINTS, TORSO_JOINTS))
        cfg = OcclusionTrainConfig(batch_size=BATCH, bf16=bf16, input_noise=INPUT_NOISE)
        draw = functools.partial(steps.draw_occlusion, n_rot=cfg.n_rot, input_noise=INPUT_NOISE)
    gen = torch.Generator().manual_seed(seed + 1)
    return {"stage": stage, "model": model, "frozen": frozen, "cfg": cfg,
            "batches": [_poses(BATCH, seed + 2 + i) for i in range(n_steps)],
            "draws": [draw(gen, BATCH, "cpu") for _ in range(n_steps)]}


def _props(model, poses: torch.Tensor) -> torch.Tensor:
    """The elevation angles a 3a lifter pair predicts for ``poses``."""
    with torch.no_grad():
        _, _, left, right = model(*split_data_left_right(poses))
    return ((left + right) / 2).ravel()


def _skewed_3a_case() -> dict:
    """3a on a batch whose halves are the poses of a pool with the lowest
    and the highest predicted elevation angles, so that the angles on rank
    0's rows and on rank 1's differ clearly (checked in the test)."""
    case = _stage_case("3a", "f32", seed=90)
    pool = _poses(64, 91)
    order = torch.argsort(_props(case["model"], pool))
    case["batches"] = [torch.cat([pool[order[:BATCH // 2]], pool[order[-(BATCH // 2):]]])]
    return case


def _jax_models():
    """JAX lifters (left, right) and flows (full, left, right) as numpy,
    as tests/test_torch_train_step.py makes them."""
    keys = jax.random.split(jax.random.PRNGKey(0), 5)
    lifters = [jax.tree.map(np.asarray, jmodels.init_lifter(k, 11, hidden=64))
               for k in keys[:2]]
    fl = [jflows.init_flow(k, d, n_blocks=4, hidden=64) for k, d in zip(keys[2:], (34, 22, 22))]
    return lifters, [jflows.Flow(jax.tree.map(np.asarray, f.params), np.asarray(f.perm))
                     for f in fl]


def _jax_case(jax_models) -> dict:
    """3a at f32 on the JAX package's seeded weights, with numpy draws."""
    lifters, fl = jax_models
    rng = np.random.default_rng(5)
    draws = steps.StepDraws(*(torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(size=(BATCH, 34)), rng.uniform(size=(2 * BATCH, 1)),
        rng.normal(size=(2 * BATCH, 1)))))
    return {"stage": "3a",
            "model": StackedLifter(*(lifter_from_state_dict(lifter_params_from_jax(t))
                                     for t in lifters)),
            "frozen": tuple(flow_from_state_dict(flow_params_from_jax(f.params, f.perm))
                            .requires_grad_(False) for f in fl),
            "cfg": LifterTrainConfig(nll_cap=500.0, batch_size=BATCH, bf16=False),
            "batches": [_poses(BATCH, seed=6)], "draws": [draws]}


def _cases(world: int, jax_models) -> dict:
    cases = {(stage, policy): _stage_case(stage, policy, seed=10 * i + j)
             for i, stage in enumerate(STAGES) for j, policy in enumerate(POLICIES)}
    cases["three steps"] = _stage_case("3a", "bf16", seed=70, n_steps=THREE_STEPS)
    if world == 2:
        skewed = _skewed_3a_case()
        cases["skewed"] = skewed
        cases["skewed local"] = dict(skewed, local_stats=True)
        cases["jax"] = _jax_case(jax_models)
        cases["validate"] = dict(_stage_case("3a", "f32", seed=80), validate=True,
                                 test_2d=_poses(40, seed=81))
    return cases


@pytest.fixture(scope="module")
def jax_models():
    return _jax_models()


@pytest.fixture(scope="module")
def runs(module_scratch, jax_models):
    """-> ``run(W)``: every case on W gloo ranks (one spawn, made when first
    asked for) and in this process, as (cases, one-process results, each
    rank's results)."""
    done = {}

    def run(world: int):
        if world not in done:
            tmp = module_scratch(f"dp{world}")
            cases = _cases(world, jax_models)
            names = list(cases)
            torch.save(dict(enumerate(cases.values())), tmp / "cases.pt")
            # the ranks inherit this process's one thread (one_cpu_thread)
            parallel.spawn(_torch_dp.worker, (str(tmp / "cases.pt"),
                                              str(tmp / "rank{rank}.pt")), ["cpu"] * world)
            want = {name: _torch_dp.run_case(case) for name, case in cases.items()}
            got = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]
            done[world] = (cases, want, [{names[i]: v for i, v in g.items()} for g in got])
        return done[world]

    return run


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-12))


def _assert_matches(got: dict, want: dict, tol: dict, name):
    assert got["aux"].keys() == want["aux"].keys()
    for k, v in want["aux"].items():
        np.testing.assert_allclose(got["aux"][k], v, err_msg=f"{name} {k}", **tol["aux"])
    rel = [_rel(a, b) for a, b in zip(got["grads"], want["grads"])]
    assert len(rel) == len(want["grads"]) and max(rel) < tol["grad"], (name, max(rel))
    gaps = torch.cat([(a - b).abs().ravel() for a, b in zip(got["params"], want["params"])])
    assert float(gaps.max()) <= tol["param"], (name, float(gaps.max()))
    if "share" in tol:
        assert float((gaps > 1e-6).float().mean()) < tol["share"], name


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("world", WORLDS)
def test_ranks_match_one_process(runs, world, stage, policy):
    """One step of each stage on W ranks (each on its rows of the batch and
    of the draws) against one process on the whole batch: loss terms,
    gradients after the all-reduce, and parameters after Adam, on every
    rank."""
    _, want, got = runs(world)
    for rank in range(world):
        _assert_matches(got[rank][stage, policy], want[stage, policy],
                        F32 if policy == "f32" else BF16, (stage, policy, world, rank))


@pytest.mark.parametrize("stage", STAGES)
def test_one_rank_is_one_process_bit_for_bit(runs, stage):
    """A group of one rank (what ``python -m torch.distributed.run
    --nproc_per_node 1`` makes) computes the one process's step bit for bit:
    its batch is the global batch, and its reductions are over itself."""
    _, want, got = runs(1)
    for policy in POLICIES:
        got_case, want_case = got[0][stage, policy], want[stage, policy]
        assert got_case["aux"] == want_case["aux"], (stage, policy)
        for key in ("grads", "params"):
            assert all(torch.equal(a, b) for a, b in zip(got_case[key], want_case[key])), key


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_hold_bitwise_equal_parameters(runs, world):
    """After one step of every case and three steps of 3a, every rank holds
    rank 0's parameters bit for bit (the all-reduce gives every rank the
    same gradient)."""
    cases, _, got = runs(world)
    for name in cases:
        if "params" in got[0][name]:
            for rank in range(1, world):
                assert all(torch.equal(a, b) for a, b in
                           zip(got[rank][name]["params"], got[0][name]["params"])), (name, rank)
    assert len(got[0]["three steps"]["params"]) == len(list(cases["three steps"]["model"]
                                                            .parameters()))


def test_global_elevation_statistics(runs):
    """On a batch whose shards' elevation angles differ clearly, the 2-rank
    gradient with the global statistics is the one-process gradient; with
    each rank's own statistics it is not."""
    cases, want, got = runs(2)
    props = _props(cases["skewed"]["model"], cases["skewed"]["batches"][0]).reshape(2, -1)
    assert float((props[1].mean() - props[0].mean()).abs()) > 2 * float(props.std(dim=1).max())
    glob = max(_rel(a, b) for a, b in zip(got[0]["skewed"]["grads"], want["skewed"]["grads"]))
    local = max(_rel(a, b) for a, b in zip(got[0]["skewed local"]["grads"],
                                            want["skewed"]["grads"]))
    assert glob < F32["grad"] and local > 100 * F32["grad"], (glob, local)


def _pin_jax_draws(monkeypatch, draws):
    """Make the JAX package's latent-noise draw and rotation sampler return
    ``draws`` (as tests/test_torch_train_step.py pins them)."""
    def normal(key, shape, dtype=jnp.float32):
        return jnp.asarray(draws.eps_noise.numpy())

    def rotation(key, props, use_elevation=True, axis_name=None):
        r_comp = jgeo.rotation_about_x(props)
        x_ang = -props.mean() + props.std(ddof=1) * jnp.asarray(draws.eps_elev.numpy())
        y_ang = (jnp.asarray(draws.u_azim.numpy()) - 0.5) * 1.99 * jgeo.PI
        return jnp.matmul(jgeo.rotation_about_x(x_ang),
                          jnp.matmul(jgeo.rotation_about_y(y_ang), r_comp, precision="highest"),
                          precision="highest")

    monkeypatch.setattr(jgeo.jax.random, "normal", normal)
    monkeypatch.setattr(jlifter_obj, "sample_rotation", rotation)


def test_3a_on_two_ranks_matches_jax_dp_jit_step(runs, jax_models, monkeypatch):
    """3a (f32) on 2 gloo ranks against the JAX package's GSPMD step on a
    2-device mesh, from the same weights, batch and draws: the loss terms
    within rtol 1e-4 and atol 1e-5 (tests/test_torch_train_step.py's F32_TOL
    for the port's one process against JAX's); after Adam, no coordinate
    more than 2 lr away and fewer than 0.1% more than 1e-6 (a coordinate
    whose gradient is near zero can move by up to 2 lr in one package and
    not in the other)."""
    cases, _, got = runs(2)
    case = cases["jax"]
    _pin_jax_draws(monkeypatch, case["draws"][0])
    lifters, fl = jax_models
    cfg = JLifterTrainConfig(nll_cap=500.0, bf16=False, batch_size=BATCH)
    opt = make_optimizer(cfg.optim, steps_per_epoch=2)
    jstep = j_build_step(jlifter_obj.LifterFrozen(*fl), opt, cfg)
    mesh = jparallel.make_mesh(2)
    state = init_state(jax.tree.map(lambda a, b: jnp.stack([a, b]), *lifters), opt)
    jstate, jaux = jparallel.dp_jit_step(jstep, mesh)(
        jparallel.replicate(state, mesh),
        jparallel.shard_batch(jnp.asarray(case["batches"][0].numpy()), mesh),
        jax.random.PRNGKey(0))
    for k, v in got[0]["jax"]["aux"].items():
        np.testing.assert_allclose(v, float(jaux[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    model = case["model"]
    for p, v in zip(model.parameters(), got[0]["jax"]["params"]):
        p.data.copy_(v)
    diffs = []
    for side, lifter in enumerate((model.left, model.right)):
        want = lifter_from_state_dict(lifter_params_from_jax(
            jax.tree.map(lambda a, s=side: np.asarray(a[s]), jstate.params)))
        for a, b in zip(lifter.parameters(), want.parameters()):
            diffs.append((a - b).abs().detach().ravel())
    diffs = torch.cat(diffs)
    assert float(diffs.max()) <= 2 * LR and float((diffs > 1e-6).float().mean()) < 1e-3


def test_validation_in_a_group_does_not_reduce(runs):
    """Validation reads the whole test split on one rank: the unsupervised
    criterion a rank of a group computes is the one process's, bit for
    bit."""
    _, want, got = runs(2)
    for rank in range(2):
        assert got[rank]["validate"] == want["validate"]


def _rank(rank: int, world: int) -> parallel.Group:
    """A rank's place (no process group: the layouts need no collective)."""
    return parallel.Group(rank, world, torch.device("cpu"))


@pytest.mark.parametrize("world", WORLDS)
def test_shard_draws_layouts(world):
    """Rank r's draws are rows [r b, (r + 1) b) of the latent noise, those
    rows of each half of the rotation draws (the augmented batch [real;
    samples]), and those rows of each rotation and orientation block of stage
    4's draws: the ranks' shards, put back together, are the global draws."""
    gen = torch.Generator().manual_seed(0)
    lift = steps.draw_step(gen, BATCH, "cpu")
    occ = steps.draw_occlusion(gen, BATCH, "cpu", n_rot=2, input_noise=0.1)
    b = BATCH // world
    shards = [(steps.shard_draws(lift, _rank(r, world)),
               steps.shard_draws(occ, _rank(r, world))) for r in range(world)]
    for r, (s, o) in enumerate(shards):
        rows = slice(r * b, (r + 1) * b)
        assert torch.equal(s.eps_noise, lift.eps_noise[rows])
        for a, full in ((s.u_azim, lift.u_azim), (s.eps_elev, lift.eps_elev)):
            assert torch.equal(a, torch.cat([full[rows], full[BATCH:][rows]]))
        assert torch.equal(o.u_rot, occ.u_rot[:, rows])
        blocks = occ.eps_input.reshape(3, BATCH, 3, 17)[:, rows].reshape(-1, 3, 17)
        assert torch.equal(o.eps_input, blocks)
        assert torch.equal(steps.shard_draws(lift.eps_noise, _rank(r, world)),
                           lift.eps_noise[rows])
    assert steps.shard_draws(lift, None) is lift


@pytest.mark.parametrize("world", WORLDS)
def test_epoch_batches_shard_each_global_batch(world, tmp_path):
    """In memory and from a pack, every rank draws the same permutation
    (or shuffle seed) and steps on its rows of each global batch: the
    ranks' batches, put back together, are the one process's."""
    data = torch.from_numpy(np.random.default_rng(3).normal(size=(100, 34)).astype(np.float32))
    pack_dataset(tmp_path / "p.lnks", data.numpy())
    packed = PackedDataset(tmp_path / "p.lnks")
    feed = PackedFeed(packed, "cpu", chunk_steps=2)
    sources = {"memory": lambda g, grp: tensor_batches(data, BATCH, g, grp),
               "pack": lambda g, grp: feed.batches(BATCH, g, grp)}
    for name, source in sources.items():
        one = list(source(torch.Generator().manual_seed(4), None))
        per_rank = [list(source(torch.Generator().manual_seed(4), _rank(r, world)))
                    for r in range(world)]
        assert len(one) == 100 // BATCH and all(len(p) == len(one) for p in per_rank), name
        for i, batch in enumerate(one):
            assert torch.equal(torch.cat([p[i] for p in per_rank]), batch), (name, i)
    packed.close()
