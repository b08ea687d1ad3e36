"""ZeRO, tensor parallelism and the GPipe trunk of links_tpu_torch
(train/parallel.py) on the CPU, on gloo ranks (the rank bodies are
tests/_torch_dp.py's; one spawn per world size):

* against the JAX package: ZeRO on 2 ranks against ``dp_zero_step`` on
  ``make_mesh(2)`` (3 steps of 3a), DP x TP on a (2, 2) layout against
  ``dp_tp_step`` on ``make_mesh_2d(2, 2)`` (one 3a step), and the trunk
  against ``pp_trunk_apply`` on ``make_mesh_pipe`` (outputs, gradients, one
  microbatch, the two guards), at JAX's own bounds
  (tests/test_parallel.py);
* against one process of the port, at tests/test_torch_parallel.py's F32
  and BF16 bounds: ZeRO on 2 and 4 ranks for 3a, 3b and stage 4 under both
  policies (padded lanes exactly 0, a world that pads), a clip that must
  read the global norm, TP on (1, 2) and (2, 2) layouts (replicated
  parameters bitwise equal over 'model', l1 split in half), and the trunk's
  gradients with respect to x and its blocks.

Widths are small: lifters at hidden 64, flows of 2 blocks at 64, the trunk
at 32. Draws are tensors; the JAX side's are pinned by monkeypatching its
noise draw and rotation sampler, step by step."""

import copy
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
    trunk_from_jax,
    zero_state_from_jax,
)
from links_tpu_torch.config import (
    FlowTrainConfig,
    LifterTrainConfig,
    OcclusionTrainConfig,
    OptimConfig,
)
from links_tpu_torch.core import geometry as tgeo
from links_tpu_torch.core.nn import BF16, F32
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
from links_tpu_torch.train import parallel, steps
from links_tpu_torch.train.optim import Adam

BATCH = 16       # global: 8 rows a rank at W = 2, 4 at W = 4
HID = 64
FLOW_HID = 64
TRUNK_HID = 32
LR = OptimConfig().learning_rate
# Ranks against one process: tests/test_torch_parallel.py's bounds (loss terms,
# parameters after Adam; bf16: a coordinate whose gradient is near zero can
# land on the other side, within 3 lr, fewer than 1% more than 1e-6 apart)
F32_TOL = {"aux": {"rtol": 1e-5, "atol": 1e-5}, "param": 1e-5}
BF16_TOL = {"aux": {"rtol": 1e-4, "atol": 1e-4}, "param": 3 * LR, "share": 0.01}
# after several bf16 steps the coordinates whose gradient is near zero drift
# apart step by step (7.3% more than 1e-6 apart after 3 steps, observed), and
# one Adam step moves a coordinate by at most about lr: within 2 (1 + 2**-7)
# lr per step taken (chip_smoke.py's data-parallel bound), no share bound
TP_STEPS = 3
BF16_STEPS_TOL = {"aux": BF16_TOL["aux"], "param": 2 * (1 + 2 ** -7) * LR * TP_STEPS}
# against the JAX package: its own bounds (tests/test_parallel.py:198-214,
# 329-384): losses rtol 1e-4; parameters and moments relative L2 1e-4 per
# tensor; trunk outputs rtol = atol = 1e-5, gradients rtol 2e-4, atol 1e-5
JAX_LOSS_RTOL = 1e-4
JAX_REL = 1e-4
TRUNK_OUT = {"rtol": 1e-5, "atol": 1e-5}
TRUNK_GRAD = {"rtol": 2e-4, "atol": 1e-5}
# the port's trunk against its sequential trunk: f32 at JAX's bounds; bf16
# rounds each microbatch's weight gradient to bf16 before the sum over
# microbatches, where the one process rounds the sum once: relative L2 1e-2
# per gradient (tests/test_torch_parallel.py's BF16 gradient bound)
TRUNK_BF16_GRAD_REL = 1e-2
STAGES = ("3a", "3b", "4")
POLICIES = ("f32", "bf16")
WORLDS = (2, 4)
MESHES = {2: (1, 2), 4: (2, 2)}
ZERO_STEPS = 3
CLIP_STEPS = 3


def _poses(n: int, seed: int) -> torch.Tensor:
    p = generate_poses(n, seed=seed)["poses_2d"].astype(np.float32)
    return tgeo.normalize_head(torch.from_numpy(p.transpose(0, 2, 1).reshape(n, 34)))


def _stage_case(kind: str, stage: str, policy: str, seed: int, n_steps: int = 1,
                optim: OptimConfig | None = None, use_layernorm: bool = False) -> dict:
    """One stage's model, frozen modules, config, global batches and draws
    (``_torch_dp.run_case``'s format) from seeded generators; 3a's lifters
    with LayerNorms under ``use_layernorm``."""
    g = torch.Generator().manual_seed(seed)
    bf16 = policy == "bf16"

    def flow(dim):
        return Flow(dim, 2, FLOW_HID, generator=g).requires_grad_(False)

    draw = steps.draw_step
    if stage == "1":
        model, frozen = Flow(34, 2, FLOW_HID, generator=g), ()
        cfg, draw = FlowTrainConfig(batch_size=BATCH, bf16=bf16, optim=optim), steps.draw_noise
    elif stage in ("3a", "3b"):
        if stage == "3a":
            model = StackedLifter(*(Lifter(11, HID, use_layernorm=use_layernorm, generator=g)
                                    for _ in "lr"))
            frozen = (flow(34), flow(22), flow(22))
        else:
            model = LegTorsoLifter(Lifter(LEG_JOINTS, HID, generator=g),
                                   Lifter(TORSO_JOINTS, HID, generator=g))
            frozen = (flow(34), flow(14), flow(20))
        cfg = LifterTrainConfig(nll_cap=500.0, batch_size=BATCH, bf16=bf16,
                                optim=optim or OptimConfig(bf16_moments=True))
    else:
        model = Completers(HID, generator=g)
        frozen = tuple(Lifter(j, HID, generator=g).requires_grad_(False)
                       for j in (LEG_JOINTS, TORSO_JOINTS))
        cfg = OcclusionTrainConfig(batch_size=BATCH, bf16=bf16, input_noise=0.05)
        draw = functools.partial(steps.draw_occlusion, n_rot=cfg.n_rot, input_noise=0.05)
    gen = torch.Generator().manual_seed(seed + 1)
    return {"kind": kind, "stage": stage, "model": model, "frozen": frozen, "cfg": cfg,
            "batches": [_poses(BATCH, seed + 2 + i) for i in range(n_steps)],
            "draws": [draw(gen, BATCH, "cpu") for _ in range(n_steps)]}


def _jax_models():
    """JAX lifters (left, right) and flows (full, left, right), and trunks of
    depth 8 and 4 and of depth 4 for two stages, as numpy."""
    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    lifters = [jax.tree.map(np.asarray, jmodels.init_lifter(k, 11, hidden=HID))
               for k in keys[:2]]
    fl = [jflows.init_flow(k, d, n_blocks=2, hidden=FLOW_HID)
          for k, d in zip(keys[2:5], (34, 22, 22))]
    fl = [jflows.Flow(jax.tree.map(np.asarray, f.params), np.asarray(f.perm)) for f in fl]

    def trunk(depth, key):
        return jax.tree.map(np.asarray, jparallel.stack_blocks(
            [jmodels.init_res_block(k, TRUNK_HID) for k in jax.random.split(key, depth)]))

    trunks = {8: trunk(8, keys[5]), 4: trunk(4, keys[6]), "2 stages": trunk(4, keys[7])}
    return lifters, fl, trunks


def _draws(seed: int) -> steps.StepDraws:
    rng = np.random.default_rng(seed)
    return steps.StepDraws(*(torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(size=(BATCH, 34)), rng.uniform(size=(2 * BATCH, 1)),
        rng.normal(size=(2 * BATCH, 1)))))


def _jax_case(kind: str, jax_models, n_steps: int) -> dict:
    """3a at f32 on the JAX package's seeded weights, with numpy draws."""
    lifters, fl, _ = jax_models
    return {"kind": kind, "stage": "3a",
            "model": StackedLifter(*(lifter_from_state_dict(lifter_params_from_jax(t))
                                     for t in lifters)),
            "frozen": tuple(flow_from_state_dict(flow_params_from_jax(f.params, f.perm))
                            .requires_grad_(False) for f in fl),
            "cfg": LifterTrainConfig(nll_cap=500.0, batch_size=BATCH, bf16=False),
            "batches": [_poses(BATCH, seed=6 + i) for i in range(n_steps)],
            "draws": [_draws(5 + i) for i in range(n_steps)]}


def _pp_case(trunk, batch: int, n_micro: int, seed: int, bf16: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    x, target = (torch.from_numpy(rng.normal(size=(batch, TRUNK_HID)).astype(np.float32))
                 for _ in "xt")
    return {"kind": "pp", "blocks": trunk_from_jax(trunk), "x": x, "target": target,
            "n_micro": n_micro, "bf16": bf16, "jax": trunk}


def _cases(world: int, jax_models) -> dict:
    trunks = jax_models[2]
    cases = {("zero", stage, policy): _stage_case("zero", stage, policy, seed=10 * i + j)
             for i, stage in enumerate(STAGES) for j, policy in enumerate(POLICIES)}
    for policy in POLICIES:
        cases["tp", policy] = dict(_stage_case("tp", "3a", policy, seed=40), mesh=MESHES[world])
    cases["tp", "layernorm"] = dict(_stage_case("tp", "3a", "f32", seed=45, use_layernorm=True),
                                    mesh=MESHES[world])
    cases["tp steps"] = dict(_stage_case("tp", "3a", "bf16", seed=50, n_steps=TP_STEPS),
                             mesh=MESHES[world])
    if world == 2:
        cases["zero jax"] = _jax_case("zero", jax_models, ZERO_STEPS)
        cases["clip"] = _stage_case("zero", "1", "f32", seed=60, n_steps=CLIP_STEPS,
                                    optim=OptimConfig(clip_grad_norm=1.0))
        cases["pp one micro"] = _pp_case(trunks["2 stages"], 4, 1, seed=2)
    else:
        cases["tp jax"] = dict(_jax_case("tp", jax_models, 1), mesh=(2, 2))
        cases["pp out"] = _pp_case(trunks[8], 16, 4, seed=3)
        cases["pp grad"] = _pp_case(trunks[4], 8, 2, seed=4)
        cases["pp bf16"] = _pp_case(trunks[8], 16, 4, seed=5, bf16=True)
    return cases


def _one_process(case: dict) -> dict:
    """``case`` in one process: ``run_case`` for a training case (loss terms
    of the first step, parameters after the last), the sequential trunk for
    a trunk case (output, gradients with respect to x and the blocks)."""
    if case["kind"] != "pp":
        return _torch_dp.run_case(case)
    blocks = copy.deepcopy(case["blocks"])
    x = case["x"].clone().requires_grad_(True)
    y = _torch_dp.sequential_trunk(blocks, x, BF16 if case["bf16"] else F32)
    gx, *grads = torch.autograd.grad(((y - case["target"]) ** 2).mean(),
                                     [x, *blocks.parameters()])
    per = len(grads) // len(blocks)
    return {"out": y.detach(), "gx": gx,
            "grads": {i: grads[i * per:(i + 1) * per] for i in range(len(blocks))}}


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
            tmp = module_scratch(f"ztp{world}")
            cases = _cases(world, jax_models)
            names = list(cases)
            torch.save(dict(enumerate(cases.values())), tmp / "cases.pt")
            # the ranks inherit this process's one thread (one_cpu_thread)
            parallel.spawn(_torch_dp.parallel_worker, (str(tmp / "cases.pt"),
                                                       str(tmp / "rank{rank}.pt")),
                           ["cpu"] * world)
            want = {name: _one_process(case) for name, case in cases.items()
                    if "jax" not in name}
            got = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]
            done[world] = (cases, want, [{names[i]: v for i, v in g.items()} for g in got])
        return done[world]

    return run


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-12))


def _assert_close_to_one_process(got: dict, want: dict, tol: dict, name):
    for k, v in want["aux"].items():
        np.testing.assert_allclose(got["aux"][k], v, err_msg=f"{name} {k}", **tol["aux"])
    gaps = torch.cat([(a - b).abs().ravel() for a, b in zip(got["params"], want["params"])])
    assert len(got["params"]) == len(want["params"])
    assert float(gaps.max()) <= tol["param"], (name, float(gaps.max()))
    if "share" in tol:
        assert float((gaps > 1e-6).float().mean()) < tol["share"], name


# --------------------------------------------------------------------------
# against the JAX package


def _pin_jax_draws(monkeypatch, draws: list, box: dict):
    """Make the JAX package's latent-noise draw and rotation sampler return
    ``draws[box["i"]]``: the loss function sets ``box["i"]`` from its key
    while it is traced, so one jitted step reads each step's draws."""
    eps = jnp.asarray(np.stack([d.eps_noise.numpy() for d in draws]))
    u_azim = jnp.asarray(np.stack([d.u_azim.numpy() for d in draws]))
    eps_elev = jnp.asarray(np.stack([d.eps_elev.numpy() for d in draws]))

    def normal(key, shape, dtype=jnp.float32):
        return eps[box["i"]]

    def rotation(key, props, use_elevation=True, axis_name=None):
        r_comp = jgeo.rotation_about_x(props)
        x_ang = -props.mean() + props.std(ddof=1) * eps_elev[box["i"]]
        y_ang = (u_azim[box["i"]] - 0.5) * 1.99 * jgeo.PI
        return jnp.matmul(jgeo.rotation_about_x(x_ang),
                          jnp.matmul(jgeo.rotation_about_y(y_ang), r_comp, precision="highest"),
                          precision="highest")

    monkeypatch.setattr(jgeo.jax.random, "normal", normal)
    monkeypatch.setattr(jlifter_obj, "sample_rotation", rotation)


def _jax_setup(jax_models):
    lifters, fl, _ = jax_models
    cfg = JLifterTrainConfig(nll_cap=500.0, bf16=False, batch_size=BATCH)
    stacked = jax.tree.map(lambda a, b: jnp.stack([a, b]), *lifters)
    return cfg, make_optimizer(cfg.optim, steps_per_epoch=2), stacked, \
        jlifter_obj.LifterFrozen(*fl)


def _assert_rel(got: list, want: list, name):
    rel = [_rel(a, b) for a, b in zip(got, want)]
    assert len(got) == len(want) and max(rel) < JAX_REL, (name, max(rel))


def test_zero_matches_jax_dp_zero_step(runs, jax_models, monkeypatch):
    """ZeRO on 2 gloo ranks against the JAX package's ``dp_zero_step`` on a
    2-device mesh, 3 steps of 3a at f32 from the same weights, batches and
    draws: each step's loss within rtol 1e-4; the parameters and both Adam
    moments, unflattened on both sides into the port's tensors, within a
    relative L2 error of 1e-4 each."""
    cases, _, got = runs(2)
    case = cases["zero jax"]
    box = {}
    _pin_jax_draws(monkeypatch, case["draws"], box)
    cfg, opt, stacked, frozen = _jax_setup(jax_models)

    def loss_fn(params, batch, key):  # build_left_right_step's loss, its draw index set
        box["i"] = key[1]
        k_sample, k_rot = jax.random.split(key)
        inp = jlifter_obj.augment_with_samples(frozen.full_flow, batch, k_sample,
                                               cfg.noise_factor)
        return jlifter_obj.left_right_loss(params, frozen, inp, k_rot, cfg)

    mesh = jparallel.make_mesh(2)
    z_state, unravel = jparallel.init_zero_state(stacked, opt, mesh)
    step = jparallel.dp_zero_step(loss_fn, opt, mesh, stacked)
    for i, batch in enumerate(case["batches"]):
        z_state, aux = step(z_state, jparallel.shard_batch(jnp.asarray(batch.numpy()), mesh),
                            jax.random.PRNGKey(i))
        for r in range(2):
            np.testing.assert_allclose(got[r]["zero jax"]["losses"][i]["loss"], float(aux["loss"]),
                                       rtol=JAX_LOSS_RTOL, err_msg=f"step {i}")
    want = zero_state_from_jax(z_state, unravel, case["model"])
    assert want["count"] == ZERO_STEPS and want["step"] == ZERO_STEPS
    # JAX's state as the port's shards (one rank: the whole flat vectors)
    mine = parallel.init_zero_state(case["model"], case["cfg"].optim,
                                    parallel.Group(0, 1, torch.device("cpu")), 2, state=want)
    for flat, key in ((mine.flat_params, "params"), (mine.opt.mu[0], "mu"),
                      (mine.opt.nu[0], "nu")):
        assert torch.equal(flat, torch.cat([t.reshape(-1) for t in want[key]])), key
    assert (mine.opt.count, mine.step) == (ZERO_STEPS, ZERO_STEPS)
    for r in range(2):
        assert got[r]["zero jax"]["count"] == ZERO_STEPS
        for key in ("params", "mu", "nu"):
            _assert_rel(got[r]["zero jax"][key], want[key], (key, r))


def _stacked_tensors(model: StackedLifter, tree) -> list:
    """A JAX stacked (left, right) lifter tree -> ``model``'s tensors in
    ``parameters()`` order."""
    sd = {f"{side}.{k}": v for s, side in enumerate(("left", "right"))
          for k, v in lifter_params_from_jax(jax.tree.map(lambda a: np.asarray(a[s]),
                                                          tree)).items()}
    return [sd[name] for name, _ in model.named_parameters()]


def test_dp_tp_matches_jax_dp_tp_step(runs, jax_models, monkeypatch):
    """DP x TP on a (2, 2) layout of gloo ranks against the JAX package's
    ``dp_tp_step`` on ``make_mesh_2d(2, 2)``, one 3a step at f32: the loss
    within rtol 1e-4; the parameters and both moments, gathered over
    'model', within a relative L2 error of 1e-4 each."""
    cases, _, got = runs(4)
    case = cases["tp jax"]
    _pin_jax_draws(monkeypatch, case["draws"], {"i": 0})
    cfg, opt, stacked, frozen = _jax_setup(jax_models)
    mesh = jparallel.make_mesh_2d(2, 2)
    state = init_state(stacked, opt)
    tp_step = jparallel.dp_tp_step(j_build_step(frozen, opt, cfg), mesh, state)
    state = jax.device_put(state, jparallel.tp_state_shardings(state, mesh))
    batch = jax.device_put(jnp.asarray(case["batches"][0].numpy()),
                           jparallel.data_sharding(mesh))
    state, aux = tp_step(state, batch, jax.random.PRNGKey(0))
    adam = next(s for s in state.opt_state if hasattr(s, "mu"))
    want = {key: _stacked_tensors(case["model"], tree)
            for key, tree in (("params", state.params), ("mu", adam.mu), ("nu", adam.nu))}
    for r in range(4):
        np.testing.assert_allclose(got[r]["tp jax"]["aux"]["loss"], float(aux["loss"]),
                                   rtol=JAX_LOSS_RTOL)
        for key in ("params", "mu", "nu"):
            _assert_rel(got[r]["tp jax"][key], want[key], (key, r))


def _jax_trunk(stacked, x):
    from links_tpu.core import nn as jnn
    from links_tpu.models.lifters import res_block_apply

    def body(h, blk):
        return jnn.leaky_relu(res_block_apply(blk, h)), None

    return jax.lax.scan(body, x, stacked)[0]


def test_pipeline_matches_jax_pp_trunk_apply(runs):
    """An 8-block trunk on 4 stages, 4 microbatches: every stage's output
    against JAX's ``pp_trunk_apply`` on ``make_mesh_pipe(4)`` (and its
    sequential trunk) within rtol = atol = 1e-5."""
    cases, _, got = runs(4)
    case = cases["pp out"]
    mesh = jparallel.make_mesh_pipe(4)
    x = jnp.asarray(case["x"].numpy())
    out = np.asarray(jparallel.pp_trunk_apply(case["jax"], x, mesh, n_micro=4))
    np.testing.assert_allclose(out, np.asarray(_jax_trunk(case["jax"], x)), **TRUNK_OUT)
    for r in range(4):
        np.testing.assert_allclose(got[r]["pp out"]["out"].numpy(), out, **TRUNK_OUT)


def test_pipeline_gradients_match_jax(runs):
    """A 4-block trunk on 4 stages, 2 microbatches: the gradient of the mean
    squared distance to a target with respect to each stage's block against
    ``jax.grad`` through JAX's ``pp_trunk_apply``, within rtol 2e-4, atol
    1e-5; JAX's gradients are in (in, out) layout."""
    cases, _, got = runs(4)
    case = cases["pp grad"]
    mesh = jparallel.make_mesh_pipe(4)
    x, target = (jnp.asarray(case[k].numpy()) for k in ("x", "target"))
    grads = jax.grad(lambda b: jnp.mean(
        (jparallel.pp_trunk_apply(b, x, mesh, n_micro=2) - target) ** 2))(case["jax"])
    for r in range(4):
        for i, (w1, b1, w2, b2) in got[r]["pp grad"]["grads"].items():
            want = [np.asarray(grads[l][k][i]) for l in ("l1", "l2") for k in ("w", "b")]
            for a, b in zip((w1.T, b1, w2.T, b2), want):
                np.testing.assert_allclose(a.numpy(), b, err_msg=f"stage {r} block {i}",
                                           **TRUNK_GRAD)
        assert sorted(got[r]["pp grad"]["grads"]) == [r]


def test_pipeline_single_microbatch_matches_jax(runs):
    """n_micro = 1 on 2 stages (pure fill and drain): the output against
    JAX's ``pp_trunk_apply`` on ``make_mesh_pipe(2)`` within 1e-5."""
    cases, _, got = runs(2)
    case = cases["pp one micro"]
    x = jnp.asarray(case["x"].numpy())
    out = np.asarray(jparallel.pp_trunk_apply(case["jax"], x, jparallel.make_mesh_pipe(2), 1))
    for r in range(2):
        np.testing.assert_allclose(got[r]["pp one micro"]["out"].numpy(), out, **TRUNK_OUT)


@pytest.mark.parametrize("guard", ["depth", "n_micro"])
def test_pipeline_guards(jax_models, guard):
    """A depth the stage count does not divide (3 blocks on 2 stages) and a
    batch n_micro does not divide (4 rows, n_micro 3) raise ValueError in
    both packages, before any communication."""
    trunks = jax_models[2]
    stacked = trunks["2 stages"]
    if guard == "depth":
        stacked = jax.tree.map(lambda a: a[:3], stacked)
    n_micro = 3 if guard == "n_micro" else 1
    x = np.zeros((4, TRUNK_HID), np.float32)
    layout = parallel.Layout(("pipe",), (parallel.Group(0, 2, torch.device("cpu")),))
    with pytest.raises(ValueError):
        parallel.pp_trunk_apply(trunk_from_jax(stacked), torch.from_numpy(x), layout, n_micro)
    with pytest.raises(ValueError):
        jparallel.pp_trunk_apply(stacked, jnp.asarray(x), jparallel.make_mesh_pipe(2), n_micro)


def test_tp_param_specs_match_jax():
    """The port's split of each parameter of a LayerNorm lifter is JAX's
    ``tp_param_specs`` of the same lifter, read through the transposed
    (in, out) layout: the JAX spec's 'model' axis is the port's dim."""
    tree = jax.tree.map(np.asarray, jmodels.init_lifter(jax.random.PRNGKey(1), 11,
                                                        use_layernorm=True, hidden=HID))
    specs = jparallel.tp_param_specs(tree)
    port = parallel.tp_param_specs(Lifter(11, HID, use_layernorm=True))
    want = {}
    for name in port:
        *path, field = name.split(".")
        path = [{"bn1": "ln1", "bn2": "ln2"}.get(p, p) for p in path]
        leaf = {"weight": "w" if "ln" not in path[-1] else "scale", "bias": "b"}[field]
        leaf = "bias" if leaf == "b" and "ln" in path[-1] else leaf
        spec = functools.reduce(lambda t, k: t[k], [*path, leaf], specs)
        axes = list(spec) + [None] * (1 if leaf == "w" else 0)
        want[name] = (None if "model" not in axes
                      else 1 - axes.index("model") if leaf == "w" else 0)
    assert port == want
    assert {d for d in port.values()} == {None, 0, 1}


# --------------------------------------------------------------------------
# against one process of the port


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("world", WORLDS)
def test_zero_matches_one_process(runs, world, stage, policy):
    """One ZeRO step of 3a, 3b and stage 4 on W ranks against the one-process
    step on the same global batch and draws: the loss terms (averaged over
    the ranks) and the gathered parameters after Adam, on every rank."""
    _, want, got = runs(world)
    tol = F32_TOL if policy == "f32" else BF16_TOL
    for rank in range(world):
        _assert_close_to_one_process(got[rank]["zero", stage, policy], want["zero", stage, policy],
                                     tol, (stage, policy, world, rank))


@pytest.mark.parametrize("world", WORLDS)
def test_zero_shards_and_pads(runs, world):
    """Each rank holds padded / W elements of the flat parameters; 3b's
    120,019 parameters leave a nonzero pad at both worlds; the padded lanes
    stay exactly 0 after the steps; and a state gathered and sharded again
    (``init_zero_state(state=...)``) is the same state."""
    cases, _, got = runs(world)
    zero = [name for name in cases if cases[name]["kind"] == "zero"]
    for name in zero:
        shards = [got[r][name]["shard"] for r in range(world)]
        padded = got[0][name]["padded"]
        assert all(s.numel() == padded // world for s in shards), name
        flat = torch.cat(shards)
        size = sum(p.numel() for p in cases[name]["model"].parameters())
        assert padded - size == got[0][name]["pad"] < world and padded % world == 0
        assert torch.equal(flat[size:], torch.zeros(padded - size)), name
        again = got[0][name]["round_trip"]
        for key in ("params", "mu", "nu"):
            assert all(torch.equal(a, b) for a, b in zip(again[key], got[0][name][key])), key
    assert got[0]["zero", "3b", "f32"]["pad"] > 0


def test_zero_clip_uses_the_global_norm(runs):
    """Stage 1 with ``clip_grad_norm=1.0``, 3 ZeRO steps on 2 ranks against
    one process, within the F32 bounds. The clip is active (the gradient's
    norm exceeds 1), and a control in which each shard is clipped by its own
    norm (W Adams over the one process's gradients) misses the one
    process's parameters by more than 10 times the bound (observed 72
    times)."""
    cases, want, got = runs(2)
    case = cases["clip"]
    for rank in range(2):
        _assert_close_to_one_process(got[rank]["clip"], want["clip"], F32_TOL, rank)
    model = copy.deepcopy(case["model"])
    params = list(model.parameters())
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    shards = [s.clone() for s in flat.chunk(2)]
    opts = [Adam([s], case["cfg"].optim, 2) for s in shards]
    grads_fn = steps.build_full_flow_grads(case["cfg"])
    norms = []
    for batch, draws in zip(case["batches"], case["draws"]):
        with torch.no_grad():
            for p, v in zip(params, torch.cat(shards).split([p.numel() for p in params])):
                p.copy_(v.view_as(p))
        _, grads = grads_fn(model, batch, draws)
        g = torch.cat([t.reshape(-1) for t in grads])
        norms.append(float(g.norm()))
        for opt, part in zip(opts, g.chunk(2)):
            opt.step([part.clone()])
    want_flat = torch.cat([p.reshape(-1) for p in want["clip"]["params"]])
    assert min(norms) > 1.0, norms
    assert float((torch.cat(shards) - want_flat).abs().max()) > 10 * F32_TOL["param"]


@pytest.mark.parametrize("policy", (*POLICIES, "layernorm"))
@pytest.mark.parametrize("world", WORLDS)
def test_tp_matches_one_process(runs, world, policy):
    """One 3a step on a (1, 2) (W = 2) or (2, 2) (W = 4) layout against the
    one-process step, under each policy and with LayerNorm lifters (f32; bn1
    split on features, its statistics summed over 'model'): the loss terms
    and the parameters gathered over 'model', on every rank."""
    _, want, got = runs(world)
    tol = BF16_TOL if policy == "bf16" else F32_TOL
    for rank in range(world):
        _assert_close_to_one_process(got[rank]["tp", policy], want["tp", policy], tol,
                                     (policy, world, rank))


@pytest.mark.parametrize("world", WORLDS)
def test_tp_layout_and_replicated_parameters(runs, world):
    """After 3 bf16 steps of 3a: rank r sits at (r // n_model, r % n_model);
    every replicated parameter is bitwise equal on every rank (both 'model'
    ranks compute the same gradient, and 'data' averages it alike), each
    ``l1`` weight holds H / 2 of its rows and each ``l2`` weight H / 2 of
    its columns; the first step's loss terms and the parameters match the
    one process (``BF16_STEPS_TOL``)."""
    cases, want, got = runs(world)
    n_data, n_model = MESHES[world]
    specs = list(parallel.tp_param_specs(cases["tp steps"]["model"]).values())
    names = list(parallel.tp_param_specs(cases["tp steps"]["model"]))
    for r in range(world):
        res = got[r]["tp steps"]
        assert res["coords"] == {"data": r // n_model, "model": r % n_model}
        for name, dim, mine, first in zip(names, specs, res["local"], got[0]["tp steps"]["local"]):
            if dim is None:
                assert torch.equal(mine, first), (name, r)
            if name.endswith("l1.weight"):
                assert tuple(mine.shape) == (HID // 2, HID), name
            if name.endswith("l2.weight"):
                assert tuple(mine.shape) == (HID, HID // 2), name
        _assert_close_to_one_process(res, want["tp steps"], BF16_STEPS_TOL, r)


def test_tp_refuses_a_width_the_model_size_does_not_divide():
    """A lifter of hidden 64 split over 3 'model' ranks: ValueError, before
    any parameter is touched."""
    model = Lifter(11, HID)
    before = [p.clone() for p in model.parameters()]
    layout = parallel.Layout(("data", "model"), (parallel.Group(0, 1, torch.device("cpu")),
                                                 parallel.Group(0, 3, torch.device("cpu"))))
    with pytest.raises(ValueError, match="not a multiple of the model size 3"):
        parallel.tp_shard_(model, layout)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), before))
    assert model.upscale.tp is None


@pytest.mark.parametrize("name", ["pp grad", "pp bf16"])
def test_pipeline_matches_one_process(runs, name):
    """The trunk on 4 stages against the port's sequential trunk in one
    process: outputs, the gradient with respect to x (on every stage) and
    each stage's block gradients, f32 within JAX's trunk bounds, bf16 within
    a relative L2 error of 1e-2 per gradient."""
    cases, want, got = runs(4)
    bf16 = cases[name]["bf16"]
    for r in range(4):
        res = got[r][name]
        np.testing.assert_allclose(res["out"].numpy(), want[name]["out"].numpy(), **TRUNK_OUT)
        pairs = [(res["gx"], want[name]["gx"])] + [
            (a, b) for i, gs in res["grads"].items() for a, b in zip(gs, want[name]["grads"][i])]
        for a, b in pairs:
            if bf16:
                assert _rel(a, b) < TRUNK_BF16_GRAD_REL, (r, _rel(a, b))
            else:
                np.testing.assert_allclose(a.numpy(), b.numpy(), **TRUNK_GRAD)
        depth = len(cases[name]["blocks"])
        assert sorted(res["grads"]) == list(range(r * depth // 4, (r + 1) * depth // 4))
