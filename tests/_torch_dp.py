"""Training-step cases that tests/test_torch_parallel.py runs on every rank
of a data-parallel group of links_tpu_torch and in the one process they are
held against, and the ZeRO, tensor-parallel and pipeline cases of
tests/test_torch_zero_tp_pp.py. Spawned ranks import this module by name, so
it imports no jax (tests/conftest.py does)."""

import copy

import torch

from links_tpu_torch.cli import _common as C
from links_tpu_torch.core.nn import BF16, F32, leaky_relu
from links_tpu_torch.objectives.lifter import LifterFrozen, left_right_loss
from links_tpu_torch.train import parallel, steps
from links_tpu_torch.train.optim import Adam


def _grads_fn(case: dict, group):
    stage, frozen, cfg = case["stage"], case["frozen"], case["cfg"]
    if stage == "1":
        return steps.build_full_flow_grads(cfg)
    if stage == "2":
        return steps.build_part_flows_grads(frozen[0], cfg)
    if stage == "3a":
        return steps.build_left_right_grads(LifterFrozen(*frozen), cfg, None, group)
    if stage == "3b":
        return steps.build_leg_torso_grads(LifterFrozen(*frozen), cfg, None, group)
    return steps.build_occlusion_grads(*frozen, cfg)


def _step_fn(case: dict, group):
    stage, frozen, cfg = case["stage"], case["frozen"], case["cfg"]
    if stage == "1":
        return steps.build_full_flow_step(cfg, group)
    if stage == "2":
        return steps.build_part_flows_step(frozen[0], cfg, group)
    if stage == "3a":
        return steps.build_left_right_step(LifterFrozen(*frozen), cfg, None, group)
    if stage == "3b":
        return steps.build_leg_torso_step(LifterFrozen(*frozen), cfg, None, group)
    return steps.build_occlusion_step(*frozen, cfg, group)


def _local(batch: torch.Tensor, group) -> torch.Tensor:
    return batch if group is None else parallel.rows(batch, group)


def run_case(case: dict, group=None) -> dict:
    """One case (``stage``: "1", "2", "3a", "3b" or "4"; ``model``;
    ``frozen``: the stage's frozen modules; ``cfg``; ``batches`` and
    ``draws``: global batches and each step's global draws; optional
    ``local_stats``: 3a's gradient with each rank's own elevation statistics;
    optional ``validate``: 3a's unsupervised validation of ``test_2d``) on
    this rank of ``group``, or in one process without one. -> the first
    step's loss terms and gradients (averaged over the ranks) and the
    parameters after every step."""
    model = copy.deepcopy(case["model"])
    if case.get("validate"):
        frozen, cfg = LifterFrozen(*case["frozen"]), case["cfg"]
        return C.validate_unsup(lambda p, u, e: left_right_loss(model, frozen, p, u, e, cfg, F32),
                                case["test_2d"])
    grads_fn = _grads_fn(case, None if case.get("local_stats") else group)
    aux, grads = grads_fn(model, _local(case["batches"][0], group),
                          steps.shard_draws(case["draws"][0], group))
    aux = torch.stack(list(aux.values())), list(aux)
    if group is not None:
        parallel.all_reduce_mean_([*grads, aux[0]], group)
    out = {"aux": dict(zip(aux[1], aux[0].tolist())), "grads": [g.clone() for g in grads]}
    if case.get("local_stats"):
        return out
    state = steps.TrainState(model, Adam(model.parameters(), case["cfg"].optim, 2))
    step = _step_fn(case, group)
    for batch, draws in zip(case["batches"], case["draws"]):
        step(state, _local(batch, group), draws)
    out["params"] = [p.detach().clone() for p in model.parameters()]
    return out


def worker(case_path: str, out_path: str, group):
    """Run every case of ``case_path`` (a ``torch.save``d dict name -> case)
    on this rank; write the results to ``out_path`` formatted with the rank."""
    cases = torch.load(case_path, weights_only=False)
    torch.save({name: run_case(case, group) for name, case in cases.items()},
               out_path.format(rank=group.rank))


def _mean_aux(aux: dict, group) -> dict:
    """The loss terms averaged over ``group``'s ranks."""
    vals = torch.stack(list(aux.values()))
    parallel.all_reduce_mean_([vals], group)
    return dict(zip(aux, vals.tolist()))


def run_zero(case: dict, group) -> dict:
    """A ``run_case`` case's steps on this rank of ``group`` with the
    ZeRO-sharded step: each step's loss terms (averaged over the ranks), the
    gathered state after the last step (``zero_gather``), this rank's shard
    of the flat parameters and the pad."""
    model = copy.deepcopy(case["model"])
    state = parallel.init_zero_state(model, case["cfg"].optim, group, 2)
    step = parallel.dp_zero_step(_grads_fn(case, group), model, group)
    losses = [_mean_aux(step(state, _local(batch, group), draws), group)
              for batch, draws in zip(case["batches"], case["draws"])]
    out = parallel.zero_gather(state, model, group)
    again = parallel.zero_gather(parallel.init_zero_state(model, case["cfg"].optim, group, 2,
                                                          state=out), model, group)
    return dict(out, losses=losses, aux=losses[0], shard=state.flat_params.clone(),
                pad=state.pad, padded=state.padded, round_trip=again)


def run_tp(case: dict, group) -> dict:
    """A 3a case's steps on this rank of a ``case["mesh"]`` = (n_data,
    n_model) layout with the DP x TP step: each step's loss terms (averaged
    over 'data'), the parameters and Adam moments after the last step
    gathered over 'model', this rank's own parameters and its coordinates."""
    layout = parallel.make_mesh_2d(*case["mesh"], group)
    data = layout["data"]
    model = parallel.tp_shard_(copy.deepcopy(case["model"]), layout)
    specs = list(parallel.tp_param_specs(model).values())
    state = steps.TrainState(model, Adam(model.parameters(), case["cfg"].optim, 2))
    step = parallel.dp_tp_step(_grads_fn(case, data), model, layout)
    losses = [_mean_aux(step(state, _local(batch, data), draws), data)
              for batch, draws in zip(case["batches"], case["draws"])]
    full = {k: parallel.tp_gather(v, specs, layout["model"]) for k, v in
            (("params", model.parameters()), ("mu", state.opt.mu), ("nu", state.opt.nu))}
    return dict(full, losses=losses, aux=losses[0], coords=layout.coords,
                local=[p.detach().clone() for p in model.parameters()])


def run_pp(case: dict, group) -> dict:
    """The GPipe trunk on this stage of a ``group.world``-stage pipe: the
    output, the gradients of the mean squared distance to ``target`` with
    respect to ``x`` and to this stage's blocks (by depth index). The blocks
    other stages hold go to the meta device first: a stage reads only its
    own."""
    layout = parallel.make_mesh_pipe(group.world, group)
    blocks = copy.deepcopy(case["blocks"])
    held = parallel.pp_trunk_sharding(layout, blocks)
    for i in range(len(blocks)):
        if i not in held:
            blocks[i].to("meta")
    x = case["x"].clone().requires_grad_(True)
    policy = BF16 if case.get("bf16") else F32
    y = parallel.pp_trunk_apply(blocks, x, layout, case["n_micro"], policy)
    params = [p for i in held for p in blocks[i].parameters()]
    gx, *grads = torch.autograd.grad(((y - case["target"]) ** 2).mean(), [x, *params])
    per = len(grads) // len(held)
    return {"out": y.detach(), "gx": gx,
            "grads": {i: grads[k * per:(k + 1) * per] for k, i in enumerate(held)}}


def sequential_trunk(blocks, x: torch.Tensor, policy=F32) -> torch.Tensor:
    """The trunk in one process: ``leaky_relu(block(h))`` block by block."""
    for block in blocks:
        x = leaky_relu(block(x, policy))
    return x


def parallel_worker(case_path: str, out_path: str, group):
    """Run every case of ``case_path`` (name -> case, each with ``"kind"``:
    "zero", "tp" or "pp") on this rank; write the results to ``out_path``
    formatted with the rank."""
    run = {"zero": run_zero, "tp": run_tp, "pp": run_pp}
    cases = torch.load(case_path, weights_only=False)
    torch.save({name: run[case["kind"]](case, group) for name, case in cases.items()},
               out_path.format(rank=group.rank))
