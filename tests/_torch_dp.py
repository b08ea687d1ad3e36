"""Training-step cases that tests/test_torch_parallel.py runs on every rank
of a data-parallel group of links_tpu_torch and in the one process they are
held against. Spawned ranks import this module by name, so it imports no
jax (tests/conftest.py does)."""

import contextlib
import copy
import os

import torch

from links_tpu_torch.cli import _common as C
from links_tpu_torch.core.nn import F32
from links_tpu_torch.objectives.lifter import LifterFrozen, left_right_loss
from links_tpu_torch.train import parallel, steps
from links_tpu_torch.train.optim import Adam


@contextlib.contextmanager
def one_thread():
    """One CPU thread in this process and in each rank it spawns while the
    block runs (the tests run beside others, and ranks of many threads each
    would oversubscribe the cores); the settings are restored after."""
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        if env is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = env


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
