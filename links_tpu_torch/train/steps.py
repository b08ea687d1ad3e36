"""The training steps of stages 1, 2, 3a, 3b and 4 (counterpart of
links_tpu/train/steps.py): each step computes its stage's loss (with the
sample augmentation inside it), the gradient of every parameter of the
trained model, and the Adam update.

The trained model is a ``Flow`` (stage 1), a ``PartFlows`` (stage 2), a
``StackedLifter`` (3a), a ``LegTorsoLifter`` (3b) or a ``Completers`` (4);
its ``parameters()`` order is the order of the gradients and of ``Adam``'s
state. A step takes its random numbers as tensors: one (B, 34) normal for
the flow stages (``draw_noise``), a ``StepDraws`` for the lifter stages
(``draw_step``), an ``OcclusionDraws`` for stage 4 (``draw_occlusion``).

Data parallelism (train/parallel.py): with a ``group`` a step takes this
rank's rows of the global batch and the step's global draws, of which it
keeps its own rows (``shard_draws``); the lifter losses read the elevation
statistics of the global batch, and the gradients are averaged over the
ranks before Adam (whose global-norm clip thus sees the global gradient).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from links_tpu_torch import flows
from links_tpu_torch.core.nn import BF16, F32
from links_tpu_torch.objectives import flow_nll
from links_tpu_torch.objectives import lifter as lifter_obj
from links_tpu_torch.objectives import occlusion as occ_obj
from links_tpu_torch.train import parallel
from links_tpu_torch.train.optim import Adam
from links_tpu_torch.train.profiling import span


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    opt: Adam
    step: int = 0


class StepDraws(NamedTuple):
    """The random numbers of one lifter step: the latent noise of the flow
    samples (B, 34), and the rotation's azimuth and elevation draws (2B, 1)
    each."""

    eps_noise: torch.Tensor
    u_azim: torch.Tensor
    eps_elev: torch.Tensor


def draw_step(generator: torch.Generator, batch: int, device) -> StepDraws:
    """One lifter step's draws from ``generator`` (on ``device``)."""
    return StepDraws(torch.randn(batch, 34, generator=generator, device=device),
                     torch.rand(2 * batch, 1, generator=generator, device=device),
                     torch.randn(2 * batch, 1, generator=generator, device=device))


def draw_noise(generator: torch.Generator, batch: int, device) -> torch.Tensor:
    """One flow step's draw from ``generator``: the (B, 34) latent noise of
    the samples."""
    return torch.randn(batch, 34, generator=generator, device=device)


class OcclusionDraws(NamedTuple):
    """The random numbers of one stage-4 step: the rotations' uniforms
    (n_rot, B, 1), and the input noise ((n_rot + 1) B, 3, 17), or None
    without it."""

    u_rot: torch.Tensor
    eps_input: torch.Tensor | None


def draw_occlusion(generator: torch.Generator, batch: int, device, n_rot: int = 2,
                   input_noise: float = 0.0) -> OcclusionDraws:
    """One stage-4 step's draws from ``generator`` (on ``device``); the input
    noise only when ``input_noise`` is set."""
    u_rot = torch.rand(n_rot, batch, 1, generator=generator, device=device)
    eps = (torch.randn((n_rot + 1) * batch, 3, 17, generator=generator, device=device)
           if input_noise else None)
    return OcclusionDraws(u_rot, eps)


def _block_rows(x: torch.Tensor, group: parallel.Group, blocks: int) -> torch.Tensor:
    """This rank's rows of each of the ``blocks`` equal blocks of ``x``'s
    rows, concatenated in block order."""
    return torch.cat([parallel.rows(part, group) for part in x.chunk(blocks)])


def shard_draws(draws, group: parallel.Group | None):
    """This rank's part of one step's global draws (unchanged without a
    group). The global batch's rows ``[r b, (r + 1) b)`` are rank r's (b =
    B / W), so: the latent noise (B, 34), those rows; the rotation draws
    (2B, 1) index the augmented batch ``[real; samples]``, so those rows of
    each half; stage 4's ``u_rot`` (n_rot, B, 1), those rows of each
    rotation; its ``eps_input`` ((n_rot + 1) B, 3, 17), those rows of each of
    the n_rot + 1 orientation blocks."""
    if group is None:
        return draws
    if isinstance(draws, StepDraws):
        return StepDraws(parallel.rows(draws.eps_noise, group),
                         _block_rows(draws.u_azim, group, 2),
                         _block_rows(draws.eps_elev, group, 2))
    if isinstance(draws, OcclusionDraws):
        u_rot = parallel.rows(draws.u_rot.transpose(0, 1), group).transpose(0, 1)
        eps = (None if draws.eps_input is None
               else _block_rows(draws.eps_input, group, draws.u_rot.shape[0] + 1))
        return OcclusionDraws(u_rot, eps)
    return parallel.rows(draws, group)


def _policy(cfg):
    return BF16 if cfg.bf16 else F32


def _grads(loss_fn: Callable) -> Callable:
    """``loss_fn(model, batch, draws) -> (loss, aux)`` -> ``grads(model,
    batch, draws) -> (aux, grads)``: the loss terms (detached) and the
    gradient of every parameter, in ``model.parameters()`` order. The loss
    (with its augmentation) runs in the span ``train.forward``, the
    gradient in ``train.backward``."""
    def grads(model: torch.nn.Module, batch: torch.Tensor, draws):
        with span("train.forward"):
            loss, aux = loss_fn(model, batch, draws)
        with span("train.backward"):
            g = torch.autograd.grad(loss, list(model.parameters()))
        return {k: v.detach() for k, v in aux.items()}, g

    return grads


def _step(grads_fn: Callable, group: parallel.Group | None = None) -> Callable:
    """-> ``step(state, batch, draws) -> aux``: one update of ``state.model``
    (``state.opt`` holds its parameters in order). With a ``group``,
    ``batch`` is this rank's rows of the global batch and ``draws`` the
    step's global draws; the aux terms are this rank's. The gradients' mean
    over the ranks runs in the span ``train.all_reduce``, Adam in
    ``train.optim``."""
    def step(state: TrainState, batch: torch.Tensor, draws) -> dict:
        aux, grads = grads_fn(state.model, batch, shard_draws(draws, group))
        if group is not None:
            with span("train.all_reduce"):
                parallel.all_reduce_mean_(grads, group)
        with span("train.optim"):
            state.opt.step(grads)
        state.step += 1
        return aux

    return step


def build_full_flow_grads(cfg) -> Callable:
    """Stage 1: the full-pose flow's NLL on the batch and on its own samples
    (``draws``: the (B, 34) latent noise). ``cfg``: a ``FlowTrainConfig``."""
    policy = _policy(cfg)
    return _grads(lambda flow, batch, eps: flow_nll.full_flow_loss(
        flow, batch, eps, cfg.noise_factor, policy, cfg.nll_cap))


def build_full_flow_step(cfg, group: parallel.Group | None = None) -> Callable:
    return _step(build_full_flow_grads(cfg), group)


def build_part_flows_grads(full_flow: flows.Flow, cfg) -> Callable:
    """Stage 2: the four part flows (a ``PartFlows``) on the batch's splits
    and on the splits of the frozen ``full_flow``'s samples. ``cfg``: a
    ``PartFlowTrainConfig``."""
    policy = _policy(cfg)
    return _grads(lambda parts, batch, eps: flow_nll.part_flows_loss(
        parts, full_flow, batch, eps, cfg.noise_factor, policy, cfg.nll_cap))


def build_part_flows_step(full_flow: flows.Flow, cfg,
                          group: parallel.Group | None = None) -> Callable:
    return _step(build_part_flows_grads(full_flow, cfg), group)


def build_left_right_grads(frozen: lifter_obj.LifterFrozen, cfg, bone_relations_mean=None,
                           group: parallel.Group | None = None) -> Callable:
    """Stage 3a: both side lifters (a ``StackedLifter``) on the batch
    augmented with samples of the frozen full flow. ``cfg``: a
    ``LifterTrainConfig``; ``bone_relations_mean`` and ``group`` (the
    global elevation statistics) as ``left_right_loss``."""
    policy = _policy(cfg)

    def loss_fn(model, batch: torch.Tensor, draws: StepDraws):
        inp = lifter_obj.augment_with_samples(frozen.full_flow, batch, draws.eps_noise,
                                              cfg.noise_factor, policy)
        return lifter_obj.left_right_loss(model, frozen, inp, draws.u_azim, draws.eps_elev,
                                          cfg, policy, bone_relations_mean, group)

    return _grads(loss_fn)


def build_left_right_step(frozen: lifter_obj.LifterFrozen, cfg, bone_relations_mean=None,
                          group: parallel.Group | None = None) -> Callable:
    return _step(build_left_right_grads(frozen, cfg, bone_relations_mean, group), group)


def build_leg_torso_grads(frozen: lifter_obj.LifterFrozen, cfg, bone_relations_mean=None,
                          group: parallel.Group | None = None) -> Callable:
    """Stage 3b: the legs and torso lifters (a ``LegTorsoLifter``) on the
    batch augmented with samples of the frozen full flow, against the frozen
    legs and torso flows. ``bone_relations_mean`` and ``group`` as
    ``leg_torso_loss``."""
    policy = _policy(cfg)

    def loss_fn(model, batch: torch.Tensor, draws: StepDraws):
        inp = lifter_obj.augment_with_samples(frozen.full_flow, batch, draws.eps_noise,
                                              cfg.noise_factor, policy)
        return lifter_obj.leg_torso_loss(model.legs, model.torso, frozen, inp, draws.u_azim,
                                         draws.eps_elev, cfg, policy, bone_relations_mean,
                                         group)

    return _grads(loss_fn)


def build_leg_torso_step(frozen: lifter_obj.LifterFrozen, cfg, bone_relations_mean=None,
                         group: parallel.Group | None = None) -> Callable:
    return _step(build_leg_torso_grads(frozen, cfg, bone_relations_mean, group), group)


def build_occlusion_grads(legs, torso, cfg) -> Callable:
    """Stage 4: the eight completers (a ``Completers``) against the
    pseudo-3D of the frozen ``legs`` and ``torso`` ``Lifter``s (computed
    without a gradient). ``cfg``: an ``OcclusionTrainConfig``."""
    policy = _policy(cfg)

    def loss_fn(model, batch: torch.Tensor, draws: OcclusionDraws):
        with torch.no_grad():
            pose_3d = occ_obj.pseudo_3d_from_lifters(legs, torso, batch, cfg.depth, policy)
        return occ_obj.occlusion_loss(model, pose_3d, draws.u_rot, draws.eps_input, policy,
                                      cfg.input_noise)

    return _grads(loss_fn)


def build_occlusion_step(legs, torso, cfg, group: parallel.Group | None = None) -> Callable:
    return _step(build_occlusion_grads(legs, torso, cfg), group)
