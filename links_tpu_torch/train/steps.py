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
from links_tpu_torch.train.optim import Adam


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


def _policy(cfg):
    return BF16 if cfg.bf16 else F32


def _grads(loss_fn: Callable) -> Callable:
    """``loss_fn(model, batch, draws) -> (loss, aux)`` -> ``grads(model,
    batch, draws) -> (aux, grads)``: the loss terms (detached) and the
    gradient of every parameter, in ``model.parameters()`` order."""
    def grads(model: torch.nn.Module, batch: torch.Tensor, draws):
        loss, aux = loss_fn(model, batch, draws)
        return ({k: v.detach() for k, v in aux.items()},
                torch.autograd.grad(loss, list(model.parameters())))

    return grads


def _step(grads_fn: Callable) -> Callable:
    """-> ``step(state, batch, draws) -> aux``: one update of ``state.model``
    (``state.opt`` holds its parameters in order)."""
    def step(state: TrainState, batch: torch.Tensor, draws) -> dict:
        aux, grads = grads_fn(state.model, batch, draws)
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


def build_full_flow_step(cfg) -> Callable:
    return _step(build_full_flow_grads(cfg))


def build_part_flows_grads(full_flow: flows.Flow, cfg) -> Callable:
    """Stage 2: the four part flows (a ``PartFlows``) on the batch's splits
    and on the splits of the frozen ``full_flow``'s samples. ``cfg``: a
    ``PartFlowTrainConfig``."""
    policy = _policy(cfg)
    return _grads(lambda parts, batch, eps: flow_nll.part_flows_loss(
        parts, full_flow, batch, eps, cfg.noise_factor, policy, cfg.nll_cap))


def build_part_flows_step(full_flow: flows.Flow, cfg) -> Callable:
    return _step(build_part_flows_grads(full_flow, cfg))


def build_left_right_grads(frozen: lifter_obj.LifterFrozen, cfg,
                           bone_relations_mean=None) -> Callable:
    """Stage 3a: both side lifters (a ``StackedLifter``) on the batch
    augmented with samples of the frozen full flow. ``cfg``: a
    ``LifterTrainConfig``; ``bone_relations_mean`` as ``left_right_loss``."""
    policy = _policy(cfg)

    def loss_fn(model, batch: torch.Tensor, draws: StepDraws):
        inp = lifter_obj.augment_with_samples(frozen.full_flow, batch, draws.eps_noise,
                                              cfg.noise_factor, policy)
        return lifter_obj.left_right_loss(model, frozen, inp, draws.u_azim, draws.eps_elev,
                                          cfg, policy, bone_relations_mean)

    return _grads(loss_fn)


def build_left_right_step(frozen: lifter_obj.LifterFrozen, cfg,
                          bone_relations_mean=None) -> Callable:
    return _step(build_left_right_grads(frozen, cfg, bone_relations_mean))


def build_leg_torso_grads(frozen: lifter_obj.LifterFrozen, cfg,
                          bone_relations_mean=None) -> Callable:
    """Stage 3b: the legs and torso lifters (a ``LegTorsoLifter``) on the
    batch augmented with samples of the frozen full flow, against the frozen
    legs and torso flows. ``bone_relations_mean`` as ``leg_torso_loss``."""
    policy = _policy(cfg)

    def loss_fn(model, batch: torch.Tensor, draws: StepDraws):
        inp = lifter_obj.augment_with_samples(frozen.full_flow, batch, draws.eps_noise,
                                              cfg.noise_factor, policy)
        return lifter_obj.leg_torso_loss(model.legs, model.torso, frozen, inp, draws.u_azim,
                                         draws.eps_elev, cfg, policy, bone_relations_mean)

    return _grads(loss_fn)


def build_leg_torso_step(frozen: lifter_obj.LifterFrozen, cfg,
                         bone_relations_mean=None) -> Callable:
    return _step(build_leg_torso_grads(frozen, cfg, bone_relations_mean))


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


def build_occlusion_step(legs, torso, cfg) -> Callable:
    return _step(build_occlusion_grads(legs, torso, cfg))
