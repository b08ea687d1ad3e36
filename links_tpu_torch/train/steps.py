"""The stage-3a training step (counterpart of links_tpu/train/steps.py):
augment the batch with frozen-flow samples, the five-loss objective, its
gradient, and the Adam update, for both side lifters at once."""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from links_tpu_torch.config import LifterTrainConfig
from links_tpu_torch.core.nn import BF16, F32
from links_tpu_torch.models.lifters import StackedLifter
from links_tpu_torch.objectives import lifter as lifter_obj
from links_tpu_torch.train.optim import Adam


@dataclasses.dataclass
class TrainState:
    model: StackedLifter
    opt: Adam
    step: int = 0


class StepDraws(NamedTuple):
    """The random numbers of one step: the latent noise of the flow samples
    (B, 34), and the rotation's azimuth and elevation draws (2B, 1) each."""

    eps_noise: torch.Tensor
    u_azim: torch.Tensor
    eps_elev: torch.Tensor


def draw_step(generator: torch.Generator, batch: int, device) -> StepDraws:
    """One step's draws from ``generator`` (on ``device``)."""
    return StepDraws(torch.randn(batch, 34, generator=generator, device=device),
                     torch.rand(2 * batch, 1, generator=generator, device=device),
                     torch.randn(2 * batch, 1, generator=generator, device=device))


def build_left_right_grads(frozen: lifter_obj.LifterFrozen, cfg: LifterTrainConfig) -> Callable:
    """-> ``grads(model, batch, draws) -> (aux, grads)``: the loss terms
    (detached) and the gradient of every parameter of the ``StackedLifter``,
    in ``model.parameters()`` order, for a (B, 34) batch."""
    policy = BF16 if cfg.bf16 else F32

    def grads(model: StackedLifter, batch: torch.Tensor, draws: StepDraws):
        inp = lifter_obj.augment_with_samples(frozen.full_flow, batch, draws.eps_noise,
                                              cfg.noise_factor, policy)
        loss, aux = lifter_obj.left_right_loss(model, frozen, inp, draws.u_azim,
                                               draws.eps_elev, cfg, policy)
        return ({k: v.detach() for k, v in aux.items()},
                torch.autograd.grad(loss, list(model.parameters())))

    return grads


def build_left_right_step(frozen: lifter_obj.LifterFrozen, cfg: LifterTrainConfig) -> Callable:
    """-> ``step(state, batch, draws) -> aux``: one update of both side
    lifters on a (B, 34) batch (``state.opt`` holds ``state.model``'s
    parameters in order)."""
    grads_fn = build_left_right_grads(frozen, cfg)

    def step(state: TrainState, batch: torch.Tensor, draws: StepDraws) -> dict:
        aux, grads = grads_fn(state.model, batch, draws)
        state.opt.step(grads)
        state.step += 1
        return aux

    return step
