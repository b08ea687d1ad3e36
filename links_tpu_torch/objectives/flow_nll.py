"""Flow NLL objectives of stages 1 and 2 (counterpart of
links_tpu/objectives/flow_nll.py).

Stage 1: the full-pose flow minimizes the NLL of real 2D poses plus the NLL
of its own samples around them (perturbed latents, decoded without a
gradient). Stage 2: the four part flows (left and right sides 22-d, legs 14,
torso 20) minimize the NLL of the matching splits of real poses and of
samples drawn from the frozen full-pose flow.

The samples' latent noise ``eps`` is a (B, 34) standard-normal tensor the
caller gives: torch cannot reproduce jax.random, and the tests hand both
packages the same numbers.
"""

from __future__ import annotations

import torch
from torch import nn

from links_tpu_torch import flows
from links_tpu_torch.core.nn import F32, Policy
from links_tpu_torch.core.skeleton import split_data_left_right, split_data_legs_torso

# The part flows in the order of their parameters (and of the stage-2 artifacts).
PARTS = ("left", "right", "legs", "torso")


class PartFlows(nn.Module):
    """The four part flows of stage 2, registered in ``PARTS`` order, which
    fixes the order of ``parameters()``."""

    def __init__(self, left: flows.Flow, right: flows.Flow, legs: flows.Flow,
                 torso: flows.Flow):
        super().__init__()
        self.left, self.right, self.legs, self.torso = left, right, legs, torso


def _nll_mean(flow: flows.Flow, x: torch.Tensor, policy: Policy, nll_cap: float):
    return flows.nll_mean(*flows.forward(flow, x, policy), nll_cap)


def full_flow_loss(flow: flows.Flow, poses: torch.Tensor, eps: torch.Tensor,
                   noise_factor: float = 0.2, policy: Policy = F32, nll_cap: float = 0.0):
    """Stage-1 loss of ``flow`` on (B, 34) poses: mean NLL(real) + mean
    NLL(self-samples). ``nll_cap`` > 0 soft-caps each per-sample NLL.
    -> (loss, aux) with the JAX package's aux keys."""
    dist_2d = _nll_mean(flow, poses, policy, nll_cap)
    samples = flows.draw_samples(flow, poses, eps, noise_factor, policy=policy)
    dist_2d_sample = _nll_mean(flow, samples, policy, nll_cap)
    loss = dist_2d + dist_2d_sample
    return loss, {"dist_2d": dist_2d, "dist_2d_sample": dist_2d_sample, "loss": loss}


def part_flows_loss(part_flows: PartFlows, full_flow: flows.Flow, poses: torch.Tensor,
                    eps: torch.Tensor, noise_factor: float = 0.2, policy: Policy = F32,
                    nll_cap: float = 0.0):
    """Stage-2 loss of the four part flows on (B, 34) poses and one draw of
    samples from the frozen ``full_flow``. -> (loss, aux) with the JAX
    package's aux keys (``dist_2d_<part>`` and ``dist_2d_<part>_sample``).
    The JAX package runs left and right as one vmap; one after the other
    computes the same."""
    samples = flows.draw_samples(full_flow, poses, eps, noise_factor, policy=policy)
    aux, sums = {}, []
    for source, x in (("", poses), ("_sample", samples)):
        parts = dict(zip(PARTS, split_data_left_right(x) + split_data_legs_torso(x)))
        terms = [_nll_mean(getattr(part_flows, name), parts[name], policy, nll_cap)
                 for name in PARTS]
        aux.update({f"dist_2d_{name}{source}": v for name, v in zip(PARTS, terms)})
        sums.append(sum(terms))
    loss = sums[0] + sums[1]
    aux["loss"] = loss
    return loss, aux
