"""Flow sequence functions (counterpart of links_tpu/flows/sequence.py):
forward and inverse over the block stack, the per-sample NLL, its soft cap,
and generative sampling around a data batch."""

from __future__ import annotations

import torch

from links_tpu_torch.core.geometry import add_noise
from links_tpu_torch.core.nn import F32, Policy
from links_tpu_torch.flows.coupling import Flow


def forward(flow: Flow, x: torch.Tensor, policy: Policy = F32):
    """x -> (z, log|det J|), through the blocks front to back."""
    logdet = torch.zeros(x.shape[0], device=x.device)
    for block in flow.module_list:
        x, j = block(x, policy)
        logdet = logdet + j
    return x, logdet


def inverse(flow: Flow, z: torch.Tensor, policy: Policy = F32):
    """z -> (x, log|det J^-1|), through the blocks back to front."""
    logdet = torch.zeros(z.shape[0], device=z.device)
    for block in reversed(flow.module_list):
        z, j = block.inverse(z, policy)
        logdet = logdet + j
    return z, logdet


def nll(z: torch.Tensor, logdet: torch.Tensor) -> torch.Tensor:
    """Per-sample negative log-likelihood up to constants: 0.5 |z|^2 - logdet."""
    return 0.5 * torch.sum(z ** 2, dim=-1) - logdet


def soft_cap_nll(v: torch.Tensor, cap: float) -> torch.Tensor:
    """Identity below ``cap``, cap + log1p(v - cap) above (monotone, C1)."""
    over = torch.clamp(v - cap, min=0.0)
    return torch.where(v > cap, cap + torch.log1p(over), v)


def nll_mean(z: torch.Tensor, logdet: torch.Tensor, cap: float = 0.0) -> torch.Tensor:
    """The mean per-sample NLL, each soft-capped at ``cap`` unless it is 0."""
    v = nll(z, logdet)
    if cap:
        v = soft_cap_nll(v, cap)
    return v.mean()


@torch.no_grad()
def draw_samples(flow: Flow, x: torch.Tensor, eps: torch.Tensor, noise_factor: float = 0.2,
                 policy: Policy = F32, zero_root: bool = True) -> torch.Tensor:
    """Encode ``x``, perturb the latents with the standard-normal draw
    ``eps`` (x's shape), decode, and (with ``zero_root``) pin the root joint
    to the origin. No gradient flows into the sampler."""
    z, _ = forward(flow, x, policy)
    samples, _ = inverse(flow, add_noise(z, noise_factor, eps), policy)
    if not zero_root:
        return samples
    nj = samples.shape[-1] // 2
    samples = samples.reshape(-1, 2, nj).clone()
    samples[:, :, 0] = 0.0
    return samples.reshape(-1, 2 * nj)
