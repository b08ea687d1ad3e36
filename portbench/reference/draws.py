"""The random numbers of a training step, drawn by the benchmark and handed
to both sides: the program's epoch loop calls these through its ``draw``
argument, and the reference replays them from a generator seeded alike.
Each draws from ``generator`` in the order the port's ``draw_step`` and
``draw_occlusion`` do."""

from __future__ import annotations

import torch


def left_right(generator: torch.Generator, batch: int, device):
    """A lifter step's draws: the flow samples' latent noise (B, 34), the
    azimuth uniforms (2B, 1) and the elevation normals (2B, 1)."""
    return (torch.randn(batch, 34, generator=generator, device=device),
            torch.rand(2 * batch, 1, generator=generator, device=device),
            torch.randn(2 * batch, 1, generator=generator, device=device))


def occlusion(generator: torch.Generator, batch: int, device, n_rot: int):
    """A stage-4 step's draws: the rotations' uniforms (n_rot, B, 1)."""
    return torch.rand(n_rot, batch, 1, generator=generator, device=device)


def epoch_rows(generator: torch.Generator, n: int, batch: int, device) -> torch.Tensor:
    """The rows of one epoch over a pool of ``n`` poses, in step order: a
    permutation drawn first, its ragged end dropped (as the port's
    ``train/loop.py:tensor_batches`` draws it)."""
    return torch.randperm(n, generator=generator, device=device)[: n // batch * batch]
