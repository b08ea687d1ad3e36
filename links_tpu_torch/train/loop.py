"""The epoch loop (counterpart of links_tpu/train/loop.py): a fresh
permutation of the training set from the generator each epoch, the ragged
remainder dropped, one step per batch, and the mean of each loss term over
the epoch."""

from __future__ import annotations

from typing import Callable

import torch

from links_tpu_torch.train.steps import TrainState, draw_step


def run_epoch(step_fn: Callable, state: TrainState, data: torch.Tensor, batch_size: int,
              generator: torch.Generator, draw: Callable = draw_step) -> dict[str, float]:
    """One epoch over ``data`` (N, 34) on its device. Draws the permutation
    and then, before each step, that step's random numbers from
    ``generator`` with ``draw(generator, batch_size, device)`` (the lifter
    stages' ``draw_step`` by default; ``steps.draw_noise`` for the flow
    stages). Reads the loss means back to the host once, at the end."""
    n = data.shape[0]
    nb = n // batch_size
    if nb < 1:
        raise ValueError(f"{n} training poses make no batch of {batch_size}")
    perm = torch.randperm(n, generator=generator, device=data.device)[: nb * batch_size]
    sums = {}
    for i in range(nb):
        batch = data[perm[i * batch_size:(i + 1) * batch_size]]
        draws = draw(generator, batch_size, data.device)
        for k, v in step_fn(state, batch, draws).items():
            sums[k] = sums[k] + v if k in sums else v
    means = (torch.stack(list(sums.values())) / nb).tolist()
    return dict(zip(sums, means))
