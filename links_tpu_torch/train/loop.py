"""The epoch loop (counterpart of links_tpu/train/loop.py): a fresh
permutation of the training set from the generator each epoch, the ragged
remainder dropped, one step per batch, and the mean of each loss term over
the epoch. The batches come from a tensor on the device or from a batch
source such as the packed feed (train/feed.py).

With a data-parallel ``group`` (train/parallel.py) every rank draws the same
permutation (every rank's generator is seeded alike) and steps on its rows
of each global batch; the epoch's loss means are averaged over the ranks."""

from __future__ import annotations

from typing import Callable

import torch

from links_tpu_torch.train import parallel
from links_tpu_torch.train.profiling import span
from links_tpu_torch.train.steps import TrainState, draw_step


def tensor_batches(data: torch.Tensor, batch_size: int, generator: torch.Generator,
                   group: parallel.Group | None = None):
    """Yield one epoch's batches of ``data`` (N, 34): the permutation drawn
    from ``generator`` at the first batch, the ragged remainder dropped;
    with a ``group``, this rank's rows of each."""
    n = data.shape[0]
    nb = n // batch_size
    if nb < 1:
        raise ValueError(f"{n} training poses make no batch of {batch_size}")
    perm = torch.randperm(n, generator=generator, device=data.device)[: nb * batch_size]
    for i in range(nb):
        idx = perm[i * batch_size:(i + 1) * batch_size]
        yield data[idx if group is None else parallel.rows(idx, group)]


def run_epoch(step_fn: Callable, state: TrainState, data, batch_size: int,
              generator: torch.Generator, draw: Callable = draw_step,
              group: parallel.Group | None = None) -> dict[str, float]:
    """One epoch over ``data``: an (N, 34) tensor on its device, or a batch
    source with a ``device`` and ``batches(batch_size, generator, group)``
    (the packed feed). The epoch's permutation (or shuffle seed) is drawn
    from ``generator`` first; then, before each step, that step's random
    numbers with ``draw(generator, batch_size, device)`` (the lifter stages'
    ``draw_step`` by default; ``steps.draw_noise`` for the flow stages).
    ``batch_size`` is the global batch: with a ``group`` each step gets this
    rank's rows of it and the global draws. Reads the loss means back to the
    host once, at the end. Each step's draws run in the span ``train.draw``,
    the read-back in ``train.readback``."""
    batches = (tensor_batches(data, batch_size, generator, group)
               if isinstance(data, torch.Tensor) else data.batches(batch_size, generator, group))
    sums, nb = {}, 0
    for batch in batches:
        with span("train.draw"):
            draws = draw(generator, batch_size, data.device)
        for k, v in step_fn(state, batch, draws).items():
            sums[k] = sums[k] + v if k in sums else v
        nb += 1
    with span("train.readback"):
        means = torch.stack(list(sums.values())) / nb
        if group is not None:
            parallel.all_reduce_mean_([means], group)
        means = means.tolist()
    return dict(zip(sums, means))
