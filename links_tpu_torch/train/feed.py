"""The packed streaming feed (counterpart of links_tpu/train/feed.py): a
trainer's epochs read the train split's batches from an LNKS pack
(data/native_loader.py) instead of one tensor on the device, so the split
never has to sit in host memory or on the card (``--packed-data``).

A ``PackedFeed`` is a batch source of ``train.loop.run_epoch``: its epoch
draws one shuffle seed from the trainer's generator before the steps draw
theirs, then streams chunks of ``chunk_steps`` batches in the permutation's
order. The C++ gather of chunk i + 1 runs on a worker thread (the foreign
call drops the GIL) while the steps of chunk i run; on the card each chunk
lands in pinned host memory (two buffers, each reused only after its copy
has finished) and is copied with ``non_blocking=True``. The ragged tail is
dropped, as the in-memory epoch drops it. Under data parallelism every rank
draws the same seed and gathers the same chunks, and moves only its rows of
each batch to its device.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from links_tpu_torch.data.native_loader import PackedDataset, pack_dataset
from links_tpu_torch.train import parallel

CHUNK_STEPS = 16


def open_or_pack(path, poses_2d=None) -> PackedDataset:
    """Open an LNKS pack, creating it from ``poses_2d`` when absent
    (``links_tpu_torch.cli.pack_data`` creates one explicitly)."""
    path = Path(path)
    if not path.exists():
        if poses_2d is None:
            raise FileNotFoundError(
                f"packed dataset {path} does not exist and no in-memory train split is "
                f"available to pack it from: create it with links_tpu_torch.cli.pack_data")
        path.parent.mkdir(parents=True, exist_ok=True)
        pack_dataset(path, np.asarray(poses_2d))
    return PackedDataset(path)


def shuffle_seed(generator: torch.Generator) -> int:
    """The loader's shuffle seed of one epoch: one int drawn from the
    trainer's generator (on its device), masked to 31 bits."""
    return int(torch.randint(2 ** 62, (), generator=generator,
                             device=generator.device)) & 0x7FFFFFFF


class PackedFeed:
    """The epochs of ``packed`` as batches on ``device`` (``run_epoch``'s
    batch source)."""

    def __init__(self, packed: PackedDataset, device, chunk_steps: int = CHUNK_STEPS):
        self.packed = packed
        self.device = torch.device(device)
        self.chunk_steps = chunk_steps

    def batches(self, batch_size: int, generator: torch.Generator,
                group: parallel.Group | None = None):
        """Yield one epoch's (batch_size, D) batches on the device: the
        permutation of ``shuffle_seed(generator)``, drawn at the first batch;
        with a ``group``, this rank's (batch_size / W, D) rows of each."""
        n_batches = self.packed.n_rows // batch_size
        if n_batches < 1:
            raise ValueError(f"the pack's {self.packed.n_rows} rows make no batch of "
                             f"{batch_size}")
        self.packed.shuffle(shuffle_seed(generator))
        steps = [self.chunk_steps] * (n_batches // self.chunk_steps)
        if n_batches % self.chunk_steps:
            steps.append(n_batches % self.chunk_steps)
        cuda = self.device.type == "cuda"
        rows = max(steps) * batch_size
        bufs = [torch.empty(rows, self.packed.n_cols, pin_memory=cuda) for _ in range(2)]
        copied = [None, None]  # the event after each buffer's last copy (on the card)

        def gather(i, start):
            if copied[i % 2] is not None:
                copied[i % 2].synchronize()
            return self.packed.gather(start, steps[i] * batch_size,
                                      bufs[i % 2][:steps[i] * batch_size])

        local = batch_size if group is None else batch_size // group.world
        with ThreadPoolExecutor(max_workers=1) as pool:
            nxt = pool.submit(gather, 0, 0)
            start = 0
            for i, nb in enumerate(steps):
                host = nxt.result()
                if group is not None:  # this rank's rows of each batch (a host copy)
                    host = host.view(nb, group.world, local, -1)[:, group.rank].reshape(
                        nb * local, -1)
                chunk = host.to(self.device, non_blocking=True, copy=True)
                if cuda:
                    copied[i % 2] = torch.cuda.Event()
                    copied[i % 2].record(torch.cuda.current_stream(self.device))
                start += nb * batch_size
                if i + 1 < len(steps):
                    nxt = pool.submit(gather, i + 1, start)
                for j in range(nb):
                    yield chunk[j * local:(j + 1) * local]
