"""ctypes binding of the native packed-dataset loader (counterpart of
links_tpu/data/native_loader.py), on the same C++ source,
``native/dataloader.cc``, built for this host at first use
(``ops/_build.py``; a failed build raises: there is no second
implementation, so every run shuffles with the library's permutation).

An LNKS v1 file (magic, version, rows, columns, then row-major f32) is
mmap'd; ``shuffle(seed)`` draws the epoch's permutation (a pure function of
the seed) and ``gather`` copies permuted rows into a buffer, the caller's
(pinned host memory for the feed) or a new one, on a pool of C++ threads.
The foreign calls drop the GIL, so a gather can run on a worker thread while
the main thread drives the device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from links_tpu_torch.ops import _build

__all__ = ["PackedDataset", "pack_dataset"]

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("dataloader")
        p, u64 = ctypes.c_void_p, ctypes.c_uint64
        for name, args, res in (("links_pack", [ctypes.c_char_p, p, u64, u64], ctypes.c_int),
                                ("links_open", [ctypes.c_char_p], p),
                                ("links_rows", [p], u64), ("links_cols", [p], u64),
                                ("links_shuffle", [p, u64], None),
                                ("links_gather", [p, u64, u64, p, ctypes.c_int], ctypes.c_int),
                                ("links_close", [p], None)):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = res
        _LIB = lib
    return _LIB


def pack_dataset(path, data) -> None:
    """Write an (N, D) array as an LNKS file (f32, little-endian)."""
    data = np.ascontiguousarray(np.asarray(data), dtype=np.float32)
    if data.ndim != 2:
        raise ValueError(f"pack_dataset takes an (N, D) array, got shape {data.shape}")
    rc = _lib().links_pack(str(path).encode(), data.ctypes.data, *data.shape)
    if rc != 0:
        raise OSError(f"links_pack failed for {path}: {rc}")


class PackedDataset:
    """Shuffled batches of an LNKS file."""

    def __init__(self, path, n_threads: int = 1):
        self.path = str(path)
        # one thread by default: the library starts its threads anew on every
        # gather, which costs more than it saves at the feed's chunk size
        # (chip_smoke.py prints the gather rate on 1 and on 8 threads)
        self.n_threads = n_threads
        self._h = None
        self._lib = _lib()  # kept for close() at interpreter exit
        self._h = self._lib.links_open(self.path.encode())
        if not self._h:
            raise OSError(f"cannot open packed dataset {self.path}")
        self.n_rows = int(self._lib.links_rows(self._h))
        self.n_cols = int(self._lib.links_cols(self._h))

    def shuffle(self, seed: int):
        """Draw the permutation of ``seed`` (the same for the same seed)."""
        self._lib.links_shuffle(self._h, seed)

    def gather(self, start: int, count: int, out=None):
        """Rows ``start`` to ``start + count`` of the permutation, into
        ``out`` (a C-contiguous (count, n_cols) f32 numpy array or CPU
        tensor) or a new array, on the dataset's ``n_threads`` (the library
        copies fewer than 1024 rows on one). -> the filled buffer."""
        if start < 0 or count < 0 or start + count > self.n_rows:
            raise IndexError(f"gather [{start}, {start + count}) out of range for "
                             f"{self.n_rows} rows")
        if out is None:
            out = np.empty((count, self.n_cols), dtype=np.float32)
        if isinstance(out, torch.Tensor):
            ok = out.device.type == "cpu" and out.dtype == torch.float32 and out.is_contiguous()
            ptr = out.data_ptr()
        else:
            ok = out.dtype == np.float32 and out.flags.c_contiguous
            ptr = out.ctypes.data
        if not ok or tuple(out.shape) != (count, self.n_cols):
            raise ValueError(f"gather: out must be a C-contiguous f32 host buffer of shape "
                             f"{(count, self.n_cols)}, got {out.dtype} {tuple(out.shape)}")
        if self._lib.links_gather(self._h, start, count, ptr, self.n_threads) != 0:
            raise IndexError("links_gather out of range")
        return out

    def epoch_batches(self, batch_size: int, seed: int):
        """Yield the epoch's shuffled (batch_size, D) batches; the ragged tail
        is dropped."""
        self.shuffle(seed)
        for start in range(0, self.n_rows - batch_size + 1, batch_size):
            yield self.gather(start, batch_size)

    def close(self):
        if self._h:
            self._lib.links_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
