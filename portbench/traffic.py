"""The one generator of request traffic: a mix's parameters (a file
``traffic/<mix>.json``) and a seed -> the requests of a window.

An open-loop mix (``rate_per_s``) gives arrivals at its fixed rate; a
closed-loop mix (``callers``) gives the order in which its callers send
requests, each its next as soon as its reply comes. Every seed gets the same
set of request sizes, and of gaps between arrivals, in another order:
``sizes`` quantiles of a log-uniform law on [``min_poses``, ``max_poses``]
and as many quantiles of the exponential law of the rate, each cycle of
that many requests a new seeded permutation of both. A request's poses are
a slice of the pool at a seeded offset.
"""

from __future__ import annotations

import numpy as np

from portbench import core


def size_set(mix: dict) -> np.ndarray:
    lo, hi, n = mix["min_poses"], mix["max_poses"], mix["sizes"]
    q = (np.arange(n) + 0.5) / n
    return np.rint(lo * (hi / lo) ** q).astype(np.int64)


def gap_set(mix: dict) -> np.ndarray:
    n = mix["sizes"]
    q = (np.arange(n) + 0.5) / n
    return -np.log1p(-q) / mix["rate_per_s"]


def sequence(mix: dict, seed: int, count: int, what: str = "window"):
    """[(size, pool offset)] of the first ``count`` requests of a
    closed-loop mix, in the order its callers send them."""
    rng = np.random.default_rng(core.derive(seed, f"traffic:{what}"))
    sizes, out = size_set(mix), []
    while len(out) < count:
        order = rng.permutation(len(sizes))
        offsets = rng.integers(0, mix["pool_poses"] - mix["max_poses"] + 1, len(sizes))
        out.extend((int(sizes[order[i]]), int(offsets[i])) for i in range(len(sizes)))
    return out[:count]


def schedule(mix: dict, seed: int, seconds: float, what: str = "window"):
    """[(due seconds from the start, size, pool offset)] of the requests due
    before ``seconds``."""
    rng = np.random.default_rng(core.derive(seed, f"traffic:{what}"))
    sizes, gaps = size_set(mix), gap_set(mix)
    out, t = [], 0.0
    while True:
        order_s, order_g = rng.permutation(len(sizes)), rng.permutation(len(gaps))
        offsets = rng.integers(0, mix["pool_poses"] - mix["max_poses"] + 1, len(sizes))
        for i in range(len(sizes)):
            t += gaps[order_g[i]]
            if t >= seconds:
                return out
            out.append((t, int(sizes[order_s[i]]), int(offsets[i])))


def mean_poses_per_s(mix: dict) -> float:
    """The offered load of an open-loop mix in poses per second."""
    return float(size_set(mix).mean()) * mix["rate_per_s"]
