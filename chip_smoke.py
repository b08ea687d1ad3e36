"""Smoke run of the PyTorch port (links_tpu_torch) on one NVIDIA GPU.

    python chip_smoke.py

Phases, each fatal on failure:
  1. build every CUDA kernel of the serving lift from the sources in the
     checkout (nvcc, sm_90a);
  2. hold each kernel against its plain PyTorch version on the card, at the
     full model width (two 11-joint side lifters, hidden 1024, weights from
     a seeded torch.Generator) and the batches the serving path gives it;
  3. drive the main path through its entry point, ``links_tpu_torch.cli.lift``
     (--fused, --policy bf16 and the f32 default) on a synthetic test split,
     and check that --fused went through the kernel and agrees with the
     plain bf16 lift;
  4. time each kernel, its plain version, a library yardstick (the same
     forward as torch matmul calls replayed from a CUDA graph) and its bound.

Prints the card's name and power limit, one JSON line describing every
kernel, and as its last line ``{"ok": true, "device": {...}}``. Exits
non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from links_tpu_torch.ckpt.torch_io import save_lifter_pt
from links_tpu_torch.cli import lift
from links_tpu_torch.core.nn import full_f32_matmuls
from links_tpu_torch.data.synthetic import write_synthetic_pickle
from links_tpu_torch.models.lifters import CHAIN, Lifter, StackedLifter
from links_tpu_torch.ops import _build
from links_tpu_torch.ops import fused_infer as K2

# Kernel vs plain version: rtol = atol. Both accumulate bf16 x bf16 products
# in f32, in different orders; a last-bit difference of a sum can flip the
# bf16 rounding of the next layer's input, and 16 layers carry such flips
# to the heads. Observed on an H100: at most 3.4e-4 on outputs of ~0.2.
TOL = 1e-3
KERNEL_BATCHES = (1, 37, 256, 512)
TIMED_BATCHES = (1, 256, 512)
MAIN_BATCH = 256          # --batch-size of the main path's lift runs
TEST_POSES = 2048         # synthetic poses per test subject (S9, S11)
HIDDEN = 1024
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense bf16 FLOP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


def _log(msg):
    print(msg, flush=True)


def _time_ms(fn, iters=50, warmup=5) -> tuple[float, float]:
    """(device ms, host ms) per call: CUDA events around ``iters`` calls, and
    the host clock around enqueueing them (no synchronise inside). Device
    time above host time means the device, not the host, set the pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host


def _inputs(batch: int, seed: int, in_dim: int = 22):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(2, batch, in_dim, generator=g) * 0.1).cuda()
    return x[0], x[1]


def _bound_ms(prep: dict, batch: int):
    """Least time for fused_sides_forward at ``batch``: the larger of its
    bytes (weights and inputs read once, outputs written once) over HBM
    bandwidth and its FLOPs over the dense bf16 peak."""
    _, in_dim, hidden = prep["w_up"].shape
    n_out = prep["w_down"].shape[1]
    nbytes = (sum(t.numel() * t.element_size() for t in prep.values())
              + 2 * batch * in_dim * 4 + 2 * batch * (n_out + 1) * 4)
    flops = 2 * 2 * batch * (in_dim * hidden + 2 * len(CHAIN) * hidden * hidden
                             + hidden * (n_out + 1))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _library_forward(prep: dict, left, right):
    """The same 16-layer two-side forward as batched torch matmuls in bf16,
    captured in a CUDA graph: the yardstick for the kernel (never used by the
    port). Returns (graph, outputs)."""
    bf = {k: v.bfloat16() for k, v in prep.items()}
    w_chain = bf["w_chain"]
    x = torch.stack([left, right]).bfloat16()
    w_down = bf["w_down"].mT.contiguous()
    w_ang = bf["w_ang"].mT.contiguous()

    def fwd():
        cur = torch.baddbmm(bf["b_up"][:, None], x, bf["w_up"])
        trunk = depth = None
        for j in range(len(CHAIN)):
            if j == 4:
                cur = trunk
            h = F.leaky_relu(torch.baddbmm(bf["b_chain"][:, j, 0, None], cur, w_chain[:, j, 0]))
            h = F.leaky_relu(torch.baddbmm(bf["b_chain"][:, j, 1, None], h, w_chain[:, j, 1]))
            cur = F.leaky_relu(h + cur)
            if j == 0:
                trunk = cur
            elif j == 3:
                depth = torch.baddbmm(bf["b_down"][:, None], cur, w_down)
        return depth, torch.baddbmm(bf["b_ang"][:, None], cur, w_ang)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fwd()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fwd()
    return graph, out


def phase_build():
    t0 = time.perf_counter()
    _build.build(["fused_infer"])
    K2._lib()
    _log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    for name, (secs, out) in _build.BUILD_LOG.items():
        _log(f"[build] {name}.cu: nvcc {secs:.2f} s\n{out.strip()}")
    for batch in KERNEL_BATCHES:
        p = K2.plan(0, batch, HIDDEN)
        _log(f"[build] fused_sides_forward B={batch}: cooperative grid {p.grid} blocks, "
             f"K split {p.splits}")


def phase_kernel_vs_plain(prep) -> float:
    worst = 0.0
    with torch.inference_mode():
        for batch in KERNEL_BATCHES:
            left, right = _inputs(batch, seed=batch)
            got = K2.fused_sides_forward(prep, left, right)
            torch.cuda.synchronize()
            want = K2.fused_sides_forward_reference(prep, left, right)
            errs = []
            for name, g, w in zip(("left depth", "right depth", "left angle", "right angle"),
                                  got, want):
                err = (g - w).abs()
                if not bool(torch.isfinite(g).all()) or bool((err > TOL + TOL * w.abs()).any()):
                    raise AssertionError(
                        f"fused_sides_forward disagrees with its plain version at "
                        f"B={batch} ({name}): max abs err {float(err.max()):.3e}")
                errs.append(float(err.max()))
            worst = max(worst, *errs)
            _log(f"[kernel] fused_sides_forward B={batch}: max abs err depth "
                 f"{max(errs[:2]):.3e} angle {max(errs[2:]):.3e} (rtol=atol={TOL})")
    return worst


def phase_main_path(stacked) -> int:
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = tmp / "synthetic.pkl"
        write_synthetic_pickle(data, n_per_subject=16, seed=0,
                               n_test_per_subject=TEST_POSES, test_subjects=("S9", "S11"))
        save_lifter_pt(stacked.left, tmp / "left_lifter.pt")
        save_lifter_pt(stacked.right, tmp / "right_lifter.pt")
        common = ["--data", str(data), "--model-dir", str(tmp),
                  "--batch-size", str(MAIN_BATCH), "--device", "cuda"]
        K2.fused_sides_forward.launches = 0
        outs = {}
        for name, flags in (("fused", ["--fused"]), ("bf16", ["--policy", "bf16"]),
                            ("f32", [])):
            outs[name] = lift.main(common + flags + ["--out", str(tmp / f"{name}.npz")])
        launches = K2.fused_sides_forward.launches
    n = 2 * TEST_POSES
    for name, pred in outs.items():
        if pred.shape != (n, 3, 17) or not np.isfinite(pred).all():
            raise AssertionError(f"lift {name}: expected finite (N, 3, 17) poses, "
                                 f"got {pred.shape}")
    if launches < 1:
        raise AssertionError("lift --fused did not launch fused_sides_forward")
    err = np.abs(outs["fused"] - outs["bf16"])
    if (err > TOL + TOL * np.abs(outs["bf16"])).any():
        raise AssertionError(f"lift --fused disagrees with --policy bf16: max abs "
                             f"err {err.max():.3e}")
    f32_gap = float(np.abs(outs["f32"] - outs["bf16"]).max())
    if f32_gap > 0.05:
        raise AssertionError(f"lift --policy bf16 is {f32_gap:.3e} from f32")
    _log(f"[main] lift --fused vs --policy bf16: max abs err {err.max():.3e}; "
         f"bf16 vs f32: {f32_gap:.3e}; fused_sides_forward launches {launches}")
    return launches


def phase_times(prep):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    _log(smi)
    rows = {}
    with torch.inference_mode():
        for batch in TIMED_BATCHES:
            left, right = _inputs(batch, seed=1000 + batch)
            graph, _ = _library_forward(prep, left, right)
            row = {}
            row["ms"], host_ms = _time_ms(lambda: K2.fused_sides_forward(prep, left, right))
            row["plain_ms"], _ = _time_ms(
                lambda: K2.fused_sides_forward_reference(prep, left, right))
            row["library_ms"], _ = _time_ms(graph.replay)
            row["bound_ms"], row["bound_by"] = _bound_ms(prep, batch)
            rows[batch] = row
            _log(f"[time] fused_sides_forward B={batch}: kernel {row['ms']:.4f} ms "
                 f"(wrapper's host time {host_ms:.4f} ms), plain {row['plain_ms']:.4f} ms, "
                 f"library (CUDA graph) {row['library_ms']:.4f} ms, bound "
                 f"{row['bound_ms']:.4f} ms ({row['bound_by']}) on {smi}")
    return smi, rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    full_f32_matmuls()
    _log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
         f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
         f"x{torch.cuda.device_count()}")

    phase_build()
    g = torch.Generator().manual_seed(0)
    stacked = StackedLifter(Lifter(11, HIDDEN, generator=g),
                            Lifter(11, HIDDEN, generator=g)).cuda()
    prep = K2.prepare_fused_weights(stacked)
    max_err = phase_kernel_vs_plain(prep)
    launches = phase_main_path(stacked)
    smi, rows = phase_times(prep)

    kernel = {"name": "fused_sides_forward", "route": "cuda",
              "source": "links_tpu_torch/ops/csrc/fused_infer.cu",
              "replaces": "links_tpu/ops/fused_infer.py:101",
              "launches": launches, "max_abs_err": max_err, **rows[MAIN_BATCH]}
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
