"""Smoke run of the PyTorch port (links_tpu_torch) on one NVIDIA GPU.

    python chip_smoke.py

Phases, each fatal on failure:
  1. build every CUDA kernel of the port and its packed-data loader from
     the sources in the checkout (nvcc for sm_90a, g++ for the host, one
     process per source, all started together);
  2. hold each kernel against its plain PyTorch version on the card, at the
     full model width (side lifters at hidden 1024, weights from a seeded
     torch.Generator): the fused serving kernel (K2) at the serving batches
     and at each batch where its tile plan changes shape, with one batch on
     each side of it, the residual-block kernels (K1 forward and backward)
     at the training, serving and validation batches under both dtype
     policies, all bitwise repeatable, with K1's split kernel (bitwise) and
     its weight-plane cache;
  3. one training step of each stage (1, 2, 3a, 3b, 4) on the card against
     the same step on the CPU (full-width lifters, completers and 8-block
     flows at hidden 1024, batch 64, the same weights and draws), counting
     the residual-block launches of the step and the weight casts of a
     first and a second step;
  4. drive the main paths through their entry points on a synthetic
     corpus, each with the kernels' counts set to 0 just before it and read
     just after: ``links_tpu_torch.cli.lift`` of seeded lifters (--fused,
     --policy bf16, f32); the trainers of stages 1, 2, 3a, 3b and 4, one
     epoch each, each stage reading what the ones before wrote (no flow or
     lifter is made outside them); then ``lift --model-dir`` of the 3a
     lifters (--fused, --policy bf16), ``lift --mode leg_torso`` of the 3b
     lifters and ``lift --scenario`` of every occlusion scenario; then, on
     the model directory the trainers wrote, each path with its counts set
     to 0 just before it: K1's f32 forward against its plain version at
     eval's batches; ``links_tpu_torch.cli.eval_h36m`` with every occlusion
     evaluation (--occlusion --dropout --from-detections on the detector
     split, f32) and with --mode leg_torso, counting K1's forward calls;
     eval's device math on the card against the CPU on 512 test poses; the
     3a trainer resumed after one epoch against two epochs straight (within
     2 lr, bitwise or not reported); ``links_tpu_torch.cli.run_pipeline
     --stages eval``; int8 serving: ``lift --quant int8`` and ``int8-static``
     of the 3a and 3b pairs and ``lift --scenario --quant int8`` (no K1 or
     K2 launch, each against the CPU), ``eval_h36m --quant``; the serving
     daemon ``links_tpu_torch.cli.serve`` in this process (coalesced under 8
     concurrent clients, --fused on K2, --no-coalesce; JSON and .npy
     requests against lift, a malformed body answered with 400); stage 3a
     --attention (one step on the card against the CPU with its K1 calls
     counted exactly, one epoch of the trainer, lift and eval of what it
     wrote, lift --fused refused); the serving artifact
     (``links_tpu_torch.cli.export_model`` of the trained 3a pair in f32,
     bf16 and at a pinned batch, of the 3b pair, of ``--scenario ll`` and
     ``--quant int8``, each verified on the card, loaded and lifting the
     test split against the live lift with its K1 calls per chunk, the bf16
     artifact's weights cast once; ``serve --artifact`` under concurrent
     clients); the packed feed (``pack_data``, one 3a epoch with
     --packed-data creating its pack and one reading it, each with the
     in-memory epoch's K1 calls, and the gather rate at H36M's train size);
     and the metrics' batched SVD at 500,000 poses, one call against chunks;
  5. time each stage's training step at batch 256, then K2, then the
     serving daemon's requests/s and lift's poses/s by serving flag, before
     any torch.profiler session (one often leaves the process slower); then the
     3a and stage-4 steps' profiles, and each kernel, its plain version, a library
     yardstick (the same function as torch calls replayed from a CUDA graph)
     and its bound. Kernels are timed on the device from a CUDA graph of
     their wrapper's calls, as the yardstick is, and eagerly beside it (the
     host's enqueue then sets the pace), with each CUDA kernel's device time
     from torch.profiler (K2: one kernel per call).

Prints the card's name and power limit, one JSON line describing every
kernel, and as its last line ``{"ok": true, "device": {...}}``. Exits
non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import io
import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from links_tpu_torch import ckpt, metrics
from links_tpu_torch.ckpt.torch_io import load_lifter_pt, save_lifter_pt
from links_tpu_torch.cli import _common as C
from links_tpu_torch.cli import eval_h36m, export_model, lift, pack_data, run_pipeline, serve
from links_tpu_torch.cli._common import LR_LIFTERS
from links_tpu_torch.cli import train_full_pose_norm_flow as flow1_cli
from links_tpu_torch.cli import train_left_right_lifter as train_cli
from links_tpu_torch.cli import train_leg_torso_lifter as leg_torso_cli
from links_tpu_torch.cli import train_occlusion_models as occlusion_cli
from links_tpu_torch.cli import train_part_norm_flows as flow2_cli
from links_tpu_torch.config import (
    FlowTrainConfig,
    LifterTrainConfig,
    OcclusionTrainConfig,
    OptimConfig,
    PartFlowTrainConfig,
)
from links_tpu_torch.core.geometry import normalize_head
from links_tpu_torch.core.nn import BF16, F32, full_f32_matmuls
from links_tpu_torch.core.skeleton import split_data_left_right
from links_tpu_torch.data import native_loader
from links_tpu_torch.data.synthetic import generate_poses, write_synthetic_pickle
from links_tpu_torch.flows import Flow
from links_tpu_torch.models.attention import AttentionLifter
from links_tpu_torch.models.completers import COMPLETER_SPECS, Completers
from links_tpu_torch.models.lifters import (
    CHAIN,
    LEG_JOINTS,
    TORSO_JOINTS,
    LegTorsoLifter,
    Lifter,
    StackedLifter,
)
from links_tpu_torch.objectives import lifter as obj
from links_tpu_torch.objectives.flow_nll import PartFlows
from links_tpu_torch.objectives.lifter import LifterFrozen
from links_tpu_torch.objectives.occlusion import (
    DROPOUT_SCENARIO_JOINTS,
    occlusion_loss,
    pseudo_3d_from_lifters,
)
from links_tpu_torch.ops import _build
from links_tpu_torch.ops import fused_infer as K2
from links_tpu_torch.ops import resblock as K1
from links_tpu_torch.train import feed, steps
from links_tpu_torch.train.optim import Adam

# K2 vs plain version: rtol = atol. Both accumulate bf16 x bf16 products in
# f32, in different orders; a last-bit difference of a sum can flip the bf16
# rounding of the next layer's input, and 16 layers carry such flips to the
# heads. Observed on an H100: at most 3.4e-4 on outputs of ~0.2.
TOL = 1e-3
# K1 vs plain version. Forward outputs: rtol = atol (sums in another order;
# f32 operands enter as three bf16 terms; under bf16 a flipped rounding of h
# moves a2 by ~1e-4). bf16-policy dx, dW1, dW2 are rounded to bf16 after
# their sum, so a flip there is one bf16 unit in the last place: at most
# 2**-7 of the largest value. The other gradients (bf16 db1, db2, which sum
# flipped terms over the batch, and every f32-policy gradient, whose sums
# over up to 4096 rows carry an error of the size of the partial sums, not
# of the element): 1e-3 of the largest value.
K1_TOL = 1e-3
K1_BF16_ULP = 2.0 ** -7
# The ulp bound alone would pass a backward that rounds its f32 gradient
# operands g1, g2 to one bf16 term (the Pallas kernel's numerics), since that
# too moves each element by about one ulp. What separates the two is how
# many elements move: the share of bf16-policy dx, dW1, dW2 elements off by
# more than K1_FLIP_REL of their own value must stay below K1_FLIP_SHARE. A
# flipped dh element shifts every dx and dW1 sum that reads it, so those
# flip in a few percent of elements (at most 4.9%, dW1 at B=4096, observed
# on an H100); one-term operands flip 25-54%. Each run checks that a
# one-term control, computed here in PyTorch, exceeds the limit.
K1_FLIP_REL = 1e-5
K1_FLIP_SHARE = 0.1
# serving, ragged, one lifter at the main batch (stage 4's frozen legs and
# torso lifters, and the chunks of lift --policy/--mode/--scenario), lifter
# training step (2 x 256), stage-4 step ((2 + 1) x 256), validation
K1_BATCHES = (1, 37, 256, 512, 768, 4096)
# One training step of each stage, card vs CPU (bf16 policy, batch 64): loss
# terms within rtol = 1e-3, atol = 1e-4 and each gradient within a relative
# L2 error of 2e-2. The sides differ by bf16 rounding flips of hidden
# activations and of the rounded gradient products, which the 7-block chains
# carry on (7.1e-3 observed on an H100 for 3a).
STEP_RTOL, STEP_ATOL, STEP_GRAD_REL = 1e-3, 1e-4, 2e-2
STAGE_NAMES = ("stage 1", "stage 2", "3a", "3b", "stage 4")
# Residual-block calls per lifter training step (3a and 3b alike: two
# lifters, all chain blocks H x H): 7 blocks x 2 lifters x (lift + re-lift)
# forward; backward only where a loss reads the output: no loss reads the
# re-lift's elevation angles, so its 3 angle blocks per lifter get no
# gradient. Under bf16 each block's two weights are cast to bf16 planes once
# per step (the re-lift and the backward find them cached). The flow stages
# run no residual block.
K1_FWD_PER_STEP = 2 * 2 * 7
K1_BWD_PER_STEP = K1_FWD_PER_STEP - 2 * 3
K1_CASTS_PER_STEP = 2 * 7 * 2
# Stage 4: 3 blocks x 8 completers forward and backward (one call each on the
# (n_rot + 1) B rows), and the frozen legs and torso lifters' 7 blocks each
# forward, with no gradient (their 3 angle blocks each run for nothing: no
# loss reads the angles). The completers' 48 weights are cast after each
# Adam update; the frozen lifters' 28 only on the first step.
K1_STAGE4 = (8 * 3 + 2 * 7, 8 * 3)
K1_STAGE4_CASTS = (8 * 3 * 2 + 2 * 7 * 2, 8 * 3 * 2)
# -> (forward calls, backward calls, casts of a first step, casts of a second)
K1_PER_STEP = {"stage 1": (0, 0, 0, 0), "stage 2": (0, 0, 0, 0),
               "3a": (K1_FWD_PER_STEP, K1_BWD_PER_STEP, K1_CASTS_PER_STEP, K1_CASTS_PER_STEP),
               "3b": (K1_FWD_PER_STEP, K1_BWD_PER_STEP, K1_CASTS_PER_STEP, K1_CASTS_PER_STEP),
               "stage 4": (*K1_STAGE4, *K1_STAGE4_CASTS)}
# 3a --attention: the attention lifter has 5 blocks (res_common, 2 pose, 2
# angle): 5 x 2 lifters x (lift + re-lift) forward, all but the re-lift's 2
# angle blocks per lifter backward, each block's two weights cast once per step
K1_PER_STEP["3a attention"] = (5 * 2 * 2, 5 * 2 * 2 - 2 * 2, 5 * 2 * 2, 5 * 2 * 2)
# A quantized lift on the card against the same lift on the CPU, on the first
# QUANT_CPU_ROWS poses: the int8 product is exact and the rest is the same f32
# elementwise sequence, so within QUANT_CARD_TOL (rtol = atol; bitwise equality
# is reported)
QUANT_CARD_TOL = 1e-5
QUANT_CPU_ROWS = 1024
QUANT_SCENARIO = "ll"
# the serving daemon under load: SERVE_CLIENTS concurrent clients, each
# sending requests of SERVE_POSES poses, SERVE_CHECK_ROUNDS requests each for
# the checks and SERVE_TIMED_ROUNDS for the times
SERVE_CLIENTS = 8
SERVE_POSES = 50
SERVE_CHECK_ROUNDS = 5
SERVE_TIMED_ROUNDS = 25
# eval's device math on the card against the CPU (f32 policy) on this many
# test poses: continuous metrics within EVAL_RTOL, counted ones within one
# count (a distance a last bit away from a threshold may land on its other
# side)
EVAL_CHECK_POSES = 512
EVAL_RTOL = 1e-4
# the serving artifacts exported from the main path's models (name -> export
# flags, the live lift's flags, K1 forward calls per chunk: 7 blocks per
# lifter; a scenario lifts with all four and runs a completer's 3 blocks; a
# quantized block composes its int8 linears), each loaded on the card and
# lifting the test split's 4096 poses in chunks of MAIN_BATCH
EXPORTS = {"3a f32": ([], [], 14), "3a bf16": (["--policy", "bf16"], ["--policy", "bf16"], 14),
           "3a --batch 256": (["--batch", "256"], [], 14),
           "--mode leg_torso": (["--mode", "leg_torso"], ["--mode", "leg_torso"], 14),
           "--scenario ll": (["--scenario", "ll"], ["--scenario", "ll"], 4 * 7 + 3),
           "--quant int8": (["--quant", "int8"], ["--quant", "int8"], 0)}
# an artifact's lift against the live lift: the same kernels on the same
# inputs, so expected bitwise; held within this (rtol = atol)
EXPORT_TOL = 1e-5
# the gather rate at H36M's train size: rows of 34 f32 (204 MB), batches of 256
GATHER_ROWS = 1_500_000
# pose pairs of the metrics' timing (the order of H36M's test split)
SCALE_POSES = 500_000
TIMED_BATCHES = (1, 256, 512)
MAIN_BATCH = 256          # --batch-size of the main paths
TEST_POSES = 2048         # synthetic poses per test subject (S9, S11)
TRAIN_POSES = 2048        # synthetic poses per train subject: 40 steps at 256
STEP_CHECK_BATCH = 64
HIDDEN = 1024
FLOW_HIDDEN = 1024        # the flow trainers' default width
FLOW_BLOCKS = 8
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 FLOP/s and
# f32 FLOP/s outside the tensor cores (the f32 policy: TF32 off).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
# K1's f32 policy multiplies on the tensor cores all the same: each f32
# operand is three bf16 terms and a product sums the 6 term products
# i + j < 3 (ops/csrc/resblock.cu), so its own method's peak is the bf16
# peak over 6. Its share of the F32_FLOPS bound is not a roofline share.
K1_F32_METHOD_FLOPS = BF16_FLOPS / 6


def _log(msg):
    print(msg, flush=True)


# host seconds of each phase of main() and of each entry-point call of the
# main path, logged at the end
SECONDS = {}


def _timed(name: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    SECONDS[name] = time.perf_counter() - t0
    return out


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


def _graphed(fn):
    """``fn`` captured in a CUDA graph after a warm-up on a side stream:
    -> (graph, outputs of the captured call)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.fn = fn  # the tensors fn reads must outlive the graph that replays it
    return graph, out


def _bound(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    """The least time for work of ``nbytes`` and ``flops`` at ``peak`` FLOP/s:
    (ms, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _inputs(batch: int, seed: int, in_dim: int = 22):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(2, batch, in_dim, generator=g) * 0.1).cuda()
    return x[0], x[1]


def _bound_ms(prep: dict, batch: int):
    """Least time for fused_sides_forward at ``batch``: weights and inputs
    read once, outputs written once, against the dense bf16 peak."""
    _, in_dim, hidden = prep["w_up"].shape
    n_out = prep["w_down"].shape[1]
    nbytes = (sum(t.numel() * t.element_size() for t in prep.values())
              + 2 * batch * in_dim * 4 + 2 * batch * (n_out + 1) * 4)
    flops = 2 * 2 * batch * (in_dim * hidden + 2 * len(CHAIN) * hidden * hidden
                             + hidden * (n_out + 1))
    return _bound(nbytes, flops)


def _library_forward(prep, left, right):
    """The same 16-layer two-side forward as batched torch matmuls in bf16,
    captured in a CUDA graph: the yardstick for K2 (never used by the port).
    Returns (graph, outputs)."""
    bf = {k: v.bfloat16() for k, v in prep.items()}
    w_chain = bf["w_chain"].mT.contiguous()  # prep keeps torch's (out, in)
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

    return _graphed(fwd)


def _k2_batches() -> list[int]:
    """1, 37, 256 and 512, and each batch where K2's tile plan changes shape
    on this card, with one batch on each side of it."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shape = [K2.plan(b, HIDDEN, sms)[:2] for b in range(1, K2.MAX_BATCH + 1)]
    edges = [b for b in range(2, K2.MAX_BATCH + 1) if shape[b - 1] != shape[b - 2]]
    return sorted({1, 37, 256, 512} | {b + d for b in edges for d in (-1, 0, 1)})


def phase_build():
    t0 = time.perf_counter()
    _build.build(["fused_infer", "resblock", "dataloader"])
    K2._lib()
    K1._lib()
    native_loader._lib()
    _log(f"[build] kernels and the packed-data loader built and loaded in "
         f"{time.perf_counter() - t0:.2f} s")
    for name, (secs, out) in _build.BUILD_LOG.items():
        _log(f"[build] {_build.sources(name)[0].name}: {secs:.2f} s\n{out.strip()}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for batch in _k2_batches():
        p = K2.plan(batch, HIDDEN, sms)
        smem = K2._lib().fused_sides_smem_bytes(p.rows, p.cols, p.a_rows, p.chunk, p.a_chunks,
                                                p.w_chunks)
        if smem != p.smem:
            raise AssertionError(f"K2's plan at B={batch} gives {p.smem} bytes of shared memory, "
                                 f"the kernel {smem}")
        _log(f"[build] fused_sides_forward plan B={batch}: tiles {p.rows} x {p.cols}, grid "
             f"{p.grid} blocks of {sms} SMs (2 sides x {p.row_tiles} x {p.col_tiles}), A box "
             f"{p.a_rows} rows, ring slots of {p.chunk} K tiles: {p.a_chunks} for A, "
             f"{p.w_chunks} for the weights; {p.smem} bytes of shared memory")


def phase_kernel_vs_plain(prep) -> float:
    """K2 against its plain version at every checked batch, bitwise
    repeatable, its counters back at zero after each call."""
    worst = 0.0
    with torch.inference_mode():
        for batch in _k2_batches():
            left, right = _inputs(batch, seed=batch)
            got = K2.fused_sides_forward(prep, left, right)
            again = K2.fused_sides_forward(prep, left, right)
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
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"fused_sides_forward is not repeatable at B={batch}")
            if any(bool(c.any()) for c in prep._counters.values()):
                raise AssertionError(f"fused_sides_forward left its counters nonzero at B={batch}")
            worst = max(worst, *errs)
            _log(f"[kernel] fused_sides_forward B={batch}: max abs err depth "
                 f"{max(errs[:2]):.3e} angle {max(errs[2:]):.3e} (rtol=atol={TOL}); two runs "
                 f"bitwise equal; counters back at zero")
    return worst


def _k1_inputs(batch: int, seed: int):
    """x, W1, b1, W2, b2 (torch.nn.Linear's init at hidden 1024) and dy."""
    g = torch.Generator().manual_seed(seed)
    bound = HIDDEN ** -0.5
    w1, w2 = (torch.empty(HIDDEN, HIDDEN).uniform_(-bound, bound, generator=g) for _ in "12")
    b1, b2 = (torch.empty(HIDDEN).uniform_(-bound, bound, generator=g) for _ in "12")
    x, dy = (torch.randn(batch, HIDDEN, generator=g) for _ in "xy")
    return [t.cuda() for t in (x, w1, b1, w2, b2, dy)]


def _flip_share(got, want) -> float:
    """The share of elements off by more than K1_FLIP_REL of their own value."""
    return float(((got - want).abs() > K1_FLIP_REL * want.abs()).float().mean())


def _k1_check(name: str, got, want, rule: str) -> float:
    """Hold one K1 output against the plain version's by ``rule``:
    'elementwise', 'ulp' (with the flip share) or 'scale' (see K1_TOL)."""
    err = (got - want).abs()
    scale = float(want.abs().max())
    if rule == "ulp":
        ok = float(err.max()) <= K1_BF16_ULP * scale and _flip_share(got, want) < K1_FLIP_SHARE
    elif rule == "scale":
        ok = float(err.max()) <= K1_TOL * scale
    else:
        ok = not bool((err > K1_TOL + K1_TOL * want.abs()).any())
    if not ok or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name} disagrees with its plain version: max abs err "
                             f"{float(err.max()):.3e} (largest value {scale:.3e}), flip "
                             f"share {_flip_share(got, want):.4f}")
    return float(err.max())


def _one_term_backward(dy, x, w1, w2, a1, h, a2):
    """The control for the flip check: the bf16 backward with the gradient
    operands g1, g2 rounded to one bf16 term before each product, as the
    Pallas kernel does. -> (dx, dW1, dW2)."""
    def r(t):
        return t.bfloat16().float()

    g2 = r(dy * K1._dlrelu(a2))
    g1 = r(r(g2 @ r(w2)) * K1._dlrelu(a1))
    return dy + r(g1 @ r(w1)), r(g1.mT @ r(x)), r(g2.mT @ r(h))


def phase_k1_split_and_cache():
    """K1's split kernel against its plain version (bitwise: both round to
    nearest even) at every K1 batch, and the weight-plane cache on the card:
    one cast per weight version, a fresh plane after an in-place update."""
    for batch in K1_BATCHES:
        x, w1, b1, w2, b2, dy = _k1_inputs(batch, seed=batch)
        a2 = K1.res_block_forward_reference(x, w1, b1, w2, b2, BF16)[3]
        for name, args in (("x", (x, 1)), ("g2 = dy * lrelu'(a2)", (dy, 2, a2))):
            before = K1.split_planes.launches
            got = K1.split_planes(*args)
            torch.cuda.synchronize()
            want = K1.split_reference(*(t.cpu() if torch.is_tensor(t) else t for t in args))
            if K1.split_planes.launches != before + 1 or not all(
                    torch.equal(g.cpu(), w) for g, w in zip(got, want)):
                raise AssertionError(f"split kernel {name} B={batch}: planes differ from the "
                                     f"plain split")
    _log(f"[kernel] split kernel: x (one plane) and g2 (hi and lo planes) bitwise equal to the "
         f"plain split at B={'/'.join(map(str, K1_BATCHES))}")
    w = _k1_inputs(1, seed=11)[1].requires_grad_(True)
    before = K1.weight_plane.casts
    plane = K1.weight_plane(w)
    same = K1.weight_plane(w) is plane
    with torch.no_grad():
        w.mul_(0.5)  # an in-place update, as Adam's
    fresh = K1.weight_plane(w)
    if not (same and fresh is not plane and K1.weight_plane.casts == before + 2
            and torch.equal(fresh, w.detach().to(torch.bfloat16))):
        raise AssertionError("the weight-plane cache did not return one plane per version")
    _log("[kernel] weight-plane cache: one bf16 cast per weight version, recast after an "
         "in-place update, equal to w.to(torch.bfloat16)")


def phase_k1_vs_plain() -> tuple[float, float]:
    """-> (worst forward error, worst backward error) over every batch and
    policy."""
    worst_f = worst_b = 0.0
    for policy, pname in ((BF16, "bf16"), (F32, "f32")):
        for batch in K1_BATCHES:
            x, w1, b1, w2, b2, dy = _k1_inputs(batch, seed=batch)
            fwd = K1.res_block_forward(x, w1, b1, w2, b2, policy)
            torch.cuda.synchronize()
            fwd2 = K1.res_block_forward(x, w1, b1, w2, b2, policy)
            torch.cuda.synchronize()
            want = K1.res_block_forward_reference(x, w1, b1, w2, b2, policy)
            # under bf16 the forward saves the bf16 planes of h and x: h is held
            # to its plain plane by the rule of a rounded output, x bitwise
            saved = K1.kernel_saved(x, *want[1:], policy)
            errs_f = [_k1_check(f"res_block_forward {pname} B={batch} {n}", g.float(),
                                w.float(), "ulp" if policy is BF16 and n == "h" else "elementwise")
                      for n, g, w in zip(("y", "a1", "h", "a2"), fwd, (want[0], *saved[1:]))]
            if not torch.equal(fwd[4], saved[0]):
                raise AssertionError(f"res_block_forward {pname} B={batch}: the saved x differs")
            # the backward from the plain forward's saved activations: the
            # same inputs for both versions
            xs, a1, hs, a2 = saved
            bwd = K1.res_block_backward(dy, xs, w1, w2, a1, hs, a2, policy)
            torch.cuda.synchronize()
            bwd2 = K1.res_block_backward(dy, xs, w1, w2, a1, hs, a2, policy)
            torch.cuda.synchronize()
            ref = K1.res_block_backward_reference(dy, x, w1, w2, *want[1:], policy)
            errs_b = [_k1_check(f"res_block_backward {pname} B={batch} {n}", g, w,
                                "ulp" if policy is BF16 and n in ("dx", "dW1", "dW2")
                                else "scale")
                      for n, g, w in zip(("dx", "dW1", "db1", "dW2", "db2"), bwd, ref)]
            if not (all(torch.equal(a, b) for a, b in zip(fwd, fwd2))
                    and all(torch.equal(a, b) for a, b in zip(bwd, bwd2))):
                raise AssertionError(f"res_block kernels are not repeatable at {pname} B={batch}")
            worst_f, worst_b = max(worst_f, *errs_f), max(worst_b, *errs_b)
            flips = ""
            if policy is BF16:
                rounded = (ref[0], ref[1], ref[3])
                kernel = [_flip_share(g, w) for g, w in zip((bwd[0], bwd[1], bwd[3]), rounded)]
                control = [_flip_share(g, w) for g, w in
                           zip(_one_term_backward(dy, x, w1, w2, *want[1:]), rounded)]
                if min(control) < K1_FLIP_SHARE:
                    raise AssertionError(f"the flip check does not reject one-term gradient "
                                         f"operands at B={batch}: shares {control}")
                flips = (f"; flip share dx/dW1/dW2 {' '.join(f'{v:.4f}' for v in kernel)} "
                         f"(one-term control {' '.join(f'{v:.4f}' for v in control)}, "
                         f"limit {K1_FLIP_SHARE})")
            _log(f"[kernel] res_block {pname} B={batch}: max abs err forward "
                 f"y/a1/h{' (bf16 plane)' if policy is BF16 else ''}/a2 "
                 f"{' '.join(f'{e:.2e}' for e in errs_f)}; backward "
                 f"dx/dW1/db1/dW2/db2 {' '.join(f'{e:.2e}' for e in errs_b)}{flips}; two "
                 f"runs bitwise equal")
    return worst_f, worst_b


def _synthetic_batch(n: int, seed: int) -> torch.Tensor:
    p = generate_poses(n, seed=seed)["poses_2d"].astype(np.float32)
    return normalize_head(torch.from_numpy(p.transpose(0, 2, 1).reshape(n, 34)))


class Stage(NamedTuple):
    """One training stage at full width: the trained model and the frozen
    flows (on the CPU), its config, the functions that make its gradient
    function and its step from (frozen flows on a device, config), and its
    draw function."""

    model: torch.nn.Module
    frozen: tuple
    cfg: object
    grads: Callable
    step: Callable
    draw: Callable


def _stage(name: str, seed: int, batch: int) -> Stage:
    """Stage ``name`` at full width (flows: 8 blocks at hidden 1024; lifters
    and completers at hidden 1024) from a seeded generator, with the
    trainers' defaults (bf16 matmuls; flows and completers: f32 Adam
    moments; flows: no NLL cap; lifters: bf16 moments, cap 500; completers:
    2 rotations, no input noise)."""
    g = torch.Generator().manual_seed(seed)

    def flow(dim):
        return Flow(dim, FLOW_BLOCKS, FLOW_HIDDEN, generator=g).requires_grad_(False)

    if name == "stage 1":
        return Stage(Flow(34, FLOW_BLOCKS, FLOW_HIDDEN, generator=g), (),
                     FlowTrainConfig(batch_size=batch),
                     lambda fr, cfg: steps.build_full_flow_grads(cfg),
                     lambda fr, cfg: steps.build_full_flow_step(cfg), steps.draw_noise)
    if name == "stage 2":
        parts = PartFlows(*(Flow(d, FLOW_BLOCKS, FLOW_HIDDEN, generator=g)
                            for d in (22, 22, 14, 20)))
        return Stage(parts, (flow(34),), PartFlowTrainConfig(batch_size=batch),
                     lambda fr, cfg: steps.build_part_flows_grads(fr[0], cfg),
                     lambda fr, cfg: steps.build_part_flows_step(fr[0], cfg), steps.draw_noise)
    if name == "stage 4":
        cfg = OcclusionTrainConfig(batch_size=batch)
        lifters = tuple(Lifter(j, HIDDEN, generator=g).requires_grad_(False)
                        for j in (LEG_JOINTS, TORSO_JOINTS))
        return Stage(Completers(HIDDEN, generator=g), lifters, cfg,
                     lambda fr, cfg: steps.build_occlusion_grads(*fr, cfg),
                     lambda fr, cfg: steps.build_occlusion_step(*fr, cfg),
                     functools.partial(steps.draw_occlusion, n_rot=cfg.n_rot,
                                       input_noise=cfg.input_noise))
    cfg = LifterTrainConfig(nll_cap=500.0, batch_size=batch, optim=OptimConfig(bf16_moments=True))
    if name in ("3a", "3a attention"):
        make = AttentionLifter if name == "3a attention" else Lifter
        model = StackedLifter(make(11, hidden=HIDDEN, generator=g),
                              make(11, hidden=HIDDEN, generator=g))
        return Stage(model, tuple(flow(d) for d in (34, 22, 22)), cfg,
                     lambda fr, cfg: steps.build_left_right_grads(LifterFrozen(*fr), cfg),
                     lambda fr, cfg: steps.build_left_right_step(LifterFrozen(*fr), cfg),
                     steps.draw_step)
    model = LegTorsoLifter(Lifter(LEG_JOINTS, HIDDEN, generator=g),
                           Lifter(TORSO_JOINTS, HIDDEN, generator=g))
    return Stage(model, tuple(flow(d) for d in (34, 14, 20)), cfg,
                 lambda fr, cfg: steps.build_leg_torso_grads(LifterFrozen(*fr), cfg),
                 lambda fr, cfg: steps.build_leg_torso_step(LifterFrozen(*fr), cfg),
                 steps.draw_step)


def _to(draws, device):
    """A step's draws (a tensor, a StepDraws or an OcclusionDraws) on
    ``device``."""
    if isinstance(draws, tuple):
        return type(draws)(*(None if t is None else t.to(device) for t in draws))
    return draws.to(device)


def _reset_counts():
    K2.fused_sides_forward.launches = 0
    K1.res_block_forward.launches = K1.res_block_backward.launches = 0


def _counts() -> dict:
    return {"fused_sides_forward": K2.fused_sides_forward.launches,
            "res_block_forward": K1.res_block_forward.launches,
            "res_block_backward": K1.res_block_backward.launches}


def phase_step_card_vs_cpu(name: str) -> tuple[int, int]:
    """One training step of stage ``name`` (bf16 policy) on the card and on
    the CPU from the same weights, batch and draws; on the card the weight
    casts of a second gradient after the update, too. -> the card's
    (forward, backward) K1 launches."""
    stage = _stage(name, seed=1, batch=STEP_CHECK_BATCH)
    batch = _synthetic_batch(STEP_CHECK_BATCH, seed=7)
    draws = stage.draw(torch.Generator().manual_seed(8), STEP_CHECK_BATCH, "cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        model = copy.deepcopy(stage.model).to(dev)
        grads_fn = stage.grads(tuple(copy.deepcopy(f).to(dev) for f in stage.frozen), stage.cfg)
        _reset_counts()
        K1.res_block_forward.kernel_launches = K1.res_block_backward.kernel_launches = 0
        K1.weight_plane.casts = 0
        aux, grads = grads_fn(model, batch.to(dev), _to(draws, dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = (K1.res_block_forward.launches, K1.res_block_backward.launches)
            per_call = (K1.res_block_forward.kernel_launches / max(launches[0], 1),
                        K1.res_block_backward.kernel_launches / max(launches[1], 1))
            casts = K1.weight_plane.casts
        Adam(model.parameters(), stage.cfg.optim, steps_per_epoch=40).step(grads)
        out[dev] = ({k: float(v) for k, v in aux.items()}, [t.cpu() for t in grads],
                    [p.detach().cpu() for p in model.parameters()])
        if dev == "cuda":
            K1.weight_plane.casts = 0
            grads_fn(model, batch.to(dev), _to(draws, dev))
            torch.cuda.synchronize()
            casts = (casts, K1.weight_plane.casts)
    want = K1_PER_STEP[name]
    if (*launches, *casts) != want:
        raise AssertionError(f"one {name} step launched the residual-block kernels {launches} "
                             f"times with {casts} weight casts (first, second step), expected "
                             f"{want}")
    (aux_c, grads_c, params_c), (aux_g, grads_g, params_g) = out["cpu"], out["cuda"]
    for k, v in aux_c.items():
        if not abs(aux_g[k] - v) <= STEP_ATOL + STEP_RTOL * abs(v):
            raise AssertionError(f"{name} step {k}: card {aux_g[k]:.6g} vs CPU {v:.6g}")
    rel = [float((a - b).norm() / b.norm().clamp_min(1e-12)) for a, b in zip(grads_g, grads_c)]
    if max(rel) > STEP_GRAD_REL:
        raise AssertionError(f"{name} step gradients: relative L2 error {max(rel):.3e}")
    upd = max(float((a - b).abs().max()) for a, b in zip(params_g, params_c))
    if upd > 2 * stage.cfg.optim.learning_rate:
        raise AssertionError(f"{name} step update: card and CPU params differ by {upd:.3e}")
    _log(f"[step] {name} card vs CPU, batch {STEP_CHECK_BATCH}: loss {aux_g['loss']:.6f} vs "
         f"{aux_c['loss']:.6f}, worst loss term rel err "
         f"{max(abs(aux_g[k] - v) / max(abs(v), 1e-12) for k, v in aux_c.items()):.2e} "
         f"(bound rtol {STEP_RTOL}, atol {STEP_ATOL}), worst gradient rel L2 err "
         f"{max(rel):.2e} over {len(rel)} tensors (bound {STEP_GRAD_REL}), params after Adam "
         f"within {upd:.2e} (bound {2 * stage.cfg.optim.learning_rate:.1e}); K1 calls "
         f"{launches[0]} forward + {launches[1]} backward, {per_call[0]:.0f} + {per_call[1]:.0f} "
         f"CUDA launches per call, {casts[0]} weight casts ({casts[1]} in a second step)")
    return launches


def _train(module, common: list, name: str):
    """One epoch of a trainer's entry point, its K1 launches counted from 0.
    -> (state, summary, counts)."""
    out = io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        state = module.main(common + ["--epochs", "1", "--seed", "0"])
    counts = _counts()
    SECONDS[name] = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    summary = json.loads(lines[-1])
    _log(f"[main] {name}: {lines[-2]}")
    _log(f"[main] {name}: {json.dumps(summary)}")
    n_steps = 5 * TRAIN_POSES // MAIN_BATCH
    bad = [k for k, v in summary["last"].items() if not np.isfinite(v)]
    if summary["steps"] != n_steps or state.step != n_steps or bad:
        raise AssertionError(f"{name}: {summary['steps']} steps (expected {n_steps}), "
                             f"non-finite {bad}")
    return state, summary, counts


def _lift(common: list, flags: list, out: Path, name: str,
          n: int | None = None) -> tuple[np.ndarray, dict]:
    """One call of the serving entry point, its kernel launches counted from 0;
    it must lift ``n`` poses (default: the test split's)."""
    n = n or 2 * TEST_POSES
    _reset_counts()
    t0 = time.perf_counter()
    pred = lift.main(common + flags + ["--out", str(out)])
    counts = _counts()
    SECONDS[f"lift {name}"] = time.perf_counter() - t0
    if pred.shape != (n, 3, 17) or not np.isfinite(pred).all():
        raise AssertionError(f"lift {name}: expected finite ({n}, 3, 17) poses, got {pred.shape}")
    return pred, counts


def _check_fused(fused: np.ndarray, bf16: np.ndarray, name: str, rule: str) -> float:
    """``lift --fused`` against ``--policy bf16`` by ``rule``: 'elementwise'
    (rtol = atol = TOL) or 'scale' (TOL of the largest value; see
    phase_main_path)."""
    err = np.abs(fused - bf16)
    if rule == "scale":
        bad = err.max() > TOL * np.abs(bf16).max()
    else:
        bad = (err > TOL + TOL * np.abs(bf16)).any()
    if bad:
        raise AssertionError(f"lift --fused of {name} disagrees with --policy bf16: max abs "
                             f"err {err.max():.3e} (largest value {np.abs(bf16).max():.3e})")
    return float(err.max())


def _k2_vs_plain_trained(models: Path, poses_2d: np.ndarray) -> float:
    """K2 against its plain version on the trained 3a lifters and a batch of
    the test poses (rtol = atol = TOL, as for the seeded lifters)."""
    stacked = StackedLifter(*(load_lifter_pt(models / f, "cuda") for f in LR_LIFTERS))
    prep = K2.prepare_fused_weights(stacked)
    left, right = split_data_left_right(torch.from_numpy(poses_2d[:MAIN_BATCH]).cuda())
    with torch.inference_mode():
        got = K2.fused_sides_forward(prep, left, right)
        want = K2.fused_sides_forward_reference(prep, left, right)
    errs = [(g - w).abs() for g, w in zip(got, want)]
    if any(bool((e > TOL + TOL * w.abs()).any()) for e, w in zip(errs, want)):
        raise AssertionError(f"fused_sides_forward disagrees with its plain version on the "
                             f"trained lifters: max abs err {max(float(e.max()) for e in errs):.3e}")
    return max(float(e.max()) for e in errs)


def phase_main_path(stacked, tmp: Path) -> tuple[dict, dict]:
    """The main paths through their entry points, each with the kernels'
    counts set to 0 just before it and read just after: the serving lift of
    seeded lifters (K2's path, and K1's forward under --policy); then the
    trainers of stages 1, 2, 3a, 3b and 4, one epoch each, every stage
    reading what the ones before it wrote (K1's path in 3a, 3b and 4); then
    lift of the 3a lifters from --model-dir alone (--fused, --policy bf16),
    of the 3b lifters (--mode leg_torso) and of every occlusion scenario
    (--scenario: the four lifters and a completer). Writes the corpus and
    the model directory into ``tmp``. -> (counts by path, trainer
    summaries)."""
    counts, summaries = {}, {}
    data = tmp / "synthetic.pkl"
    write_synthetic_pickle(data, n_per_subject=TRAIN_POSES, seed=0,
                           n_test_per_subject=TEST_POSES, test_subjects=("S9", "S11"))
    serve = tmp / "serve"
    serve.mkdir()
    save_lifter_pt(stacked.left, serve / "left_lifter.pt")
    save_lifter_pt(stacked.right, serve / "right_lifter.pt")
    common = ["--data", str(data), "--batch-size", str(MAIN_BATCH), "--device", "cuda"]
    outs = {}
    for name, flags in (("fused", ["--fused"]), ("bf16", ["--policy", "bf16"]),
                        ("f32", [])):
        outs[name], counts[f"lift {name}"] = _lift(common + ["--model-dir", str(serve)],
                                                   flags, tmp / f"{name}.npz", name)
    if counts["lift fused"]["fused_sides_forward"] < 1:
        raise AssertionError("lift --fused did not launch fused_sides_forward")
    err = _check_fused(outs["fused"], outs["bf16"], "seeded lifters", "elementwise")
    f32_gap = float(np.abs(outs["f32"] - outs["bf16"]).max())
    if f32_gap > 0.05:
        raise AssertionError(f"lift --policy bf16 is {f32_gap:.3e} from f32")
    _log(f"[main] lift --fused vs --policy bf16: max abs err {err:.3e}; bf16 vs f32: "
         f"{f32_gap:.3e}; fused_sides_forward launches "
         f"{counts['lift fused']['fused_sides_forward']}")

    # stages 1 -> 2 -> 3a -> 3b -> 4, one epoch each, in one model directory
    models = tmp / "models"
    train = common + ["--model-dir", str(models)]
    n_steps = 5 * TRAIN_POSES // MAIN_BATCH
    for name, module, files in (
            ("stage 1", flow1_cli, ["full_flow.pt"]),
            ("stage 2", flow2_cli, ["flow_left.pt", "flow_right.pt", "flow_legs.pt",
                                    "flow_torso.pt"]),
            ("3a", train_cli, ["left_side_lifter_final.pt", "right_side_lifter_final.pt"]),
            ("3b", leg_torso_cli, ["leg_lifter.pt", "torso_lifter.pt"]),
            ("stage 4", occlusion_cli, [f"occlusion_model_weights/{c}_estimator.pt"
                                        for c in COMPLETER_SPECS])):
        _, summaries[name], counts[name] = _train(module, train, name)
        missing = [f for f in files if not (models / f).exists()]
        if missing:
            raise AssertionError(f"{name} wrote no {missing}")
        k1 = counts[name]
        fwd, bwd = K1_PER_STEP[name][:2]
        # the validation adds forward calls to the stages that run K1
        if (k1["res_block_backward"] != n_steps * bwd
                or (k1["res_block_forward"] <= n_steps * fwd if fwd
                    else k1["res_block_forward"] != 0)):
            raise AssertionError(f"{name}: residual-block kernel launches {k1}")
        _log(f"[main] {name}: {n_steps} steps, wrote {', '.join(files)}; K1 launches "
             f"{k1['res_block_forward']} forward + {k1['res_block_backward']} backward")

    # serve what the trainers wrote, from the model directory alone
    served = common + ["--model-dir", str(models)]
    fused, counts["lift 3a --fused"] = _lift(served, ["--fused"], tmp / "t_fused.npz",
                                             "3a --fused")
    bf16, counts["lift 3a bf16"] = _lift(served, ["--policy", "bf16"], tmp / "t_bf16.npz",
                                         "3a --policy bf16")
    _, counts["lift 3b"] = _lift(served, ["--mode", "leg_torso"], tmp / "t_lt.npz",
                                 "--mode leg_torso")
    for scenario in sorted(DROPOUT_SCENARIO_JOINTS):
        path = f"lift --scenario {scenario}"
        _, counts[path] = _lift(served, ["--scenario", scenario], tmp / "t_occ.npz",
                                f"--scenario {scenario}")
        if counts[path]["res_block_forward"] < 1:
            raise AssertionError(f"{path} launched no residual-block kernel: {counts[path]}")
    if counts["lift 3a --fused"]["fused_sides_forward"] < 1 \
            or counts["lift 3b"]["res_block_forward"] < 1:
        raise AssertionError(f"the lifts of the trained lifters launched no kernel: {counts}")
    # trained weights carry larger activations than the seeded ones, so the
    # two bf16 forwards (K2, and K1's per block) part further on outputs
    # near zero (2.5e-3 on values up to 13.6 after one epoch, on an H100):
    # they are held by the scale rule, and K2 against its own plain
    # version on the trained weights elementwise (not counted: after the
    # main path)
    err = _check_fused(fused, bf16, "the trained 3a lifters", "scale")
    k2_err = _k2_vs_plain_trained(models, np.load(tmp / "t_fused.npz")["poses_2d"])
    _log(f"[main] lift --model-dir of the trained 3a lifters: --fused vs --policy bf16 max "
         f"abs err {err:.3e} (largest value {np.abs(bf16).max():.3e}); fused_sides_forward "
         f"vs its plain version on them, B={MAIN_BATCH}: max abs err {k2_err:.3e}; "
         f"lift --mode leg_torso of the 3b lifters: finite; launches "
         f"{counts['lift 3a --fused']['fused_sides_forward']} fused_sides_forward, "
         f"{counts['lift 3b']['res_block_forward']} res_block_forward (leg/torso)")
    _log(f"[main] lift --scenario {'/'.join(sorted(DROPOUT_SCENARIO_JOINTS))} of the trained "
         f"lifters and completers: finite ({2 * TEST_POSES}, 3, 17) each; res_block_forward "
         f"launches " + ", ".join(f"{s} {counts['lift --scenario ' + s]['res_block_forward']}"
                                  for s in sorted(DROPOUT_SCENARIO_JOINTS)))
    return counts, summaries


def _eval_args(data: Path, models: Path, *flags) -> list:
    return ["--data", str(data), "--model-dir", str(models), "--batch-size", str(MAIN_BATCH),
            "--device", "cuda", *flags]


def phase_k1_eval_batches(data: Path, models: Path) -> list[int]:
    """K1's f32 forward against its plain version at the batches that eval's
    main-path call gives it and K1_BATCHES lacks: the complete frames of
    the detector test split (the lift, --dropout and --occlusion under
    --no-gt-2d) and the frames --from-detections composes from two
    completers. -> (complete frames, all frames, composed frames)."""
    args = eval_h36m.build_parser().parse_args(_eval_args(data, models, "--no-gt-2d"))
    complete = len(C.load_test(args))
    _, missing, _, _ = eval_h36m.detection_inputs(args)
    composed = len(eval_h36m.detection_plan(missing)[3])
    batches = {complete, missing.shape[0], composed, EVAL_CHECK_POSES}
    for batch in sorted(batches - set(K1_BATCHES)):
        x, w1, b1, w2, b2, _ = _k1_inputs(batch, seed=batch)
        got = K1.res_block_forward(x, w1, b1, w2, b2, F32)
        want = K1.res_block_forward_reference(x, w1, b1, w2, b2, F32)
        errs = [_k1_check(f"res_block_forward f32 B={batch} {n}", g, w, "elementwise")
                for n, g, w in zip(("y", "a1", "h", "a2"), got, want)]
        _log(f"[kernel] res_block f32 B={batch} (an eval batch): max abs err forward "
             f"y/a1/h/a2 {' '.join(f'{e:.2e}' for e in errs)}")
    _log(f"[eval] eval batches: {complete} complete detector frames, {missing.shape[0]} frames "
         f"in all, {composed} composed, {EVAL_CHECK_POSES} for the card-vs-CPU check; K1_BATCHES "
         f"held {sorted(batches & set(K1_BATCHES))}")
    return complete, missing.shape[0], composed


def _eval(data: Path, models: Path, flags: list, name: str) -> tuple[dict, dict]:
    """One call of the eval entry point, its kernel launches counted from 0;
    every number it prints finite."""
    out = io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        results = eval_h36m.main(_eval_args(data, models, *flags))
    counts = _counts()
    SECONDS[f"eval {name}"] = time.perf_counter() - t0
    if json.loads(out.getvalue().strip().splitlines()[-1]) != results:
        raise AssertionError(f"eval {name}: its JSON line is not its results")
    bad = [k for k, v in results.items() if isinstance(v, float) and not np.isfinite(v)]
    if bad:
        raise AssertionError(f"eval {name}: non-finite {bad}")
    return results, counts


def phase_eval(data: Path, models: Path, composed: int) -> dict:
    """``links_tpu_torch.cli.eval_h36m`` on the model directory the main
    path's trainers wrote: the left/right lifters with every occlusion
    evaluation on the detector split (f32; ``composed`` of its frames take
    two completers), and the legs/torso lifters. K1's forward calls must be
    those the evaluations make. -> counts by path."""
    counts = {}
    full, counts["eval --occlusion --dropout --from-detections"] = _eval(
        data, models, ["--policy", "f32", "--occlusion", "--dropout", "--from-detections",
                       "--no-gt-2d", "--json"], "left_right")
    want_keys = ({"pa_mpjpe", "n_mpjpe", "mpjpe", "pck", "auc", "cps", "cps_correct",
                  "mpjpe_units", "det_frames", "det_unserved", "det_n_composed"}
                 | {f"{p}_{s}" for s in DROPOUT_SCENARIO_JOINTS
                    for p in ("pa", "n_mpjpe", "dropout_pa", "dropout_naive_pa")})
    if not want_keys <= set(full) or full["det_n_composed"] != composed:
        raise AssertionError(f"eval: keys {sorted(want_keys - set(full))} missing, or "
                             f"{full.get('det_n_composed')} composed frames, not {composed}")
    lt, counts["eval --mode leg_torso"] = _eval(data, models, ["--mode", "leg_torso", "--json"],
                                                "leg_torso")
    # K1 forward calls: 7 blocks per lifter; a scenario's poses run the four
    # lifters and one completer's 3 blocks; each dropout scenario adds the
    # naive left/right lift
    scenario, pair = 4 * 7 + 3, 2 * 7
    want = {"eval --occlusion --dropout --from-detections":
            pair + 2 * 8 * (scenario + pair) + pair * (composed > 0) + 4 * 7 + 8 * 3,
            "eval --mode leg_torso": pair}
    got = {path: c["res_block_forward"] for path, c in counts.items()}
    if got != want or any(c["fused_sides_forward"] or c["res_block_backward"]
                          for c in counts.values()):
        raise AssertionError(f"eval launched res_block_forward {got} times, expected {want}: "
                             f"{counts}")
    _log(f"[eval] --policy f32 --occlusion --dropout --from-detections --no-gt-2d: pa_mpjpe "
         f"{full['pa_mpjpe']:.4f}, n_mpjpe {full['n_mpjpe']:.4f}, pck {full['pck']:.4f}, "
         f"auc {full['auc']:.4f}, cps {full['cps']:.4f} / {full['cps_correct']:.4f}; "
         f"{len(full)} keys, all finite; det: {full['det_frames']} frames, complete share "
         f"{full['det_complete_frac']:.4f}, {full['det_root_imputed']} roots imputed, "
         f"{full['det_n_composed']} composed, {full['det_unserved']} unserved; "
         f"{got['eval --occlusion --dropout --from-detections']} res_block_forward launches")
    _log(f"[eval] --mode leg_torso: pa_mpjpe {lt['pa_mpjpe']:.4f}, pck {lt['pck']:.4f}; "
         f"{got['eval --mode leg_torso']} res_block_forward launches")
    return counts


def phase_eval_card_vs_cpu(data: Path, models: Path) -> float:
    """Eval's device math on the card against the CPU, on the first
    EVAL_CHECK_POSES test poses (f32 policy): the base lift's metrics, the
    8 occlusion scenarios' and the 8 dropout scenarios'. The continuous
    metrics within EVAL_RTOL; the counted ones (PCK, AUC, both CPS) within
    one count. -> the largest relative error of the continuous ones."""
    args = eval_h36m.build_parser().parse_args(_eval_args(data, models))
    test = C.load_test(args)
    p2d, gt = test.poses_2d[:EVAL_CHECK_POSES], test.poses_3d[:EVAL_CHECK_POSES]
    out = {}
    for dev in ("cpu", "cuda"):
        lifters, completers = C.load_all_lifters(args, dev), C.load_completers(args, dev)
        x, g = p2d.to(dev), gt.to(dev)
        with torch.no_grad():
            pred = obj.lift_left_right_eval(StackedLifter(lifters["left"], lifters["right"]), x,
                                            10.0, "right", F32)
            out[dev] = {**eval_h36m.base_metrics(g, pred),
                        **eval_h36m.occlusion_metrics(completers, lifters, g, x, 10.0, F32),
                        **eval_h36m.dropout_metrics(completers, lifters, g, x, 10.0, "right",
                                                    F32)}
    n = EVAL_CHECK_POSES
    # what one count moves each counted metric by
    step = {"pck": 100.0 / (n * 17), "auc": 1.0 / (n * 17 * 150), "cps": 1.0 / n,
            "cps_correct": 1.0 / n}
    worst, counted = 0.0, {}
    for k, want in out["cpu"].items():
        err = abs(out["cuda"][k] - want)
        if k in step:
            counted[k] = err / step[k]
            ok = err <= step[k] * 1.001
        else:
            worst = max(worst, err / max(abs(want), 1e-12))
            ok = err <= EVAL_RTOL * abs(want)
        if not ok:
            raise AssertionError(f"eval {k} on the card {out['cuda'][k]!r} vs the CPU {want!r}")
    _log(f"[eval] card vs CPU, {n} test poses, f32: {len(out['cpu'])} metrics (base, 8 "
         f"occlusion scenarios, 8 dropout scenarios); worst relative error {worst:.2e} (bound "
         f"{EVAL_RTOL}); counted metrics off by "
         + ", ".join(f"{k} {v:.2f}" for k, v in counted.items()) + " counts (bound 1)")
    return worst


def phase_resume(data: Path, models: Path, tmp: Path) -> dict:
    """Stage 3a on the card: one epoch and then --resume to two in one
    directory, two epochs straight in another (the main path's flows in
    both). Their weights within 2 lr; whether they are bitwise equal is
    reported. -> counts by path."""
    counts = {}
    dirs = {}
    for name in ("straight", "resumed"):
        dirs[name] = tmp / f"resume_{name}"
        dirs[name].mkdir()
        for f in ("full_flow.pt", "flow_left.pt", "flow_right.pt"):
            shutil.copy2(models / f, dirs[name] / f)
    common = ["--data", str(data), "--batch-size", str(MAIN_BATCH), "--device", "cuda",
              "--seed", "0"]
    states = {}
    for path, name, flags in (("resume 3a straight", "straight", ["--epochs", "2"]),
                              ("resume 3a first epoch", "resumed", ["--epochs", "1"]),
                              ("resume 3a resumed", "resumed", ["--epochs", "2", "--resume"])):
        _reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            states[name] = train_cli.main(common + ["--model-dir", str(dirs[name]), *flags])
        counts[path] = _counts()
        SECONDS[path] = time.perf_counter() - t0
        if path.endswith("resumed") and not out.getvalue().splitlines()[-2].startswith("epoch 1"):
            raise AssertionError(f"the resumed 3a run did not start at epoch 1: {out.getvalue()}")
    a, b = (torch.load(d / "left_right_run.pt", weights_only=True) for d in dirs.values())
    pairs = list(zip(states["straight"].model.parameters(), states["resumed"].model.parameters()))
    diff = max(float((p - q).detach().abs().max()) for p, q in pairs)
    bitwise = all(torch.equal(p, q) for p, q in pairs)
    moments = all(torch.equal(x, y) for x, y in zip(a["opt"]["mu"] + a["opt"]["nu"],
                                                     b["opt"]["mu"] + b["opt"]["nu"]))
    lr = LifterTrainConfig().optim.learning_rate
    if (a["opt"]["count"], a["step"], a["next_epoch"]) != (b["opt"]["count"], b["step"],
                                                           b["next_epoch"]) \
            or not torch.equal(a["generator"], b["generator"]) or diff > 2 * lr:
        raise AssertionError(f"3a resumed on the card differs from the straight run: params by "
                             f"{diff:.3e} (bound {2 * lr:.1e}), count {a['opt']['count']} vs "
                             f"{b['opt']['count']}")
    _log(f"[resume] 3a on the card, 2 epochs of {a['opt']['count'] // 2} steps: resumed after "
         f"epoch 1 vs straight, parameters within {diff:.3e} (bound 2 lr = {2 * lr:.1e}), "
         f"{'bitwise equal' if bitwise else 'not bitwise equal'}; Adam moments "
         f"{'bitwise equal' if moments else 'not bitwise equal'}; count, step, epoch and "
         f"generator state equal; K1 launches " + ", ".join(
             f"{p} {c['res_block_forward']} + {c['res_block_backward']}"
             for p, c in counts.items()))
    return counts


def phase_pipeline_eval(data: Path, models: Path) -> dict:
    """``links_tpu_torch.cli.run_pipeline --stages eval --eval-args "--json
    --occlusion"`` on the model directory. -> counts by path."""
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        run_pipeline.main(["--stages", "eval", *_eval_args(data, models),
                           "--eval-args", "--json --occlusion"])
    counts = {"run_pipeline --stages eval": _counts()}
    SECONDS["run_pipeline --stages eval"] = time.perf_counter() - t0
    results = json.loads(out.getvalue().strip().splitlines()[-1])
    if not {f"pa_{s}" for s in DROPOUT_SCENARIO_JOINTS} <= set(results) \
            or not all(np.isfinite(v) for v in results.values() if not isinstance(v, str)):
        raise AssertionError(f"run_pipeline --stages eval printed {results}")
    _log(f"[pipeline] run_pipeline --stages eval --eval-args '--json --occlusion': pa_mpjpe "
         f"{results['pa_mpjpe']:.4f}, pa_torso {results['pa_torso']:.4f}, {len(results)} keys; "
         f"{counts['run_pipeline --stages eval']['res_block_forward']} res_block_forward "
         f"launches")
    return counts


def phase_quant(data: Path, models: Path, tmp: Path) -> dict:
    """``lift --quant int8`` and ``--quant int8-static`` of the trained 3a
    pair and of the 3b pair (--mode leg_torso), and ``lift --scenario
    QUANT_SCENARIO --quant int8``: no residual-block or fused kernel launch
    (a quantized block composes its int8 linears), and each against the same
    lift on the CPU on its first QUANT_CPU_ROWS poses. Then ``eval_h36m
    --quant int8`` and ``--occlusion --quant int8-static``, which records the
    occlusion paths' fallback to dynamic scales. -> counts by path."""
    counts = {}
    served = ["--data", str(data), "--model-dir", str(models), "--batch-size", str(MAIN_BATCH)]
    for name, flags in (("int8", ["--quant", "int8"]),
                        ("int8-static", ["--quant", "int8-static"]),
                        ("--mode leg_torso int8", ["--mode", "leg_torso", "--quant", "int8"]),
                        ("--mode leg_torso int8-static",
                         ["--mode", "leg_torso", "--quant", "int8-static"]),
                        (f"--scenario {QUANT_SCENARIO} int8",
                         ["--scenario", QUANT_SCENARIO, "--quant", "int8"])):
        path = f"lift {name}"
        card, counts[path] = _lift(served + ["--device", "cuda"], flags, tmp / "q.npz", name)
        if any(counts[path].values()):
            raise AssertionError(f"{path} launched a kernel: {counts[path]}")
        cpu, _ = _lift(served + ["--device", "cpu", "--limit", str(QUANT_CPU_ROWS)], flags,
                       tmp / "q_cpu.npz", f"{name} (CPU)", n=QUANT_CPU_ROWS)
        card, err = card[:QUANT_CPU_ROWS], np.abs(card[:QUANT_CPU_ROWS] - cpu)
        if (err > QUANT_CARD_TOL + QUANT_CARD_TOL * np.abs(cpu)).any():
            raise AssertionError(f"{path} on the card differs from the CPU by {err.max():.3e}")
        err, bitwise = float(err.max()), bool(np.array_equal(card, cpu))
        _log(f"[quant] {path}: finite ({2 * TEST_POSES}, 3, 17), no K1 or K2 launch; card vs "
             f"CPU on {QUANT_CPU_ROWS} poses: max abs err {err:.3e} (bound rtol = atol = "
             f"{QUANT_CARD_TOL}), {'bitwise equal' if bitwise else 'not bitwise equal'}")
    for name, flags in (("--quant int8", ["--quant", "int8", "--json"]),
                        ("--occlusion --quant int8-static",
                         ["--occlusion", "--quant", "int8-static", "--json"])):
        results, counts[f"eval {name}"] = _eval(data, models, flags, name)
        if any(counts[f"eval {name}"].values()):
            raise AssertionError(f"eval {name} launched a kernel: {counts[f'eval {name}']}")
        fallback = results.get("quant_fallback_dynamic")
        if fallback != (["lifters", "completers"] if "occlusion" in name else None):
            raise AssertionError(f"eval {name}: quant_fallback_dynamic is {fallback}")
        _log(f"[quant] eval {name}: pa_mpjpe {results['pa_mpjpe']:.4f}, {len(results)} keys, "
             f"all finite; quant_fallback_dynamic {fallback}; no K1 or K2 launch")
    return counts


@contextlib.contextmanager
def _serving(argv: list):
    """``links_tpu_torch.cli.serve``'s server with ``argv``, on a free port of
    this host, serving from a thread of this process: -> its URL."""
    srv = serve.make_server(serve.build_parser().parse_args(argv + ["--port", "0"]))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    host, port = srv.server_address[:2]
    try:
        yield f"http://{host}:{port}"
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    if thread.is_alive():
        raise AssertionError("the server's thread did not stop")


def _post(url: str, data: bytes, content_type: str = "application/json") -> dict:
    req = urllib.request.Request(url, data=data, headers={"Content-Type": content_type})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _health(base: str) -> dict:
    with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
        return json.loads(resp.read())


def _clients(base: str, poses: np.ndarray, rounds: int) -> tuple[float, np.ndarray]:
    """SERVE_CLIENTS concurrent clients, each sending ``rounds`` JSON requests
    of SERVE_POSES poses (client i's rows of ``poses``). -> (seconds, the
    answers in the rows' order)."""
    out = np.zeros((SERVE_CLIENTS, SERVE_POSES, 3, 17), np.float32)
    errors = []

    def client(i):
        rows = poses[i * SERVE_POSES:(i + 1) * SERVE_POSES]
        body = json.dumps({"poses_2d": rows.tolist()}).encode()
        try:
            for _ in range(rounds):
                out[i] = np.asarray(_post(base + "/lift", body)["poses_3d"], np.float32)
        except Exception as e:  # reported below: every request must be served
            errors.append(f"client {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,)) for i in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    seconds = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"serve: not every request was served: {errors}")
    return seconds, out.reshape(-1, 3, 17)


def phase_serve(data: Path, models: Path, tmp: Path) -> dict:
    """``links_tpu_torch.cli.serve`` on the model directory, in this process,
    each server's counts set to 0 just before it starts and read after it
    stops: coalesced (K1's forward, f32): a JSON and a .npy request against
    ``lift`` of the same poses, SERVE_CLIENTS concurrent clients (fewer
    device runs than requests), a malformed body answered with 400 and the
    server alive after it; ``--fused`` (K2) against the plain version (the
    CPU's ``lift --fused``); ``--no-coalesce``, every request served. ->
    counts by path."""
    counts = {}
    n = SERVE_CLIENTS * SERVE_POSES
    poses = np.load(tmp / "t_fused.npz")["poses_2d"][:n]
    np.save(tmp / "serve_poses.npy", poses)
    base_args = ["--data", str(data), "--model-dir", str(models), "--batch-size",
                 str(MAIN_BATCH)]
    raw = ["--raw-2d", str(tmp / "serve_poses.npy")]
    want, _ = _lift(base_args + ["--device", "cuda"] + raw, [], tmp / "s.npz", "serve reference",
                    n=n)
    plain_fused, _ = _lift(base_args + ["--device", "cpu"] + raw, ["--fused"], tmp / "sf.npz",
                           "serve --fused reference (CPU)", n=n)
    for path, flags in (("serve", []), ("serve --fused", ["--fused"]),
                        ("serve --no-coalesce", ["--no-coalesce"])):
        _reset_counts()
        t0 = time.perf_counter()
        with _serving(base_args + ["--device", "cuda", *flags]) as base:
            _, got = _clients(base, poses, SERVE_CHECK_ROUNDS)
            detail = ""
            if path == "serve":
                one = _post(base + "/lift", json.dumps({"poses_2d": poses.tolist()}).encode())
                buf = io.BytesIO()
                np.save(buf, poses.reshape(n, 2, 17))
                npy = _post(base + "/lift", buf.getvalue(), "application/octet-stream")
                for name, res in (("JSON", one["poses_3d"]), (".npy", npy["poses_3d"])):
                    err = _k1_check(f"serve {name} request vs lift", torch.from_numpy(
                        np.asarray(res, np.float32)), torch.from_numpy(want), "elementwise")
                    detail += f"{name} request of {n} poses vs lift: max abs err {err:.3e}; "
                try:
                    _post(base + "/lift", b'{"poses_2d": [[1.0, 2.0]]')
                    raise AssertionError("serve answered a malformed body")
                except urllib.error.HTTPError as e:
                    if e.code != 400:
                        raise AssertionError(f"serve answered a malformed body with {e.code}")
                detail += "malformed body: 400; "
            health = _health(base)
        counts[path] = _counts()
        SECONDS[path] = time.perf_counter() - t0
        requests = SERVE_CLIENTS * SERVE_CHECK_ROUNDS + (2 if path == "serve" else 0)
        if health["requests"] != requests or health["errors"] != int(path == "serve"):
            raise AssertionError(f"{path}: /healthz after the checks: {health}")
        if path == "serve --fused":
            err = _check_fused(got, plain_fused, "serve --fused", "scale")
            detail += (f"vs the plain version (CPU lift --fused) max abs err {err:.3e} "
                       f"(largest value {np.abs(plain_fused).max():.3e}); ")
            if counts[path]["fused_sides_forward"] < 1 or counts[path]["res_block_forward"]:
                raise AssertionError(f"{path} launched {counts[path]}")
        else:
            _k1_check(f"{path} concurrent answers vs lift", torch.from_numpy(got),
                      torch.from_numpy(want), "elementwise")
            if counts[path]["res_block_forward"] < 1 or counts[path]["fused_sides_forward"]:
                raise AssertionError(f"{path} launched {counts[path]}")
        if path == "serve" and not health["device_batches"] < health["requests"]:
            raise AssertionError(f"serve did not coalesce: {health}")
        merged = (f"{health['device_batches']} device runs for {health['merged_requests']} "
                  f"requests, " if health["coalescing"] else "")
        _log(f"[serve] {path}: {SERVE_CLIENTS} concurrent clients x {SERVE_CHECK_ROUNDS} "
             f"requests of {SERVE_POSES} poses all served and equal to lift's; {detail}"
             f"/healthz: {health['requests']} requests, {health['poses']} poses, "
             f"{health['errors']} errors, {merged}launches {counts[path]}")
    return counts


def phase_export(data: Path, models: Path, tmp: Path, smi: str) -> dict:
    """``links_tpu_torch.cli.export_model`` of the models the main path
    trained (EXPORTS; each --verify'd on the card), each artifact loaded on
    the card and lifting the test split in chunks of MAIN_BATCH against the
    live ``lift`` of the same flags (within EXPORT_TOL, bitwise reported),
    with the live lift's K1 forward calls per chunk; the bf16 artifact's
    weights cast once for its lifetime; then ``serve --artifact`` under
    SERVE_CLIENTS concurrent clients, answering within EXPORT_TOL of ``lift``
    (its merged chunks need not be bitwise). Times the
    artifact's poses/s beside the live lift's (each after a warm-up chunk,
    ending in the copy to the host). -> counts by path."""
    counts = {}
    served = ["--data", str(data), "--model-dir", str(models), "--batch-size", str(MAIN_BATCH),
              "--device", "cuda"]
    poses = np.load(tmp / "t_fused.npz")["poses_2d"]  # the test split, as lift reads it
    paths = {}
    for name, (flags, live_flags, per_chunk) in EXPORTS.items():
        path = tmp / f"export {name}.pt2".replace(" ", "_")
        _reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            summary = export_model.main(served + flags + ["--out", str(path)])
        counts[f"export_model {name}"] = _counts()
        SECONDS[f"export_model {name}"] = time.perf_counter() - t0
        if summary["verified"] is not True or summary["outputs"] != [
                f"float32[{summary['batch'] if summary['batch'] != 'symbolic' else 'b'},51]"]:
            raise AssertionError(f"export_model {name}: {summary}")
        paths[name] = path
        want, live_counts = _lift(served, live_flags, tmp / "e.npz", f"export {name} reference")
        n = want.shape[0]
        chunks = -(-n // MAIN_BATCH)
        art = ckpt.deserialize_exported(path, "cuda")
        fn = art.call
        with torch.inference_mode():
            lift._chunked(fn, poses[:MAIN_BATCH], MAIN_BATCH, "cuda")  # warm-up chunk
            casts = K1.weight_plane.casts
            seconds = []
            for rep in range(3):  # the first pass counted; no cast after the warm-up
                _reset_counts()
                t0 = time.perf_counter()
                out = lift._chunked(fn, poses, MAIN_BATCH, "cuda")
                seconds.append(time.perf_counter() - t0)
                if rep == 0:
                    got, counts[f"artifact {name}"] = out, _counts()
            casts = K1.weight_plane.casts - casts
        live_rate = max(_lift_rate(served, live_flags, tmp / "e.npz") for _ in range(3))
        got = got.reshape(n, 3, 17)
        err = np.abs(got - want)
        if (err > EXPORT_TOL + EXPORT_TOL * np.abs(want)).any():
            raise AssertionError(f"the {name} artifact differs from lift by {err.max():.3e}")
        k1 = counts[f"artifact {name}"]["res_block_forward"]
        live_k1 = live_counts["res_block_forward"]
        if (k1 != chunks * per_chunk or live_k1 != (chunks + 1) * per_chunk
                or counts[f"artifact {name}"]["fused_sides_forward"] or casts):
            raise AssertionError(f"the {name} artifact made {k1} K1 forward calls for {chunks} "
                                 f"chunks (live lift {live_k1} with its warm-up chunk, expected "
                                 f"{per_chunk} per chunk), {casts} weight casts after its "
                                 f"warm-up: {counts[f'artifact {name}']}")
        _log(f"[export] {name}: {summary['bytes']} bytes, batch {summary['batch']}, verified on "
             f"the card; lifts {n} poses in {chunks} chunks of {MAIN_BATCH} with {k1} K1 forward "
             f"calls ({per_chunk} per chunk, as the live lift), max abs err vs lift {err.max():.3e}"
             f" ({'bitwise equal' if np.array_equal(got, want) else 'not bitwise equal'}); "
             f"poses/s (best of 3 passes): artifact {n / min(seconds):.1f}, live lift "
             f"{live_rate} on {smi}")
    # the bf16 artifact: each of its 28 weights cast to its bf16 plane once, at
    # the warm-up (the loop above found none cast after it)
    art = ckpt.deserialize_exported(paths["3a bf16"], "cuda")
    casts = K1.weight_plane.casts
    with torch.inference_mode():
        for _ in range(3):
            lift._chunked(art.call, poses[:MAIN_BATCH], MAIN_BATCH, "cuda")
    casts = K1.weight_plane.casts - casts
    if casts != 2 * 2 * 7:
        raise AssertionError(f"a fresh bf16 artifact cast {casts} weights in 3 calls, not 28 once")
    _log(f"[export] 3a bf16 artifact freshly loaded: {casts} weight casts in 3 calls (28 "
         f"weights, each once)")

    # serve --artifact under concurrent clients, against lift
    n = SERVE_CLIENTS * SERVE_POSES
    raw = ["--raw-2d", str(tmp / "serve_poses.npy")]
    want, _ = _lift(served + raw, [], tmp / "sa.npz", "serve --artifact reference", n=n)
    serve_poses = np.load(tmp / "serve_poses.npy")
    _reset_counts()
    t0 = time.perf_counter()
    with _serving(["--artifact", str(paths["3a f32"]), "--device", "cuda", "--batch-size",
                   str(MAIN_BATCH)]) as base:
        _, got = _clients(base, serve_poses, SERVE_CHECK_ROUNDS)
        health = _health(base)
    counts["serve --artifact"] = _counts()
    SECONDS["serve --artifact"] = time.perf_counter() - t0
    # the daemon merges requests into other chunks than lift's: the linears'
    # library products may then sum in another order (1.9e-6 seen on an H100)
    err = np.abs(got - want)
    if (err > EXPORT_TOL + EXPORT_TOL * np.abs(want)).any() \
            or health["model"].get("artifact") != str(paths["3a f32"]) \
            or health["requests"] != SERVE_CLIENTS * SERVE_CHECK_ROUNDS \
            or counts["serve --artifact"]["res_block_forward"] < 1:
        raise AssertionError(f"serve --artifact: answers vs lift max abs err {err.max():.3e}; "
                             f"/healthz {health}; {counts['serve --artifact']}")
    _log(f"[export] serve --artifact (3a f32): {SERVE_CLIENTS} concurrent clients x "
         f"{SERVE_CHECK_ROUNDS} requests of {SERVE_POSES} poses, max abs err vs lift "
         f"{err.max():.3e} ({'bitwise equal' if np.array_equal(got, want) else 'not bitwise'}); "
         f"/healthz platforms {health['model']['platforms']}, inputs "
         f"{health['model']['inputs']}, {health['device_batches']} device runs for "
         f"{health['merged_requests']} requests; launches {counts['serve --artifact']}")
    return counts


def _gather_rate(tmp: Path) -> dict:
    """One shuffled pass over a GATHER_ROWS x 34 f32 pack, rows/s: gathered
    into host memory in batches of MAIN_BATCH (one thread), in the feed's
    chunks of CHUNK_STEPS batches with one thread (the loader's default)
    and with eight, and through the packed feed onto the card (its
    worker, pinned buffers and copies included)."""
    rows = np.random.default_rng(3).standard_normal((GATHER_ROWS, 34), dtype=np.float32)
    native_loader.pack_dataset(tmp / "gather.lnks", rows)
    del rows
    rates = {}
    chunk = feed.CHUNK_STEPS * MAIN_BATCH
    for name, threads, count in ((f"batches of {MAIN_BATCH}", 1, MAIN_BATCH),
                                 (f"chunks of {chunk}, 1 thread", 1, chunk),
                                 (f"chunks of {chunk}, 8 threads", 8, chunk)):
        with native_loader.PackedDataset(tmp / "gather.lnks", n_threads=threads) as ds:
            buf = np.empty((count, 34), np.float32)
            ds.shuffle(1)
            ds.gather(0, count, buf)
            t0 = time.perf_counter()
            for start in range(0, ds.n_rows - count + 1, count):
                ds.gather(start, count, buf)
            rates[name] = (ds.n_rows // count * count) / (time.perf_counter() - t0)
    with native_loader.PackedDataset(tmp / "gather.lnks") as ds:
        g = torch.Generator(device="cuda").manual_seed(2)
        t0 = time.perf_counter()
        n = 0
        for batch in feed.PackedFeed(ds, "cuda").batches(MAIN_BATCH, g):
            n += batch.shape[0]
        torch.cuda.synchronize()
        rates["the packed feed onto the card"] = n / (time.perf_counter() - t0)
    (tmp / "gather.lnks").unlink()
    return rates


def phase_feed(data: Path, models: Path, tmp: Path, in_memory: dict, in_memory_rate: float,
               smi: str) -> dict:
    """The packed feed: ``pack_data`` packs the synthetic train split; stage
    3a runs one epoch with --packed-data that creates its pack and one that
    reads it (the main path's flows, fresh directories), each 40 steps with
    the in-memory epoch's K1 counts (``in_memory``: the main path's 3a
    counts); their poses/s beside the main path's in-memory epoch
    (``in_memory_rate``) and beside an in-memory epoch run just before and
    one just after them; then the gather rate at H36M's train size. ->
    counts by path."""
    counts = {}
    packed = tmp / "train_pack.lnks"
    with contextlib.redirect_stdout(io.StringIO()):
        info = pack_data.main(["--data", str(data), "--out", str(packed)])
    if info["n_rows"] != 5 * TRAIN_POSES or info["n_cols"] != 34:
        raise AssertionError(f"pack_data: {info}")
    rates = {}
    pack = tmp / "feed_pack.lnks"
    for path, folder, packed_flags in (
            ("3a in memory (before)", "feed_before", []),
            ("3a --packed-data (creates the pack)", "feed_creates", ["--packed-data", str(pack)]),
            ("3a --packed-data (reads the pack)", "feed_reads", ["--packed-data", str(pack)]),
            ("3a in memory (after)", "feed_after", [])):
        ws = tmp / folder
        ws.mkdir()
        for f in ("full_flow.pt", "flow_left.pt", "flow_right.pt"):
            shutil.copy2(models / f, ws / f)
        common = ["--data", str(data), "--batch-size", str(MAIN_BATCH), "--device", "cuda",
                  "--model-dir", str(ws), *packed_flags]
        existed = pack.exists()
        _, summary, counts[path] = _train(train_cli, common, path)
        if packed_flags and (existed != path.endswith("reads the pack)") or not pack.exists()):
            raise AssertionError(f"{path}: the pack existed before: {existed}")
        k1 = {k: counts[path][k] for k in ("res_block_forward", "res_block_backward")}
        if k1 != {k: in_memory[k] for k in k1}:
            raise AssertionError(f"{path}: K1 calls {k1}, the in-memory epoch made {in_memory}")
        rates[path] = summary["poses_per_sec"]
        _log(f"[feed] {path}: {summary['steps']} steps, loss {summary['last']['loss']:.4f}; K1 "
             f"calls {k1['res_block_forward']} forward + {k1['res_block_backward']} backward, "
             f"as the in-memory epoch")
    gather = _gather_rate(tmp)
    _log(f"[feed] pack_data: {info['n_rows']} rows x {info['n_cols']}; 3a epoch poses/s: "
         + ", ".join(f"{k} {v}" for k, v in rates.items())
         + f", in memory (the main path) {in_memory_rate}; one shuffled pass over "
         f"{GATHER_ROWS} x 34 f32 ({GATHER_ROWS * 34 * 4 / 1e6:.0f} MB), rows/s: "
         + ", ".join(f"{k} {v:.0f}" for k, v in gather.items()) + f" on {smi}")
    return counts


def phase_attention(data: Path, models: Path, tmp: Path) -> dict:
    """3a --attention: one training step on the card against the CPU (its K1
    calls counted exactly); then one epoch of the trainer into a fresh
    directory (the main path's flows), ``lift`` and ``eval_h36m`` of what it
    wrote, and ``lift --fused``, which must refuse attention lifters. ->
    counts by path."""
    phase_step_card_vs_cpu("3a attention")
    attn = tmp / "attention"
    attn.mkdir()
    for f in ("full_flow.pt", "flow_left.pt", "flow_right.pt"):
        shutil.copy2(models / f, attn / f)
    common = ["--data", str(data), "--batch-size", str(MAIN_BATCH), "--device", "cuda",
              "--model-dir", str(attn)]
    counts = {}
    state, summary, counts["3a --attention"] = _train(train_cli, common + ["--attention"],
                                                      "3a --attention")
    n_steps = 5 * TRAIN_POSES // MAIN_BATCH
    fwd, bwd = K1_PER_STEP["3a attention"][:2]
    k1 = counts["3a --attention"]
    if not isinstance(state.model.left, AttentionLifter) \
            or k1["res_block_backward"] != n_steps * bwd \
            or k1["res_block_forward"] <= n_steps * fwd:
        raise AssertionError(f"3a --attention: residual-block launches {k1}")
    _, counts["lift 3a --attention"] = _lift(common, [], tmp / "a.npz", "3a --attention")
    results, counts["eval 3a --attention"] = _eval(data, attn, ["--json"], "3a --attention")
    for path in ("lift 3a --attention", "eval 3a --attention"):
        if counts[path]["res_block_forward"] < 1 or counts[path]["fused_sides_forward"]:
            raise AssertionError(f"{path} launched {counts[path]}")
    try:
        lift.main(common + ["--fused", "--out", str(tmp / "af.npz")])
        raise AssertionError("lift --fused served attention lifters")
    except ValueError as e:
        if "attention lifters" not in str(e):
            raise
    _log(f"[attention] 3a --attention: {n_steps} steps, loss {summary['last']['loss']:.4f}, "
         f"pa_left {summary['last']['pa_left']:.2f}; K1 launches {k1['res_block_forward']} "
         f"forward + {k1['res_block_backward']} backward; lift of what it wrote: finite, "
         f"{counts['lift 3a --attention']['res_block_forward']} res_block_forward launches; "
         f"eval: pa_mpjpe {results['pa_mpjpe']:.4f}, "
         f"{counts['eval 3a --attention']['res_block_forward']} launches; lift --fused refused")
    return counts


def _lift_rate(served: list, flags: list, out: Path) -> float:
    """lift's own poses/s (timed after its warm-up chunk) of 2 TEST_POSES poses."""
    with contextlib.redirect_stdout(io.StringIO()) as text:
        lift.main(served + flags + ["--out", str(out)])
    return json.loads(text.getvalue().strip().splitlines()[-1])["poses_per_sec"]


def phase_serving_times(data: Path, models: Path, tmp: Path, smi: str):
    """The serving entry points' rates, before any torch.profiler session: the
    daemon under SERVE_CLIENTS concurrent clients x SERVE_TIMED_ROUNDS
    requests of SERVE_POSES poses (f32, K1's forward), coalesced and not
    (after one warm-up round each); ``lift``'s poses/s over its 4096 poses
    for f32, bf16, --fused, int8 and int8-static."""
    served = ["--data", str(data), "--model-dir", str(models), "--batch-size", str(MAIN_BATCH),
              "--device", "cuda"]
    poses = np.load(tmp / "serve_poses.npy")
    n_req = SERVE_CLIENTS * SERVE_TIMED_ROUNDS
    for flags in ([], ["--no-coalesce"]):
        with _serving(served + flags) as base:
            _clients(base, poses, 1)
            seconds, _ = _clients(base, poses, SERVE_TIMED_ROUNDS)
            health = _health(base)
        merged = (f"; {health['device_batches']} device runs for {health['merged_requests']} "
                  f"requests" if health["coalescing"] else "")
        _log(f"[time] serve{' ' + flags[0] if flags else ''}: {SERVE_CLIENTS} concurrent "
             f"clients x {SERVE_TIMED_ROUNDS} requests of {SERVE_POSES} poses in "
             f"{seconds:.4f} s: {n_req / seconds:.1f} requests/s, "
             f"{n_req * SERVE_POSES / seconds:.1f} poses/s{merged} on {smi}")
    rates = {name: _lift_rate(served, flags, tmp / "rate.npz") for name, flags in (
        ("f32", []), ("bf16", ["--policy", "bf16"]), ("--fused", ["--fused"]),
        ("int8", ["--quant", "int8"]), ("int8-static", ["--quant", "int8-static"]))}
    _log(f"[time] lift of the trained 3a pair, {2 * TEST_POSES} poses at --batch-size "
         f"{MAIN_BATCH}, poses/s: " + ", ".join(f"{k} {v}" for k, v in rates.items())
         + f" on {smi}")


def phase_metrics_scale(smi: str):
    """PA-MPJPE and the CPS pair of SCALE_POSES pose pairs on the card (the
    order of H36M's test split): the batched 3x3 SVD as one call and in
    chunks of 8192 rows (the JAX package's chunk), each the least of three
    timed runs; the two must agree."""
    g = torch.Generator().manual_seed(5)
    gt = (torch.randn(SCALE_POSES, 51, generator=g) * 200.0).cuda()
    pred = gt + (torch.randn(SCALE_POSES, 51, generator=g) * 40.0).cuda()
    # pa_mpjpe is row by row: chunks of rows are chunks of the SVD
    calls = {"one": lambda: metrics.pa_mpjpe(gt, pred),
             "chunks": lambda: torch.cat([metrics.pa_mpjpe(g, p) for g, p in
                                          zip(gt.split(8192), pred.split(8192))])}
    res = {name: fn() for name, fn in calls.items()}
    ms = {name: min(_time_ms(fn, iters=3, warmup=1)[0] for _ in range(3))
          for name, fn in calls.items()}
    err = float((res["one"] - res["chunks"]).abs().max())
    if not bool(torch.isfinite(res["one"]).all()) or err > 1e-3:
        raise AssertionError(f"pa_mpjpe at {SCALE_POSES} poses: one SVD call and chunks differ "
                             f"by {err:.3e}")
    ga_ms = min(_time_ms(lambda: metrics.get_all(gt, pred), iters=3, warmup=1)[0]
                for _ in range(3))
    _log(f"[metrics] {SCALE_POSES} poses on {smi}: pa_mpjpe {ms['one']:.2f} ms with one SVD "
         f"call, {ms['chunks']:.2f} ms in chunks of 8192 (max abs difference {err:.2e}); "
         f"get_all {ga_ms:.2f} ms")


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def phase_times(prep, smi):
    """K2 per call at each timed batch, before any torch.profiler session: the
    device time from a CUDA graph of the wrapper's call (as the library's),
    the eager device time and the wrapper's host time per call, the plain
    version, the library yardstick and the bound. The kernel's and the
    library's times are the least of three timed runs each, taken in turns
    (one run of a ~0.07 ms kernel can read a third above the others). The
    graph time must beat the library's."""
    rows = {}
    with torch.inference_mode():
        for batch in TIMED_BATCHES:
            left, right = _inputs(batch, seed=1000 + batch)
            lib_graph, _ = _library_forward(prep, left, right)

            def call():
                return K2.fused_sides_forward(prep, left, right)

            graph = _graphed(call)[0]
            runs = [(_time_ms(graph.replay), _time_ms(call), _time_ms(lib_graph.replay))
                    for _ in range(3)]
            row = {"ms": min(r[0][0] for r in runs), "eager_ms": min(r[1][0] for r in runs)}
            host_ms = min(r[1][1] for r in runs)
            row["plain_ms"], _ = _time_ms(
                lambda: K2.fused_sides_forward_reference(prep, left, right))
            row["library_ms"] = min(r[2][0] for r in runs)
            row["bound_ms"], row["bound_by"] = _bound_ms(prep, batch)
            rows[batch] = row
            _log(f"[time] fused_sides_forward B={batch}: kernel {row['ms']:.4f} ms (CUDA graph, "
                 f"least of {' / '.join(f'{r[0][0]:.4f}' for r in runs)}; eager "
                 f"{row['eager_ms']:.4f} ms, wrapper's host time {host_ms:.4f} ms), plain "
                 f"{row['plain_ms']:.4f} ms, library (CUDA graph) {row['library_ms']:.4f} ms, "
                 f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}) on {smi}")
            if row["ms"] >= row["library_ms"]:
                raise AssertionError(f"fused_sides_forward B={batch}: {row['ms']:.4f} ms from a "
                                     f"CUDA graph, not below the library's "
                                     f"{row['library_ms']:.4f} ms")
    return rows


_GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
                     6: "wait event", 7: "event record", 10: "mem alloc", 11: "mem free"}


def _graph_nodes(fn) -> list[str]:
    """The types of the nodes of a CUDA graph of one call of ``fn``, read with
    the driver's cuGraphGetNodes / cuGraphNodeGetType: what one call puts on
    the card, counted exactly (torch.profiler can drop a launch's event)."""
    import ctypes

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"CUDA driver call failed with CUresult {rc}")

    handle = ctypes.c_void_p(int(graph.raw_cuda_graph()))
    n = ctypes.c_size_t(0)
    check(cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    check(cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)))
    types = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)))
        types.append(_GRAPH_NODE_TYPES.get(kind.value, f"type {kind.value}"))
    torch.cuda.synchronize()
    del graph
    return types


def phase_k2_kernels(prep, smi):
    """One K2 call is one CUDA kernel and nothing else, at each timed batch:
    exactly one node, a kernel, in a CUDA graph of one call. torch.profiler
    gives each kernel's device time; it may drop launches' events, so its
    count is only held to at most one launch per call."""
    with torch.inference_mode():
        for batch in TIMED_BATCHES:
            left, right = _inputs(batch, seed=1000 + batch)

            def call():
                return K2.fused_sides_forward(prep, left, right)

            nodes = _graph_nodes(call)
            if nodes != ["kernel"]:
                raise AssertionError(f"fused_sides_forward B={batch}: a CUDA graph of one call "
                                     f"holds {nodes}, not one kernel")
            calls = 20
            text, rows = _kernel_breakdown(call, calls)
            if len(rows) != 1 or rows[0][1] > 1:
                raise AssertionError(f"fused_sides_forward B={batch} ran {text}, not one kernel "
                                     f"per call")
            _log(f"[time] fused_sides_forward B={batch}: one call is one CUDA kernel (graph "
                 f"nodes {nodes}); by kernel (ms per launch, launches per call as profiled): "
                 f"{text} on {smi}")


def _k1_library(x, w1, b1, w2, b2, dy, dtype):
    """The block as torch calls in ``dtype`` (addmm, leaky_relu; the backward
    as the matmuls, leaky_relu_backward and sums autograd runs for them),
    each captured in a CUDA graph: the yardstick for K1 (never used by the
    port). -> (forward graph, backward graph)."""
    x, w1, b1, w2, b2, dy = (t.to(dtype) for t in (x, w1, b1, w2, b2, dy))
    a1 = torch.addmm(b1, x, w1.T)
    h = F.leaky_relu(a1)
    a2 = torch.addmm(b2, h, w2.T)
    lrelu_bwd = torch.ops.aten.leaky_relu_backward

    def fwd():
        return F.leaky_relu(torch.addmm(b2, F.leaky_relu(torch.addmm(b1, x, w1.T)), w2.T)) + x

    def bwd():
        g2 = lrelu_bwd(dy, a2, 0.01, False)
        g1 = lrelu_bwd(g2 @ w2, a1, 0.01, False)
        return dy + g1 @ w1, g1.T @ x, g1.sum(0), g2.T @ h, g2.sum(0)

    return _graphed(fwd)[0], _graphed(bwd)[0]


def _k1_bounds(batch: int, peak: float = BF16_FLOPS):
    """Least times of the block's forward and backward at ``batch`` (f32
    masters) at ``peak`` FLOP/s: forward reads x, W1, b1, W2, b2 and writes
    y, 2 products of 2 B H^2. Backward writes dx, dW, db from dy, x and the
    weights by the cheaper of two designs: recompute a1 and a2 (6 products,
    the TPU kernel's), or read a1, h and a2 saved by the forward (4 products:
    dh, dx, dW1, dW2)."""
    weights = (2 * HIDDEN * HIDDEN + 2 * HIDDEN) * 4
    act = batch * HIDDEN * 4
    product = 2 * batch * HIDDEN * HIDDEN
    return (_bound(weights + 2 * act, 2 * product, peak),
            min(_bound(2 * weights + 3 * act, 6 * product, peak),
                _bound(2 * weights + 6 * act, 4 * product, peak)))


def _kernel_breakdown(fn, calls: int = 20):
    """Device ms per launch of each CUDA kernel ``fn`` launches, and its
    launches per call as the profiler recorded them (torch.profiler; a
    count below the launches per call means events were dropped).
    -> (text, [(ms, launches per call, name)])."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total / 1e3 / e.count, e.count / calls,
             e.key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0])
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows = sorted(rows, reverse=True)
    return ", ".join(f"{name} {ms:.4f} (x{n:.2f})" for ms, n, name in rows), rows


def phase_k1_times(smi):
    """K1 forward and backward per call under the bf16 policy at the batches
    of the training steps (stage 4's frozen lifters 256, the lifter steps 2 x
    256, stage 4's completers 3 x 256) and the validation batch; the f32
    policy at the serving batch (lift, serve and the artifact run chunks of
    256) and the validation batch (the validation lifts run f32). The
    kernels run with a warm weight-plane cache; the cast of one weight is
    timed beside them. The kernel's graph and eager times and the library's
    are the least of three runs each, taken in turns. -> rows by (batch,
    policy, 'forward' or 'backward'), and the ms of one weight cast."""
    w = _k1_inputs(1, seed=12)[1]
    cast_ms, _ = _time_ms(lambda: w.to(torch.bfloat16))
    _log(f"[time] weight cast to bf16 ({HIDDEN} x {HIDDEN}): {cast_ms:.4f} ms, "
         f"{K1_CASTS_PER_STEP} per training step: {K1_CASTS_PER_STEP * cast_ms:.4f} ms on {smi}")
    rows = {}
    for batch, policy, pname in ((256, BF16, "bf16"), (512, BF16, "bf16"), (768, BF16, "bf16"),
                                 (4096, BF16, "bf16"), (256, F32, "f32"), (4096, F32, "f32")):
        x, w1, b1, w2, b2, dy = _k1_inputs(batch, seed=2000 + batch)
        plain_saved = K1.res_block_forward_reference(x, w1, b1, w2, b2, policy)[1:]
        xs, a1, hs, a2 = K1.kernel_saved(x, *plain_saved, policy)
        lib_f, lib_b = _k1_library(x, w1, b1, w2, b2, dy,
                                   torch.bfloat16 if policy is BF16 else torch.float32)
        bounds = _k1_bounds(batch, BF16_FLOPS if policy is BF16 else F32_FLOPS)
        method_bounds = None if policy is BF16 else _k1_bounds(batch, K1_F32_METHOD_FLOPS)
        for which, kernel, plain, lib, (bound, by) in (
                ("forward", lambda: K1.res_block_forward(x, w1, b1, w2, b2, policy),
                 lambda: K1.res_block_forward_reference(x, w1, b1, w2, b2, policy), lib_f,
                 bounds[0]),
                ("backward", lambda: K1.res_block_backward(dy, xs, w1, w2, a1, hs, a2, policy),
                 lambda: K1.res_block_backward_reference(dy, x, w1, w2, *plain_saved, policy),
                 lib_b, bounds[1])):
            graph = _graphed(kernel)[0]
            runs = [(_time_ms(graph.replay), _time_ms(kernel), _time_ms(lib.replay))
                    for _ in range(3)]
            row = {"ms": min(r[0][0] for r in runs), "eager_ms": min(r[1][0] for r in runs)}
            eager_ms, host_ms = row["eager_ms"], min(r[1][1] for r in runs)
            row["plain_ms"], _ = _time_ms(plain)
            row["library_ms"] = min(r[2][0] for r in runs)
            row["bound_ms"], row["bound_by"] = bound, by
            method = ""
            if method_bounds is not None:
                m_bound, m_by = method_bounds[which == "backward"]
                row["method_bound_ms"] = m_bound
                method = (f", at the kernel's own method (bf16 tensor cores, 6 term products "
                          f"per f32 product) {m_bound:.4f} ms ({m_by})")
            rows[batch, pname, which] = row
            _log(f"[time] res_block_{which} {pname} B={batch} by kernel (ms per launch): "
                 f"{_kernel_breakdown(kernel)[0]}")
            _log(f"[time] res_block_{which} {pname} B={batch}: kernel {row['ms']:.4f} ms "
                 f"(CUDA graph, least of {' / '.join(f'{r[0][0]:.4f}' for r in runs)}; eager "
                 f"{eager_ms:.4f} ms, wrapper's host time {host_ms:.4f} ms), "
                 f"plain {row['plain_ms']:.4f} ms, library ({pname} torch calls, CUDA graph) "
                 f"{row['library_ms']:.4f} ms, bound {bound:.4f} ms ({by}, {pname} peak)"
                 f"{method}; weight cast {cast_ms:.4f} ms, not in the kernel's time, on {smi}")
    return rows, cast_ms


def phase_step_times(smi):
    """The training step of each stage at batch 256 (bf16 policy, the
    trainers' defaults), after warm-up: device ms (CUDA events) and host ms
    per step. It runs before any other phase opens torch.profiler or
    captures a CUDA graph, so that it times the steps as the trainers run
    them. -> ({stage: (device ms, host ms)}, {stage: what phase_step_profile
    needs} for 3a and stage 4)."""
    rows, profiles = {}, {}
    for name in STAGE_NAMES:
        stage = _stage(name, seed=4, batch=MAIN_BATCH)
        model = stage.model.cuda()
        frozen = tuple(f.cuda() for f in stage.frozen)
        state = steps.TrainState(model, Adam(model.parameters(), stage.cfg.optim,
                                             steps_per_epoch=40))
        step = stage.step(frozen, stage.cfg)
        data = _synthetic_batch(MAIN_BATCH, seed=9).cuda()
        g = torch.Generator(device="cuda").manual_seed(10)

        def one(step=step, state=state, data=data, g=g, draw=stage.draw):
            return step(state, data, draw(g, MAIN_BATCH, "cuda"))

        rows[name] = _time_ms(one, iters=20, warmup=3)
        step_ms, host_ms = rows[name]
        _log(f"[time] {name} training step B={MAIN_BATCH}: device {step_ms:.4f} ms, host "
             f"{host_ms:.4f} ms per step, {MAIN_BATCH / max(step_ms, host_ms) * 1e3:.1f} poses/s "
             f"on {smi}")
        if name in ("3a", "stage 4"):
            profiles[name] = (step_ms, one, (model, frozen, state, stage.cfg, data, g))
    return rows, profiles


def _step_parts(name: str, model, frozen, state, cfg, data, g) -> dict:
    """Device ms of the parts of a 3a or stage-4 step, each between CUDA
    events (the mean of 10 steps after two warm-up steps): 3a's flow
    augmentation, or stage 4's frozen lifters; then the loss, the backward
    and Adam."""
    if name == "3a":
        frozen = LifterFrozen(*frozen)
        draws = steps.draw_step(g, MAIN_BATCH, "cuda")

        def first():
            return obj.augment_with_samples(frozen.full_flow, data, draws.eps_noise, 0.2, BF16)

        def loss_fn(inp):
            return obj.left_right_loss(model, frozen, inp, draws.u_azim, draws.eps_elev, cfg,
                                       BF16)[0]
    else:
        draws = steps.draw_occlusion(g, MAIN_BATCH, "cuda", cfg.n_rot)

        @torch.no_grad()
        def first():
            return pseudo_3d_from_lifters(*frozen, data, cfg.depth, BF16)

        def loss_fn(pose_3d):
            return occlusion_loss(model, pose_3d, draws.u_rot, None, BF16)[0]

    parts = dict.fromkeys(("augment" if name == "3a" else "lifters", "loss", "backward", "adam"),
                          0.0)
    reps = 10
    for rep in range(reps + 2):  # two warm-up repetitions
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        inp = first()
        ev[1].record()
        loss = loss_fn(inp)
        ev[2].record()
        grads = torch.autograd.grad(loss, list(model.parameters()))
        ev[3].record()
        state.opt.step(grads)
        ev[4].record()
        torch.cuda.synchronize()
        if rep >= 2:
            for i, k in enumerate(parts):
                parts[k] += ev[i].elapsed_time(ev[i + 1]) / reps
    return parts


def phase_step_profile(name: str, step, smi):
    """A step's busy share and launches (torch.profiler over a few steps),
    and a breakdown by part from the same functions, each between CUDA
    events; after the timings that a profiler session would slow."""
    step_ms, one, parts_args = step
    n_prof = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            one()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernel_ms = sum(e.self_device_time_total for e in events if e.device_type.name == "CUDA")
    kernel_ms = kernel_ms / 1e3 / n_prof
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel",
                                                         "cudaLaunchCooperativeKernel",
                                                         "cudaLaunchKernelExC"))
    parts = _step_parts(name, *parts_args)
    _log(f"[time] {name} training step B={MAIN_BATCH}: kernels busy {kernel_ms:.4f} ms per step "
         f"({kernel_ms / step_ms:.1%} of the step's {step_ms:.4f} ms; profiled), "
         f"{launches / n_prof:.0f} kernel launches per step; parts between events (ms) "
         f"{', '.join(f'{k} {v:.4f}' for k, v in parts.items())} on {smi}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    full_f32_matmuls()
    _log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
         f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
         f"x{torch.cuda.device_count()}")

    t_start = time.perf_counter()
    _timed("build", phase_build)
    g = torch.Generator().manual_seed(0)
    stacked = StackedLifter(Lifter(11, HIDDEN, generator=g),
                            Lifter(11, HIDDEN, generator=g)).cuda()
    prep = K2.prepare_fused_weights(stacked)
    k2_err = _timed("K2 vs plain", phase_kernel_vs_plain, prep)
    _timed("K1 split and cache", phase_k1_split_and_cache)
    k1_err = _timed("K1 vs plain", phase_k1_vs_plain)
    for name in STAGE_NAMES:
        _timed(f"step card vs CPU {name}", phase_step_card_vs_cpu, name)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        counts, summaries = _timed("main path", phase_main_path, stacked, tmp)
        data, models = tmp / "synthetic.pkl", tmp / "models"
        _, _, composed = _timed("K1 at the eval batches", phase_k1_eval_batches, data, models)
        counts.update(_timed("eval", phase_eval, data, models, composed))
        _timed("eval card vs CPU", phase_eval_card_vs_cpu, data, models)
        counts.update(_timed("resume", phase_resume, data, models, tmp))
        counts.update(_timed("pipeline eval", phase_pipeline_eval, data, models))
        counts.update(_timed("quant checks", phase_quant, data, models, tmp))
        counts.update(_timed("serve checks", phase_serve, data, models, tmp))
        counts.update(_timed("attention checks", phase_attention, data, models, tmp))
        smi = _smi()
        _log(smi)
        counts.update(_timed("export", phase_export, data, models, tmp, smi))
        counts.update(_timed("feed", phase_feed, data, models, tmp, counts["3a"],
                             summaries["3a"]["poses_per_sec"], smi))
        _timed("metrics at scale", phase_metrics_scale, smi)
        _, profiles = _timed("step times", phase_step_times, smi)
        k2_rows = _timed("K2 times", phase_times, prep, smi)
        _timed("serving times", phase_serving_times, data, models, tmp, smi)
    for name, step in profiles.items():
        _timed(f"step profile {name}", phase_step_profile, name, step, smi)
    k1_rows, cast_ms = _timed("K1 times", phase_k1_times, smi)
    _timed("K2 kernels", phase_k2_kernels, prep, smi)
    _log(f"[phase] host seconds, {time.perf_counter() - t_start:.1f} s in all: "
         + ", ".join(f"{k} {v:.2f}" for k, v in SECONDS.items()))

    def k1_ms(batch, which):
        return k1_rows[batch, "bf16", which]["ms"]

    k1_3a = (K1_FWD_PER_STEP * k1_ms(512, "forward") + K1_BWD_PER_STEP * k1_ms(512, "backward")
             + K1_CASTS_PER_STEP * cast_ms)
    _log(f"[time] K1 in a 3a training step at B=512: {K1_FWD_PER_STEP} forward + "
         f"{K1_BWD_PER_STEP} backward calls + {K1_CASTS_PER_STEP} weight casts = {k1_3a:.4f} ms "
         f"on {smi}")
    n_lifter = K1_STAGE4[0] - K1_STAGE4[1]
    k1_4 = (n_lifter * k1_ms(256, "forward") + K1_STAGE4[1] * (k1_ms(768, "forward")
                                                               + k1_ms(768, "backward"))
            + K1_STAGE4_CASTS[1] * cast_ms)
    _log(f"[time] K1 in a stage-4 training step: {n_lifter} forward calls at B=256 + "
         f"{K1_STAGE4[1]} forward and {K1_STAGE4[1]} backward at B=768 + {K1_STAGE4_CASTS[1]} "
         f"weight casts = {k1_4:.4f} ms on {smi}")

    src = "links_tpu_torch/ops/csrc/"
    kernels = [
        {"name": "fused_sides_forward", "route": "cuda", "source": src + "fused_infer.cu",
         "replaces": "links_tpu/ops/fused_infer.py:101", "max_abs_err": k2_err,
         **k2_rows[MAIN_BATCH]},
        {"name": "res_block_forward", "route": "cuda", "source": src + "resblock.cu",
         "replaces": "links_tpu/experimental/pallas_resblock.py:60", "max_abs_err": k1_err[0],
         **k1_rows[512, "bf16", "forward"]},
        {"name": "res_block_backward", "route": "cuda", "source": src + "resblock.cu",
         "replaces": "links_tpu/experimental/pallas_resblock.py:69", "max_abs_err": k1_err[1],
         **k1_rows[512, "bf16", "backward"]},
    ]
    for k in kernels:  # launches: the main paths' total, and path by path
        by_path = {path: c[k["name"]] for path, c in counts.items() if c[k["name"]]}
        k.update(launches=sum(by_path.values()), launches_by_path=by_path)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
