"""Sweep the tile plans of the residual-block kernel's f32 backward (K1, three
bf16 terms per operand) on one NVIDIA GPU.

    python -m links_tpu_torch.tools.sweep_k1_f32_bwd [B ...]

For each batch (default 1, 256, 512, 768 and 4096; hidden 1024, inputs from
a seed) it runs the backward with ``ops/resblock.py:f32_bwd_plan``'s plan,
then with every (tile, K split, ring depth) of ``F32_BWD_TILES`` and splits
of 1, 2, 4 and 8 (the kernel takes clusters of up to 8) in place of the plan
of dh and dx, and then of dW1 and dW2, the other product kept on its plan.
Per line: the plan tried, the device ms of its two products (the kernels'
device time from ``torch.profiler`` over 20 calls) and the worst error of
the five gradients over each one's largest value against the plain f32
backward (TF32 off). The card's name and power limit end the output.
"""

from __future__ import annotations

import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from links_tpu_torch.core.nn import F32, full_f32_matmuls
from links_tpu_torch.ops import resblock as K1

HIDDEN = 1024
SPLITS = (1, 2, 4, 8)


def _inputs(batch: int):
    g = torch.Generator().manual_seed(batch)
    bound = HIDDEN ** -0.5
    w1, w2 = (torch.empty(HIDDEN, HIDDEN).uniform_(-bound, bound, generator=g) for _ in "12")
    b1, b2 = (torch.empty(HIDDEN).uniform_(-bound, bound, generator=g) for _ in "12")
    x, dy = (torch.randn(batch, HIDDEN, generator=g) for _ in "xy")
    return [t.cuda() for t in (x, w1, b1, w2, b2, dy)]


def _depth(wg: int, cols: int, tk: int, split: int, k: int, pair: bool) -> int:
    """The ring's depth as f32_bwd_plan sizes it, for one or two blocks per SM."""
    local = -(-(-(-k // tk)) // split)
    budget = (K1.SMEM_BYTES + 1024) // 2 - 1024 if pair else K1.SMEM_BYTES
    stage = K1.f32_bwd_stage_bytes(wg, cols, tk)
    least = -(-K1.f32_bwd_parked_bytes(wg, cols) // stage)
    return max(least, min(local, K1.F32_BWD_MAX_STAGES, (budget - 1024) // (stage + 16)))


def _sweep(batch: int, sms: int):
    x, w1, b1, w2, b2, dy = _inputs(batch)
    _, a1, h, a2 = K1.res_block_forward_reference(x, w1, b1, w2, b2, F32)
    want = K1.res_block_backward_reference(dy, x, w1, w2, a1, h, a2, F32)
    scratch = torch.empty(12 * batch * HIDDEN * 2 + 2 * -(-batch // 16) * HIDDEN * 4,
                          dtype=torch.uint8, device="cuda")
    outs = [torch.empty(batch, HIDDEN, device="cuda"), torch.empty(HIDDEN, HIDDEN, device="cuda"),
            torch.empty(HIDDEN, device="cuda"), torch.empty(HIDDEN, HIDDEN, device="cuda"),
            torch.empty(HIDDEN, device="cuda")]
    ptrs = [t.data_ptr() for t in (dy, x, K1.term_planes(w1), K1.term_planes(w2), a1, h, a2,
                                   scratch, *outs)]

    def call(act, wgt):
        err = K1._lib().res_block_backward_f32(*ptrs, batch, HIDDEN, *act, *wgt, 0,
                                               torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err} on plans {act} {wgt}")

    def run(act, wgt, calls=20):
        call(act, wgt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call(act, wgt)
            torch.cuda.synchronize()
        ms = {e.key: e.self_device_time_total / 1e3 / calls for e in prof.key_averages()
              if e.self_device_time_total > 0}
        err = max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(outs, want))
        return ms, err

    plans = K1.f32_bwd_plans(batch, HIDDEN, sms)
    base = [K1._bwd_args(p) for p in plans]
    print(f"B={batch}: plan dh/dx {base[0]}, dW {base[1]} (wg, cols, K tile, split, stages)",
          flush=True)
    for which, k, kernel in ((0, HIDDEN, "false"), (1, batch, "true")):  # dh/dx, then dW
        for wg, cols, tk in K1.F32_BWD_TILES:
            for split in SPLITS:
                if split > 1 and -(-k // tk) // split < K1.F32_BWD_MIN_TILES:
                    continue
                depths = {_depth(wg, cols, tk, split, k, pair)
                          for pair in ((False, True) if wg == 1 else (False,))}
                for depth in sorted(depths, reverse=True):
                    tried = (wg, cols, tk, split, depth)
                    args = [tried, base[1]] if which == 0 else [base[0], tried]
                    try:
                        ms, err = run(*args)
                    except RuntimeError as exc:
                        print(f"  {'dh/dx' if which == 0 else 'dW'} {tried}: {exc}", flush=True)
                        continue
                    mine = sum(v for key, v in ms.items()
                               if "terms3_gemm" in key and f", {kernel}," in key)
                    print(f"  {'dh/dx' if which == 0 else 'dW'} {tried}: {mine:.4f} ms for both "
                          f"products, worst rel err {err:.2e}", flush=True)


def main(argv) -> int:
    full_f32_matmuls()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for batch in [int(b) for b in argv] or (1, 256, 512, 768, 4096):
        _sweep(batch, sms)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
