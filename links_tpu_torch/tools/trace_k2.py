"""Where a call of the fused serving kernel (K2) spends its time, phase by
phase, on one NVIDIA GPU.

    python links_tpu_torch/tools/trace_k2.py [--batches 1 256 512] [--hidden 1024]

Builds a copy of ``ops/csrc/fused_infer.cu`` with ``%globaltimer`` stamps
(per block: the start, the end of the upscale's loads, of the upscale and of
phase 0; per chain phase: when the A loader saw its input complete, when the
first input chunk arrived, when the products were done, when the epilogue's
arithmetic and its stores were issued, when its proxy fence returned, when
the tile's counter went up; the heads' wait and their end) into
``links_tpu_torch/ops/_build/trace/`` and runs it through the port's wrapper
on side lifters at the given width (random weights from a seed). For each
batch it prints the kernel's span and, per phase, the mean over blocks of:
the wait from the last tile of the phase before to the loader's acquire
(``barrier``), from there to the first input chunk (``first A``), the
products (``mainloop``) and the epilogue up to the counter
(``epilogue``), and the epilogue's parts (arithmetic, store issue, proxy
fence, barrier and release); the card's name and power limit end the
output. The stamps add a few percent to the kernel's time; the repository's
kernel has none.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from links_tpu_torch.models.lifters import Lifter, StackedLifter  # noqa: E402
from links_tpu_torch.ops import _build  # noqa: E402
from links_tpu_torch.ops import fused_infer as K2  # noqa: E402

SLOTS = 8  # stamps per block and phase
PHASES = 16  # the upscale, 14 chain layers, the heads


def _patch(src: str) -> str:
    """The kernel source with the stamps: stamp (phase, slot) by one thread."""
    def rep(old, new):
        nonlocal src
        if src.count(old) != 1:
            raise RuntimeError(f"trace_k2: the kernel source changed near {old.strip()[:60]!r}")
        src = src.replace(old, new)

    rep("namespace {\n\nconstexpr int kChainBlocks", f"""namespace {{
__device__ long long g_trace[256 * {PHASES} * {SLOTS}];
__device__ __forceinline__ long long gtime() {{
  long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}}
#define TR(ph, i) g_trace[(blockIdx.x * {PHASES} + (ph)) * {SLOTS} + (i)] = gtime()

constexpr int kChainBlocks""")
    rep("        wait_count(counter, nt * phase);  // every tile of phases 0 .. phase - 1\n",
        "        wait_count(counter, nt * phase);  // every tile of phases 0 .. phase - 1\n"
        "        TR(phase, 4);\n")
    rep("  // phase 0, the upscale, its inputs staged",
        "  if (threadIdx.x == 0) TR(0, 0);\n  // phase 0, the upscale, its inputs staged")
    rep("  upscale<BM, BN>(p, scratch, m0, n0, r0, c0, cur);",
        "  if (threadIdx.x == 0) TR(0, 1);\n  upscale<BM, BN>(p, scratch, m0, n0, r0, c0, cur);\n"
        "  if (threadIdx.x == 0) TR(0, 2);")
    rep("  finish_phase<kThreads>(counter, true);\n  // the chain layers' biases",
        "  finish_phase<kThreads>(counter, true);\n  if (threadIdx.x == 0) TR(0, 3);\n"
        "  // the chain layers' biases")
    rep("      mbar_wait(a_full + 8 * as, aph);\n",
        "      mbar_wait(a_full + 8 * as, aph);\n"
        "      if (kc == 0 && threadIdx.x == 0) TR(phase, 1);\n")
    rep("    for (int t = 1; t < kSets; ++t)",
        "    if (threadIdx.x == 0) TR(phase, 2);\n    for (int t = 1; t < kSets; ++t)")
    rep("    finish_phase<kThreads>(counter);\n    // The pose chain's output",
        "    finish_phase<kThreads>(counter);\n    if (threadIdx.x == 0) TR(phase, 3);\n"
        "    // The pose chain's output")
    rep("  if (threadIdx.x == 0) wait_count(counter, nt * kPhases);",
        f"  if (threadIdx.x == 0) {{\n    wait_count(counter, nt * kPhases);\n"
        f"    TR({PHASES - 1}, 1);\n  }}")
    rep("  // The last block to get here",
        f"  if (threadIdx.x == 0) TR({PHASES - 1}, 0);\n  // The last block to get here")
    rep("    store_plane<BN>(p, p.planes + out_plane(phase) * plane_elems, side, r0, c0, acc[0]);",
        "    if (threadIdx.x == 0) TR(phase, 5);\n"
        "    store_plane<BN>(p, p.planes + out_plane(phase) * plane_elems, side, r0, c0, acc[0]);\n"
        "    if (threadIdx.x == 0) TR(phase, 6);")
    rep("__device__ __forceinline__ void finish_phase(int* counter, bool shared_too = false) {",
        "__device__ __forceinline__ void finish_phase(int* counter, bool shared_too = false,\n"
        "                                             int phase = 0) {")
    rep("    fence_proxy_async_global();\n  consumer_sync<kThreads>();",
        "    fence_proxy_async_global();\n  if (threadIdx.x == 0) TR(phase, 7);\n"
        "  consumer_sync<kThreads>();")
    rep("    finish_phase<kThreads>(counter);\n    if (threadIdx.x == 0) TR(phase, 3);",
        "    finish_phase<kThreads>(counter, false, phase);\n    if (threadIdx.x == 0) TR(phase, 3);")
    rep("const char* fused_sides_error_string",
        "int k2_trace(void* dst) {\n"
        "  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));\n}\n\n"
        "const char* fused_sides_error_string")
    return src


def _build_traced() -> ctypes.CDLL:
    out = _build.BUILD_DIR / "trace"
    out.mkdir(parents=True, exist_ok=True)
    (out / "fused_infer_trace.cu").write_text(_patch((_build.CSRC / "fused_infer.cu").read_text()))
    (out / "hopper.cuh").write_text((_build.CSRC / "hopper.cuh").read_text())
    lib_path = out / "libfused_infer_trace.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                        str(out / "fused_infer_trace.cu")], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for the traced kernel:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(lib_path))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 256, 512])
    ap.add_argument("--hidden", type=int, default=1024)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_k2: no CUDA device is available", file=sys.stderr)
        return 1
    K2._lib()  # the wrapper's argument types, then the traced library in its place
    traced = _build_traced()
    for name in ("fused_sides_forward_launch", "fused_sides_smem_bytes",
                 "fused_sides_error_string"):
        fn, ref = getattr(traced, name), getattr(K2._LIB, name)
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
    traced.k2_trace.argtypes = [ctypes.c_void_p]
    K2._LIB = traced

    g = torch.Generator().manual_seed(0)
    prep = K2.prepare_fused_weights(StackedLifter(
        Lifter(11, args.hidden, generator=g), Lifter(11, args.hidden, generator=g)).cuda())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    buf = np.zeros(256 * PHASES * SLOTS, np.int64)
    with torch.inference_mode():
        for batch in args.batches:
            x = (torch.randn(2, batch, 22, generator=g) * 0.1).cuda()
            for _ in range(5):
                K2.fused_sides_forward(prep, x[0], x[1])
            torch.cuda.synchronize()
            if traced.k2_trace(buf.ctypes.data):
                raise RuntimeError("trace_k2: reading the stamps failed")
            p = K2.plan(batch, args.hidden, sms)
            t = buf.reshape(256, PHASES, SLOTS)[:p.grid].astype(np.float64)
            t = (t - t[:, 0, 0].min()) / 1e3  # us from the first block's start
            end = t[:, :, 3]
            print(f"B={batch}: tiles {p.rows} x {p.cols}, grid {p.grid}, slots of {p.chunk} K "
                  f"tiles; kernel span {t[:, PHASES - 1, 0].max():.2f} us, phase 14 ends "
                  f"{end[:, 14].max():.2f}, heads done {t[:, PHASES - 1, 0].mean():.2f} (mean)")
            print(f"  phase 0: loads {np.mean(t[:, 0, 1] - t[:, 0, 0]):.2f}, upscale "
                  f"{np.mean(t[:, 0, 2] - t[:, 0, 1]):.2f}, store and counter "
                  f"{np.mean(t[:, 0, 3] - t[:, 0, 2]):.2f}, ends {end[:, 0].max():.2f} us")
            print("  phase  ends   barrier  first A  mainloop  epilogue  (us)")
            rows = []
            for ph in range(1, 15):
                ready = t[:, ph, 4]
                row = (np.mean(ready - end[:, ph - 1].max()), np.mean(t[:, ph, 1] - ready),
                       np.mean(t[:, ph, 2] - t[:, ph, 1]), np.mean(t[:, ph, 3] - t[:, ph, 2]))
                rows.append(row)
                print(f"  {ph:5d} {end[:, ph].max():7.2f} " + " ".join(f"{v:8.2f}" for v in row))
            print("  mean  " + " " * 7 + " ".join(f"{v:8.2f}" for v in np.mean(rows, axis=0)))
            parts = [(t[:, ph, 5] - t[:, ph, 2], t[:, ph, 6] - t[:, ph, 5],
                      t[:, ph, 7] - t[:, ph, 6], t[:, ph, 3] - t[:, ph, 7]) for ph in range(1, 15)]
            print("  epilogue (mean): arithmetic %.2f, stores issued %.2f, proxy fence %.2f, "
                  "barrier and release %.2f" % tuple(np.mean(parts, axis=(0, 2))))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
