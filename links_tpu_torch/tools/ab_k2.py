"""Compare the fused serving kernel (K2) of two checkouts of the port on one
NVIDIA GPU, in turns.

    git archive <commit> links_tpu_torch | tar -x -C .scratch/parent
    python links_tpu_torch/tools/ab_k2.py .scratch/parent . . .scratch/parent

Each argument is a directory holding a ``links_tpu_torch`` package; each run
is a fresh process that imports the package from there (and builds its
kernels). Per run, one JSON line: for side lifters at hidden 1024 (random
weights from a seed) and B = 1, 256 and 512, K2's device ms per call from a
CUDA graph of the wrapper's call (null where the version's launch cannot be
captured), eagerly (CUDA events around 50 calls) and the wrapper's host ms
per call (the least of 5 runs of 20 enqueues); then the serving lift of 4096
poses at chunks of 256 as ``links_tpu_torch.cli.lift --fused`` computes it
(``lift_left_right_eval_fused`` per chunk and one device-to-host copy, after
a warm-up), in seconds. The card's name and power limit end each line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def _one(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch

    from links_tpu_torch.models.lifters import Lifter, StackedLifter
    from links_tpu_torch.ops import fused_infer as K2

    hidden = 1024
    out = {"tree": tree}
    g = torch.Generator().manual_seed(0)
    prep = K2.prepare_fused_weights(StackedLifter(
        Lifter(11, hidden, generator=g), Lifter(11, hidden, generator=g)).cuda())

    def events_ms(fn, iters=50):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def graphed(fn):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        graph.fn = fn  # keeps the tensors fn reads alive
        return graph

    def host_ms(fn):
        best = float("inf")
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            best = min(best, (time.perf_counter() - t0) / 20 * 1e3)
        torch.cuda.synchronize()
        return best

    with torch.inference_mode():
        for batch in (1, 256, 512):
            x = (torch.randn(2, batch, 22, generator=g) * 0.1).cuda()

            def call():
                return K2.fused_sides_forward(prep, x[0], x[1])

            try:
                out[f"b{batch}_graph_ms"] = events_ms(graphed(call).replay)
            except RuntimeError:  # a launch that stream capture refuses
                torch.cuda.synchronize()
                out[f"b{batch}_graph_ms"] = None
            out[f"b{batch}_eager_ms"] = events_ms(call)
            out[f"b{batch}_host_ms"] = host_ms(call)

        poses = (torch.randn(4096, 34, generator=g) * 0.1).cuda()

        def lift():
            got = [K2.lift_left_right_eval_fused(prep, poses[i:i + 256])
                   for i in range(0, poses.shape[0], 256)]
            return torch.cat(got).cpu()

        lift()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lift()
        out["lift_4096_s"] = time.perf_counter() - t0
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 check=True).stdout.strip().splitlines()[0]
    return out


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(_one(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in argv:
        subprocess.run([sys.executable, __file__, "--one", tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
