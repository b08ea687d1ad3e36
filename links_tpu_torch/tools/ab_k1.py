"""Compare the residual-block kernel (K1) and the stage-3a training step of
two checkouts of the port on one NVIDIA GPU, in turns.

    git archive <commit> links_tpu_torch | tar -x -C .scratch/parent
    python links_tpu_torch/tools/ab_k1.py .scratch/parent . . .scratch/parent

Each argument is a directory holding a ``links_tpu_torch`` package; each run
is a fresh process that imports the package from there (and builds its
kernels). Per run, one JSON line: the training step at batch 256 (bf16
policy, full-width lifters and flows, random weights from a seed) in ms per
step on the host clock over 20 steps after warm-up, the card's busy ms and
kernel launches per step (``torch.profiler`` over 5 steps), the step's ms
again after that profiler session (it leaves the process slower), K1 under
bf16 at B = 512 and 4096 and at the benchmark's training rows (16,384,
49,152 and 65,536): forward and backward device ms per call from a CUDA
graph of the wrapper's calls, eager ms per call (CUDA events around 50
calls) and the wrapper's host ms per call (the least of 5 runs of 20
enqueues), with the count of those calls' bf16 products by plan (where the
package counts them), K1's f32 forward at B = 1, 50, 256 and 4096 the same way, with
the largest error of each of its outputs y, a1, h, a2 against the plain f32
forward (TF32 off), over that output's largest value, and K1's f32 backward
at B = 256, 512, 768 and 4096 the same way, with the largest error of each
of its gradients dx, dW1, db1, dW2, db2 over that gradient's largest value,
against the plain f32 backward (TF32 off) and against f64 values of the same
gradients. The card's name and power limit end each line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def _one(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from links_tpu_torch.config import LifterTrainConfig, OptimConfig
    from links_tpu_torch.core.nn import BF16, F32, full_f32_matmuls
    from links_tpu_torch.flows import Flow
    from links_tpu_torch.models.lifters import Lifter, StackedLifter
    from links_tpu_torch.objectives.lifter import LifterFrozen
    from links_tpu_torch.ops import resblock as K1
    from links_tpu_torch.train.optim import Adam
    from links_tpu_torch.train.steps import StepDraws, TrainState, build_left_right_step

    full_f32_matmuls()
    hidden, batch = 1024, 256
    out = {"tree": tree}
    g = torch.Generator().manual_seed(4)
    stacked = StackedLifter(Lifter(11, hidden, generator=g),
                            Lifter(11, hidden, generator=g)).cuda()
    frozen = LifterFrozen(*(Flow(d, 8, 1024, generator=g).requires_grad_(False).cuda()
                            for d in (34, 22, 22)))
    cfg = LifterTrainConfig(nll_cap=500.0, batch_size=batch,
                            optim=OptimConfig(bf16_moments=True))
    state = TrainState(stacked, Adam(stacked.parameters(), cfg.optim, steps_per_epoch=40))
    step = build_left_right_step(frozen, cfg)
    data = (torch.randn(batch, 34, generator=g) * 0.1).cuda()
    gc = torch.Generator(device="cuda").manual_seed(10)

    def one():
        return step(state, data, StepDraws(
            torch.randn(batch, 34, generator=gc, device="cuda"),
            torch.rand(2 * batch, 1, generator=gc, device="cuda"),
            torch.randn(2 * batch, 1, generator=gc, device="cuda")))

    def step_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            one()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 20 * 1e3

    for _ in range(3):
        one()
    out["step_ms"] = step_ms()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            one()
        torch.cuda.synchronize()
    events = prof.key_averages()
    out["busy_ms"] = sum(e.self_device_time_total for e in events
                         if e.device_type.name == "CUDA") / 1e3 / 5
    out["launches"] = sum(e.count for e in events if e.key in (
        "cudaLaunchKernel", "cudaLaunchCooperativeKernel")) / 5
    out["step_ms_after_profiler"] = step_ms()

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

    def block_inputs(rows):
        g = torch.Generator().manual_seed(2000 + rows)
        bound = hidden ** -0.5
        w1, w2 = (torch.empty(hidden, hidden).uniform_(-bound, bound, generator=g).cuda()
                  for _ in "12")
        b1, b2 = (torch.empty(hidden).uniform_(-bound, bound, generator=g).cuda() for _ in "12")
        x, dy = (torch.randn(rows, hidden, generator=g).cuda() for _ in "xy")
        return x, w1, b1, w2, b2, dy

    def timed(name, fn):
        out[f"{name}_graph_ms"] = events_ms(graphed(fn).replay)
        out[f"{name}_eager_ms"] = events_ms(fn)
        out[f"{name}_host_ms"] = host_ms(fn)

    products = getattr(K1, "bf16_products", None)
    before = dict(products or {})
    for rows in (512, 4096, 16384, 49152, 65536):
        x, w1, b1, w2, b2, dy = block_inputs(rows)
        want = K1.res_block_forward_reference(x, w1, b1, w2, b2, BF16)
        # the saved tensors of each version's kernel backward
        saved = (K1.kernel_saved(x, *want[1:], BF16) if hasattr(K1, "kernel_saved")
                 else (x, *want[1:]))
        timed(f"fwd{rows}", lambda: K1.res_block_forward(x, w1, b1, w2, b2, BF16))
        timed(f"bwd{rows}", lambda: K1.res_block_backward(dy, saved[0], w1, w2, *saved[1:], BF16))
    if products is not None:
        out["bf16_products"] = {k: v - before[k] for k, v in products.items()}
    for rows in (1, 50, 256, 4096):
        x, w1, b1, w2, b2, _ = block_inputs(rows)
        got = K1.res_block_forward(x, w1, b1, w2, b2, F32)
        want = K1.res_block_forward_reference(x, w1, b1, w2, b2, F32)
        out[f"f32fwd{rows}_rel_err"] = [float((a - b).abs().max() / b.abs().max())
                                        for a, b in zip(got, want)]
        timed(f"f32fwd{rows}", lambda: K1.res_block_forward(x, w1, b1, w2, b2, F32))
    for rows in (256, 512, 768, 4096):
        x, w1, b1, w2, b2, dy = block_inputs(rows)
        _, a1, h, a2 = K1.res_block_forward_reference(x, w1, b1, w2, b2, F32)
        args = (dy, x, w1, w2, a1, h, a2)
        got = K1.res_block_backward(*args, F32)
        want = K1.res_block_backward_reference(*args, F32)
        f64 = K1.res_block_backward_reference(*(t.double() for t in args), F32)
        out[f"f32bwd{rows}_rel_err"] = [float((a - b).abs().max() / b.abs().max())
                                        for a, b in zip(got, want)]
        out[f"f32bwd{rows}_rel_err_f64"] = [float((a.double() - b).abs().max() / b.abs().max())
                                            for a, b in zip(got, f64)]
        timed(f"f32bwd{rows}", lambda: K1.res_block_backward(*args, F32))
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
