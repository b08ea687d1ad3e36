"""Operations and bytes, counted from a configuration's shapes, and the
card's peaks.

``train_step_flops`` counts the products a training step's losses need,
forward and backward (a frozen model's backward computes only the input's
gradient, a trained one's also its weights'; the data's own gradient is not
needed); it leaves out what no loss reads (the angle branch of a re-lift,
the frozen lifters' angle branches) and any recomputation. ``lift_flops``
counts the pose branch of the two side lifters. ``k1_least_s`` is the least
time of one call of the residual-block kernel K1 (``ops/csrc/resblock.cu``):
the larger of its two products' operations at the bf16 peak and the fewest
bytes a correct method moves at the memory peak.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core peak, HBM3 bandwidth.
# Every share is taken against the bf16 peak, whatever the policy.
PEAK_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12

# the kernels of ops/csrc/resblock.cu, by the names the profiler gives them
K1_KERNELS = ("wgmma_gemm", "tf32_gemm", "terms3_gemm", "split_kernel", "bias_grads_kernel",
              "small_kernel")


def is_k1_kernel(name: str) -> bool:
    return any(k in name for k in K1_KERNELS)


def _linear(rows: int, fan_in: int, fan_out: int, grad_x: bool, grad_w: bool) -> tuple:
    """(forward, backward) FLOPs of one linear on ``rows`` rows."""
    f = 2 * rows * fan_in * fan_out
    return f, f * (grad_x + grad_w)


def lifter_flops(joints: int, hidden: int, rows: int, angle: bool, backward: bool,
                 train: bool, input_grad: bool) -> int:
    """A lifter on ``rows`` rows: upscale, res_common and 3 pose blocks and
    the depth head, with ``angle`` 3 angle blocks and the angle head;
    ``backward`` adds the gradients (weights' if ``train``; the input's if
    ``input_grad``)."""
    layers = [(2 * joints, hidden, input_grad)] + [(hidden, hidden, True)] * 8 \
        + [(hidden, joints, True)]
    if angle:
        layers += [(hidden, hidden, True)] * 6 + [(hidden, 1, True)]
    total = 0
    for fi, fo, gx in layers:
        fwd, bwd = _linear(rows, fi, fo, gx, train)
        total += fwd + (bwd if backward else 0)
    return total


def flow_flops(dim: int, blocks: int, hidden: int, rows: int, passes: int) -> int:
    """``passes`` passes (forward, inverse, or an input gradient) of a
    coupling-block stack: per block the subnet's two products and the
    mixing matrix."""
    len2 = dim // 2
    len1 = dim - len2
    per = 2 * rows * (len1 * hidden + hidden * 2 * len2 + dim * dim)
    return blocks * per * passes


def completer_flops(in_joints: int, out_joints: int, hidden: int, rows: int) -> int:
    """A trained completer on ``rows`` rows, forward and backward (no
    gradient for its data input)."""
    layers = [(3 * in_joints, hidden, False)] + [(hidden, hidden, True)] * 6 \
        + [(hidden, 3 * out_joints, True)]
    return sum(sum(_linear(rows, fi, fo, gx, True)) for fi, fo, gx in layers)


def train_step_flops(config: dict, batch: int) -> int:
    """Model FLOPs of one training step of ``config`` at ``batch`` poses."""
    h = config["hidden"]
    if config["stage"] == "left_right":
        fb, fh = config["flow_blocks"], config["flow_hidden"]
        rows = 2 * batch  # the batch and the full flow's samples
        total = flow_flops(config["flows"]["full_flow"], fb, fh, batch, 2)
        for side in ("left", "right"):
            j = config["lifters"][side]
            total += lifter_flops(j, h, rows, angle=True, backward=True, train=True,
                                  input_grad=False)
            # the part flow on the rotated view: forward, and the input's gradient
            total += flow_flops(config["flows"][f"flow_{side}"], fb, fh, rows, 2)
            # the re-lift of the rotated view (its angles feed no loss)
            total += lifter_flops(j, h, rows, angle=False, backward=True, train=True,
                                  input_grad=True)
        return total
    if config["stage"] == "occlusion":
        rows = (config["train"]["n_rot"] + 1) * batch
        total = sum(lifter_flops(j, h, batch, angle=False, backward=False, train=False,
                                 input_grad=False) for j in config["lifters"].values())
        return total + sum(completer_flops(i, o, h, rows)
                           for i, o in config["completers"].values())
    raise ValueError(f"no step count for stage {config['stage']!r}")


def lift_flops(config: dict, poses: int) -> int:
    """Model FLOPs of the left/right lift of ``poses`` poses."""
    return sum(lifter_flops(j, config["hidden"], poses, angle=False, backward=False,
                            train=False, input_grad=False)
               for j in config["lifters"].values())


def k1_calls_per_step(config: dict, batch: int) -> list[tuple[str, int, int]]:
    """(direction, rows, calls) of K1 in one training step."""
    if config["stage"] == "left_right":
        rows = 2 * batch
        # per side: 7 blocks in the lift, 4 (res_common, 3 pose) in the re-lift;
        # the backward skips the re-lift's angle branch
        return [("forward", rows, 2 * 14), ("backward", rows, 2 * 11)]
    if config["stage"] == "occlusion":
        rows = (config["train"]["n_rot"] + 1) * batch
        n = len(config["completers"])
        return [("forward", batch, 7 * len(config["lifters"])), ("forward", rows, 3 * n),
                ("backward", rows, 3 * n)]
    raise ValueError(f"no K1 count for stage {config['stage']!r}")


def k1_least_s(direction: str, rows: int, hidden: int, bf16: bool) -> float:
    """Least seconds of one K1 call: forward y = lrelu(lrelu(x W1 + b1) W2 +
    b2) + x (2 products), backward dh, dx, dW1, dW2 (4 products). Bytes:
    the activations read and written once (f32; x read at 2 bytes under
    bf16, where the products read it rounded), the weights read once at the
    policy's width, the weight gradients written in f32."""
    act = rows * hidden
    w_bytes = 2 * hidden * hidden * (2 if bf16 else 4) + 2 * hidden * 4
    x_bytes = act * (2 if bf16 else 4)
    if direction == "forward":
        flops, nbytes = 2 * 2 * act * hidden, x_bytes + act * 4 + w_bytes
    else:
        flops = 4 * 2 * act * hidden
        nbytes = x_bytes + 2 * act * 4 + w_bytes + 2 * hidden * hidden * 4 + 2 * hidden * 4
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_S)
