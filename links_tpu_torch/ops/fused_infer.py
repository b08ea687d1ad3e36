"""Fused two-side lifter forward for serving (counterpart of
links_tpu/ops/fused_infer.py).

``fused_sides_forward`` runs BOTH 11-joint side lifters end to end in ONE
launch of a hand-written CUDA kernel (``csrc/fused_infer.cu``, which
replaces the Pallas TPU kernel ``links_tpu/ops/fused_infer.py:_kernel``; the
source's header gives the kernel's bound on the H100 and its design).
Numerics are the ``BF16`` policy: bf16 multiplies, f32 accumulation, f32
bias/LeakyReLU/residual.

``fused_sides_forward_reference`` is the plain PyTorch version of the same
function. The wrapper runs it for tensors on the CPU; for a CUDA tensor it
launches the kernel or raises. Batch <= 512 per call (the latency regime;
``cli/lift.py`` chunks larger requests).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from links_tpu_torch.core.nn import BF16, dense, leaky_relu
from links_tpu_torch.core.skeleton import combine_left_right_pred_1d, split_data_left_right
from links_tpu_torch.models.lifters import CHAIN
from links_tpu_torch.objectives.lifter import depth_to_camera_3d

MAX_BATCH = 512
_TILE = 64  # the kernel's output tile and K step: hidden must be a multiple


def prepare_fused_weights(stacked) -> dict:
    """Pack a ``StackedLifter`` into the kernel's tensors, on the lifter's
    device. Do this once at model load.

    Chain and upscale weights are (in, out) so a row of a weight tile is
    contiguous along the output; the narrow head weights stay (out, in) so a
    warp's dot product reads them contiguously. Weights are bf16 (the
    multiply dtype of the policy), biases f32."""
    sides = (stacked.left, stacked.right)

    def chain(attr):
        return torch.stack([torch.stack([torch.stack([
            getattr(getattr(getattr(s, blk), l), attr).detach()
            for l in ("l1", "l2")]) for blk in CHAIN]) for s in sides])

    def both(fn):
        return torch.stack([fn(s).detach() for s in sides]).contiguous()

    bf16 = torch.bfloat16
    return {
        "w_up": both(lambda s: s.upscale.weight.mT).to(bf16),         # (2, 2J, H)
        "b_up": both(lambda s: s.upscale.bias),                       # (2, H)
        "w_chain": chain("weight").mT.to(bf16).contiguous(),          # (2, 7, 2, H, H)
        "b_chain": chain("bias").contiguous(),                        # (2, 7, 2, H)
        "w_down": both(lambda s: s.downscale.weight).to(bf16),        # (2, J, H)
        "b_down": both(lambda s: s.downscale.bias),                   # (2, J)
        "w_ang": both(lambda s: s.angles.weight).to(bf16),            # (2, 1, H)
        "b_ang": both(lambda s: s.angles.bias),                       # (2, 1)
    }


def _check_batch(left_inp, right_inp) -> int:
    n = left_inp.shape[0]
    if n > MAX_BATCH:
        raise ValueError(
            f"fused serving kernel is the latency path (batch <= {MAX_BATCH}); "
            f"chunk larger requests (cli/lift.py does)")
    if n < 1 or right_inp.shape != left_inp.shape:
        raise ValueError(f"expected two (B, 2J) inputs with 1 <= B, got "
                         f"{tuple(left_inp.shape)} and {tuple(right_inp.shape)}")
    return n


def fused_sides_forward_reference(prep: dict, left_inp: torch.Tensor,
                                  right_inp: torch.Tensor):
    """Plain PyTorch version of the kernel: the same function through the
    ``BF16`` policy's ``dense``. -> (left depth (B, J), right depth,
    left angle (B, 1), right angle)."""
    _check_batch(left_inp, right_inp)
    x = torch.stack([left_inp, right_inp]).float()               # (2, B, 2J)

    def lin(a, w_out_in, b):
        return dense(a, w_out_in, b[:, None, :], BF16)

    cur = lin(x, prep["w_up"].mT, prep["b_up"])
    w, b = prep["w_chain"], prep["b_chain"]
    trunk = depth = None
    for j in range(len(CHAIN)):
        if j == 4:  # the angle chain forks off the trunk
            cur = trunk
        h = leaky_relu(lin(cur, w[:, j, 0].mT, b[:, j, 0]))
        h = leaky_relu(lin(h, w[:, j, 1].mT, b[:, j, 1]))
        cur = leaky_relu(h + cur)
        if j == 0:
            trunk = cur
        elif j == 3:  # pose chain done: depth-offset head
            depth = lin(cur, prep["w_down"], prep["b_down"])
    angle = lin(cur, prep["w_ang"], prep["b_ang"])
    return depth[0], depth[1], angle[0], angle[1]


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from links_tpu_torch.ops import _build

        lib = _build.load("fused_infer")
        p, i, ip, lp = (ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                        ctypes.POINTER(ctypes.c_longlong))
        lib.fused_sides_forward_launch.argtypes = [p] * 18 + [i] * 7 + [p]
        lib.fused_sides_forward_launch.restype = i
        lib.fused_sides_plan.argtypes = [i, i, i, ip, ip, lp, lp]
        lib.fused_sides_plan.restype = i
        lib.fused_sides_error_string.argtypes = [i]
        lib.fused_sides_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(err: int, what: str):
    if err:
        msg = _lib().fused_sides_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


class Plan(NamedTuple):
    grid: int          # cooperative blocks, all resident at once
    splits: int        # blocks that share one output tile's K loop
    work_floats: int   # f32 split-K partials the wrapper allocates
    count_ints: int    # zeroed per-tile counters the wrapper allocates


@functools.lru_cache(maxsize=None)
def plan(device_index: int, batch: int, hidden: int) -> Plan:
    """The launch plan for ``batch`` rows at width ``hidden`` on a device
    (computed once per process: it queries the device)."""
    grid, splits = ctypes.c_int(0), ctypes.c_int(0)
    work, count = ctypes.c_longlong(0), ctypes.c_longlong(0)
    _raise_on(_lib().fused_sides_plan(device_index, batch, hidden, ctypes.byref(grid),
                                      ctypes.byref(splits), ctypes.byref(work),
                                      ctypes.byref(count)), "fused_sides_forward plan")
    return Plan(grid.value, splits.value, work.value, count.value)


_SHAPES = {  # name -> (dtype, shape as a function of (in_dim, H, J))
    "w_up": (torch.bfloat16, lambda i, h, j: (2, i, h)),
    "b_up": (torch.float32, lambda i, h, j: (2, h)),
    "w_chain": (torch.bfloat16, lambda i, h, j: (2, len(CHAIN), 2, h, h)),
    "b_chain": (torch.float32, lambda i, h, j: (2, len(CHAIN), 2, h)),
    "w_down": (torch.bfloat16, lambda i, h, j: (2, j, h)),
    "b_down": (torch.float32, lambda i, h, j: (2, j)),
    "w_ang": (torch.bfloat16, lambda i, h, j: (2, 1, h)),
    "b_ang": (torch.float32, lambda i, h, j: (2, 1)),
}


def fused_sides_forward(prep: dict, left_inp: torch.Tensor, right_inp: torch.Tensor):
    """Both side lifters in one kernel launch: (B, 2J) x 2 ->
    ((B, J), (B, J), (B, 1), (B, 1)) = (left depth, right depth, left angle,
    right angle), B <= 512. CPU tensors take the plain version."""
    n = _check_batch(left_inp, right_inp)
    if left_inp.device.type == "cpu":
        return fused_sides_forward_reference(prep, left_inp, right_inp)
    dev = left_inp.device
    if dev.type != "cuda":
        raise ValueError(f"fused_sides_forward runs on CUDA or CPU tensors, got {dev}")
    x = torch.stack([left_inp, right_inp]).float().contiguous()
    in_dim = x.shape[-1]
    hidden = prep["w_chain"].shape[-1]
    n_out = prep["w_down"].shape[1]
    if hidden % _TILE:
        raise ValueError(f"hidden width {hidden} is not a multiple of {_TILE}")
    for name, (dtype, shape) in _SHAPES.items():
        t = prep[name]
        want = shape(in_dim, hidden, n_out)
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != want \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"prep[{name!r}] must be a contiguous, 16-byte aligned {dtype} tensor "
                f"of shape {want} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    p = plan(index, n, hidden)
    depth = torch.empty(2, n, n_out, device=dev)
    angle = torch.empty(2, n, 1, device=dev)
    act = torch.empty(2, 2, n, hidden, device=dev)                         # cur, trunk
    act_bf = torch.empty(3, 2, n, hidden, device=dev, dtype=torch.bfloat16)  # + hid
    work = torch.empty(p.work_floats, device=dev)
    count = torch.zeros(p.count_ints, device=dev, dtype=torch.int32)
    ptr = lambda t: t.data_ptr()  # noqa: E731
    err = _lib().fused_sides_forward_launch(
        ptr(x), *(ptr(prep[k]) for k in _SHAPES), ptr(depth), ptr(angle),
        ptr(act[0]), ptr(act[1]), ptr(act_bf[0]), ptr(act_bf[1]), ptr(act_bf[2]),
        ptr(work), ptr(count), n, in_dim, hidden, n_out, p.grid, p.splits, index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "fused_sides_forward launch")
    fused_sides_forward.launches += 1
    return depth[0], depth[1], angle[0], angle[1]


fused_sides_forward.launches = 0  # kernel launches since the last reset


def lift_left_right_eval_fused(prep: dict, poses_2d: torch.Tensor,
                               depth_offset: float = 10.0, choice: str = "right"):
    """Fused-kernel twin of ``objectives.lifter.lift_left_right_eval`` under
    the ``BF16`` policy: (N, 34) normalized 2D -> (N, 51) camera-frame 3D."""
    n = poses_2d.shape[0]
    left_inp, right_inp = split_data_left_right(poses_2d)
    ld, rd, _, _ = fused_sides_forward(prep, left_inp, right_inp)
    pred = combine_left_right_pred_1d(ld, rd, choice).reshape(n, 17)
    return depth_to_camera_3d(poses_2d, pred, depth_offset)
