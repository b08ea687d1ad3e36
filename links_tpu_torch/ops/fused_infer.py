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
from collections.abc import Mapping
from typing import NamedTuple

import torch

from links_tpu_torch.core.nn import BF16, dense, leaky_relu
from links_tpu_torch.core.skeleton import combine_left_right_pred_1d, split_data_left_right
from links_tpu_torch.models.lifters import CHAIN
from links_tpu_torch.objectives.lifter import depth_to_camera_3d

MAX_BATCH = 512
# Output tile shapes (rows, columns, K tiles per ring slot), in the order the
# plan tries them: the first whose tiles fit one per SM. Rows of 128 take two
# consumer warpgroups. The slot sizes were the fastest of 1, 2 and 4 for each
# shape on an H100 (PERF.md); a slot of 4 becomes 2 where the hidden width is
# not a multiple of 256.
SHAPES = ((64, 16, 4), (64, 64, 2), (128, 64, 1))
MAX_ROW_TILES = 8          # the kernel's (side, row tile) counters
SMEM_BYTES = 232448        # dynamic shared memory a Hopper block can have (227 KB)
MAX_W_LAYERS = 2           # the weight ring holds at most this many layers of a tile
_BARRIER_BYTES = 1024      # room for the rings' mbarriers
_PHASES = 1 + 2 * len(CHAIN)  # the upscale and the chain layers: a bias row each
# per tile column in shared memory: a bias row per phase, the depth head's
# weight rows (up to FusedWeights.MAX_OUT) and the angle head's
_CONST_ROWS = _PHASES + 16 + 1
_COUNTER_INTS = 32         # the kernel uses 2 * MAX_ROW_TILES + 1


class FusedWeights(Mapping):
    """The kernel's tensors (see ``prepare_fused_weights``), checked once
    when built: dtypes, shapes, contiguity, 16-byte alignment, one device.
    Read-only, so a call need not check them again; a plain mapping handed
    to ``fused_sides_forward`` is checked on each call. Also holds the
    kernel's layer counters for each stream it runs on."""

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
    MAX_IN = 32   # the kernel's widest upscale input
    MAX_OUT = 16  # and its widest depth head

    def __init__(self, tensors):
        missing = set(self._SHAPES) - set(tensors)
        if missing:
            raise ValueError(f"fused weights lack {sorted(missing)}")
        self._t = {k: tensors[k] for k in self._SHAPES}
        self._counters = {}  # (device index, stream) -> int32 counters
        self.in_dim = self._t["w_up"].shape[1] if self._t["w_up"].dim() == 3 else -1
        self.hidden = self._t["w_chain"].shape[-1]
        self.n_out = self._t["w_down"].shape[1] if self._t["w_down"].dim() == 3 else -1
        self.device = self._t["w_chain"].device
        for name, bad, what in (
                ("w_chain", self.hidden % 128,
                 f"hidden width {self.hidden}, not a multiple of 128"),
                ("w_up", not 1 <= self.in_dim <= self.MAX_IN,
                 f"input width {self.in_dim}, outside 1..{self.MAX_IN}"),
                ("w_down", not 1 <= self.n_out <= self.MAX_OUT,
                 f"{self.n_out} depth outputs, outside 1..{self.MAX_OUT}")):
            if bad:
                raise ValueError(f"prep[{name!r}] gives {what}")
        for name, (dtype, shape) in self._SHAPES.items():
            t = self._t[name]
            want = shape(self.in_dim, self.hidden, self.n_out)
            if t.device != self.device or t.dtype != dtype or tuple(t.shape) != want \
                    or not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(
                    f"prep[{name!r}] must be a contiguous, 16-byte aligned {dtype} tensor "
                    f"of shape {want} on {self.device}, got {t.dtype} {tuple(t.shape)} on "
                    f"{t.device}")

    def __getitem__(self, name):
        return self._t[name]

    def counters(self, index: int, stream: int) -> torch.Tensor:
        """The kernel's counters for calls on one stream: zeroed once here,
        and every call leaves them zero. Calls on one stream never overlap."""
        if (index, stream) not in self._counters:
            self._counters[index, stream] = torch.zeros(
                _COUNTER_INTS, dtype=torch.int32, device=torch.device("cuda", index))
        return self._counters[index, stream]

    def __iter__(self):
        return iter(self._t)

    def __len__(self):
        return len(self._t)


def prepare_fused_weights(stacked) -> FusedWeights:
    """Pack a ``StackedLifter`` into the kernel's tensors, on the lifter's
    device, and check them. Do this once at model load.

    Chain weights keep torch's (out, in) layout, so a weight tile's rows are
    contiguous along K, the layout ``wgmma`` reads without a transpose; the
    upscale weight is (in, out), contiguous along the columns a thread
    computes; the narrow head weights are (out, in) for a warp's dot
    product. Weights are bf16 (the multiply dtype of the policy), biases
    f32. Attention lifters are refused."""
    sides = (stacked.left, stacked.right)
    if any(hasattr(s, "qkv") for s in sides):
        raise ValueError(
            "the fused serving kernel covers the MLP lifter layout only; these are "
            "attention lifters (a qkv weight): serve them without --fused")

    def chain(attr):
        return torch.stack([torch.stack([torch.stack([
            getattr(getattr(getattr(s, blk), l), attr).detach()
            for l in ("l1", "l2")]) for blk in CHAIN]) for s in sides])

    def both(fn):
        return torch.stack([fn(s).detach() for s in sides]).contiguous()

    bf16 = torch.bfloat16
    return FusedWeights({
        "w_up": both(lambda s: s.upscale.weight.mT).to(bf16),         # (2, 2J, H)
        "b_up": both(lambda s: s.upscale.bias),                       # (2, H)
        "w_chain": chain("weight").to(bf16).contiguous(),             # (2, 7, 2, H, H)
        "b_chain": chain("bias").contiguous(),                        # (2, 7, 2, H)
        "w_down": both(lambda s: s.downscale.weight).to(bf16),        # (2, J, H)
        "b_down": both(lambda s: s.downscale.bias),                   # (2, J)
        "w_ang": both(lambda s: s.angles.weight).to(bf16),            # (2, 1, H)
        "b_ang": both(lambda s: s.angles.bias),                       # (2, 1)
    })


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


def fused_sides_forward_reference(prep, left_inp: torch.Tensor, right_inp: torch.Tensor):
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
        h = leaky_relu(lin(cur, w[:, j, 0], b[:, j, 0]))
        h = leaky_relu(lin(h, w[:, j, 1], b[:, j, 1]))
        cur = leaky_relu(h + cur)
        if j == 0:
            trunk = cur
        elif j == 3:  # pose chain done: depth-offset head
            depth = lin(cur, prep["w_down"], prep["b_down"])
    angle = lin(cur, prep["w_ang"], prep["b_ang"])
    return depth[0], depth[1], angle[0], angle[1]


class Plan(NamedTuple):
    rows: int          # output tile rows (64 per consumer warpgroup)
    cols: int          # output tile columns
    row_tiles: int     # per side
    col_tiles: int
    grid: int          # blocks, one tile each, all resident at once
    a_rows: int        # rows of one TMA box of the activation: the tile's rows below B
    chunk: int         # K tiles of 64 per TMA box and per ring slot
    a_chunks: int      # activation ring slots
    w_chunks: int      # weight ring slots
    smem: int          # dynamic shared memory bytes of a block
    tiles: tuple       # block -> (side, row tile, column tile), as the kernel computes it


def smem_bytes(rows: int, cols: int, a_rows: int, chunk: int, a_chunks: int,
               w_chunks: int) -> int:
    """A block's dynamic shared memory (the kernel's fused_sides_smem_bytes):
    the swizzle's alignment slack, the two rings (an activation slot holds
    ``chunk`` K tiles of ``a_rows`` rows), their barriers,
    and per tile column the biases and head weights."""
    return (1024 + a_chunks * chunk * a_rows * 128
            + w_chunks * chunk * cols * 128 + 16 * (a_chunks + w_chunks)
            + _CONST_ROWS * cols * 4)


def scratch_bytes(rows: int, cols: int, in_dim: int = 32) -> int:
    """What the activation ring holds before phase 1 (the kernel's
    scratch_bytes): the upscale's inputs, the tile's columns of
    w_up as bf16 pairs, its rows of x and its columns of b_up."""
    return (in_dim * (cols // 2 + rows) + cols) * 4


def _rings(a_slot: int, w_slot: int, k_chunks: int, a_min: int,
           free: int) -> tuple[int, int]:
    """(activation, weight) ring slots of these bytes in ``free`` bytes: the
    weight ring first holds one layer of the tile, so that a layer's weights
    can all arrive during the barrier before it; then the activation ring
    takes up to a layer's K (at least ``a_min`` slots), so that a phase's
    input loads are all in flight at once; the weight ring takes what is
    left, up to MAX_W_LAYERS layers. Each ring has at least two slots: one
    chunk's products run while the next chunk's wait."""
    w = max(2, min(k_chunks, (free - a_min * a_slot) // w_slot))
    a = max(a_min, min(k_chunks, (free - w * w_slot) // a_slot))
    w = max(2, min(MAX_W_LAYERS * k_chunks, (free - a * a_slot) // w_slot))
    return a, w


@functools.lru_cache(maxsize=None)
def plan(batch: int, hidden: int, sms: int) -> Plan:
    """The kernel's tile plan for ``batch`` rows per side at width ``hidden``
    on a card with ``sms`` SMs: the first of ``SHAPES`` whose tiles (2 sides x
    row tiles x column tiles) fit one per SM; every block owns one output
    tile in every layer. The rings move the shape's chunks of K tiles and
    share what shared memory the constants leave (see ``_rings``)."""
    if not 1 <= batch <= MAX_BATCH or hidden < 128 or hidden % 128:
        raise ValueError(f"no plan for batch {batch} at hidden width {hidden}")
    for rows, cols, max_chunk in SHAPES:
        row_tiles, col_tiles = -(-batch // rows), hidden // cols
        grid = 2 * row_tiles * col_tiles
        if hidden % cols == 0 and row_tiles <= MAX_ROW_TILES and grid <= sms:
            break
    else:
        raise ValueError(f"the fused kernel needs more than {sms} SMs for batch {batch} at "
                         f"hidden width {hidden}")
    a_rows = min(rows, -(-batch // 8) * 8)
    k_tiles = hidden // 64
    chunk = max_chunk if k_tiles % max_chunk == 0 else 2
    a_slot = chunk * a_rows * 128
    a_min = max(2, -(-scratch_bytes(rows, cols, FusedWeights.MAX_IN) // a_slot))
    free = SMEM_BYTES - 1024 - _BARRIER_BYTES - _CONST_ROWS * cols * 4
    a_chunks, w_chunks = _rings(a_slot, chunk * cols * 128, k_tiles // chunk, a_min, free)
    tiles = tuple((b // (row_tiles * col_tiles), b % row_tiles, (b // row_tiles) % col_tiles)
                  for b in range(grid))
    return Plan(rows, cols, row_tiles, col_tiles, grid, a_rows, chunk, a_chunks, w_chunks,
                smem_bytes(rows, cols, a_rows, chunk, a_chunks, w_chunks), tiles)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from links_tpu_torch.ops import _build

        lib = _build.load("fused_infer")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_sides_forward_launch.argtypes = (
            [p, p, i, i] + [p] * 13 + [i] * 13 + [p])
        lib.fused_sides_forward_launch.restype = i
        lib.fused_sides_smem_bytes.argtypes = [i] * 6
        lib.fused_sides_smem_bytes.restype = i
        lib.fused_sides_error_string.argtypes = [i]
        lib.fused_sides_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(err: int, what: str):
    if err:
        msg = _lib().fused_sides_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def fused_sides_forward(prep, left_inp: torch.Tensor, right_inp: torch.Tensor):
    """Both side lifters in one kernel launch: (B, 2J) x 2 ->
    ((B, J), (B, J), (B, 1), (B, 1)) = (left depth, right depth, left angle,
    right angle), B <= 512. CPU tensors take the plain version."""
    n = _check_batch(left_inp, right_inp)
    if left_inp.device.type == "cpu":
        return fused_sides_forward_reference(prep, left_inp, right_inp)
    dev = left_inp.device
    if dev.type != "cuda":
        raise ValueError(f"fused_sides_forward runs on CUDA or CPU tensors, got {dev}")
    if not isinstance(prep, FusedWeights):
        prep = FusedWeights(prep)
    for name, t in (("left_inp", left_inp), ("right_inp", right_inp)):
        if t.device != prep.device or t.dtype != torch.float32 or t.dim() != 2 \
                or t.shape[1] != prep.in_dim or t.stride(1) != 1:
            raise ValueError(f"{name} must be a float32 (B, {prep.in_dim}) tensor with "
                             f"contiguous rows on {prep.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    hidden, n_out = prep.hidden, prep.n_out
    p = plan(n, hidden, _sms(index))
    stream = torch.cuda.current_stream(dev).cuda_stream
    # depth, angle, then the heads' partial sums over each column tile
    out = torch.empty(2 * n * (n_out + 1) * (1 + p.col_tiles), device=dev)
    depth = out[:2 * n * n_out].view(2, n, n_out)
    angle = out[2 * n * n_out:2 * n * (n_out + 1)].view(2, n, 1)
    planes = torch.empty(3, 2, n, hidden, device=dev, dtype=torch.bfloat16)
    err = _lib().fused_sides_forward_launch(
        left_inp.data_ptr(), right_inp.data_ptr(), left_inp.stride(0), right_inp.stride(0),
        *(prep[k].data_ptr() for k in FusedWeights._SHAPES), planes.data_ptr(),
        depth.data_ptr(), angle.data_ptr(), out[2 * n * (n_out + 1):].data_ptr(),
        prep.counters(index, stream).data_ptr(), n,
        prep.in_dim, hidden, n_out, p.rows, p.cols, p.a_rows, p.chunk, p.a_chunks, p.w_chunks,
        p.smem, p.grid, index, stream)
    _raise_on(err, "fused_sides_forward launch")
    fused_sides_forward.launches += 1
    return depth[0], depth[1], angle[0], angle[1]


fused_sides_forward.launches = 0  # kernel launches since the last reset


def lift_left_right_eval_fused(prep, poses_2d: torch.Tensor,
                               depth_offset: float = 10.0, choice: str = "right"):
    """Fused-kernel twin of ``objectives.lifter.lift_left_right_eval`` under
    the ``BF16`` policy: (N, 34) normalized 2D -> (N, 51) camera-frame 3D."""
    n = poses_2d.shape[0]
    left_inp, right_inp = split_data_left_right(poses_2d)
    ld, rd, _, _ = fused_sides_forward(prep, left_inp, right_inp)
    pred = combine_left_right_pred_1d(ld, rd, choice).reshape(n, 17)
    return depth_to_camera_3d(poses_2d, pred, depth_offset)
