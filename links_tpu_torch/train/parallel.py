"""Parallel training over ``torch.distributed`` (counterpart of
links_tpu/train/parallel.py): data parallelism, the ZeRO-sharded optimizer,
tensor parallelism over a ('data', 'model') layout and the GPipe trunk over
a ('pipe',) layout.

Data parallelism (make_mesh, shard_batch, replicate, dp_jit_step and
dp_epoch_fn there). The JAX package's DP step is the one-device step on the
global batch, with the gradient reduction placed by XLA. Here it is written
out, as JAX's ``dp_shard_map_step`` and ``make_shard_grad_fn`` write their
psum: every rank holds the whole model, takes its rows of each global batch
and of the step's global draws (``train.steps.shard_draws``), all-reduces
the elevation statistics of the lifter losses (``all_reduce_sum``,
differentiable) and the gradients (``all_reduce_mean_``) and runs the same
Adam update. The models are not wrapped in ``DistributedDataParallel``: the
steps compute their gradients with ``torch.autograd.grad``, which never
runs the ``AccumulateGrad`` hooks its reducer listens to.

A ``Group`` is this process's place on one axis of the run: its rank and
the axis's size within a process group (by default the whole run). Every
collective here takes one. ``init_from_env`` joins the group a launcher
(``python -m torch.distributed.run``) describes in the environment
(``--distributed``); ``spawn`` starts local ranks itself (``--num-devices
N``). A ``Layout`` names the axes of a mesh (``make_mesh_2d``,
``make_mesh_pipe``), one ``Group`` each.

The JAX package reaches ZeRO, TP and PP only from ``__graft_entry__.py``,
never from a CLI, and so does this port: they are library functions.

* ZeRO (``init_zero_state``, ``dp_zero_step``): the parameters raveled into
  one f32 vector, padded to a multiple of the world size; each rank keeps its
  contiguous shard of it and of Adam's moments, all-gathers the parameters
  into the model before the step and reduce-scatters the gradient after.
* DP x TP (``tp_param_specs``, ``tp_shard_``, ``dp_tp_step``): Megatron's
  split of each Linear -> ... -> Linear pair over 'model'; the sharded
  ``ResBlock``, ``Linear`` and ``LayerNorm`` modules take their tensor-
  parallel route (models/lifters.py, core/nn.py) with the differentiable
  collectives below; the batch and the gradient reduction run over 'data'.
* The GPipe trunk (``stack_blocks``, ``pp_trunk_sharding``,
  ``pp_trunk_apply``): stage s of 'pipe' runs its depth slice of a residual
  trunk on microbatches that ``ring_shift`` passes from stage to stage.

gloo carries all_reduce and broadcast for CUDA tensors too, so ranks that
share one card run on gloo (NCCL refuses two ranks on one card); the
collectives in ``GLOO_HOST_STAGED`` it does not carry for them, and those go
through a host copy, decided from the backend and the device
(``host_staged``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from links_tpu_torch.config import OptimConfig
from links_tpu_torch.core.nn import F32, LayerNorm, Linear, Policy, leaky_relu
from links_tpu_torch.train.optim import Adam

# the variables python -m torch.distributed.run sets for each rank
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Group:
    """One rank of a group of ranks: its rank and the group's size within
    ``pg``, the process group its collectives run on (None: the default
    group, every rank of the run), and its device."""

    rank: int
    world: int
    device: torch.device
    pg: dist.ProcessGroup | None = None

    @property
    def writes(self) -> bool:
        """Whether this rank writes logs, weights and checkpoints (rank 0)."""
        return self.rank == 0

    def global_rank(self, rank: int) -> int:
        """The rank in the whole run of this group's rank ``rank``."""
        return rank if self.pg is None else dist.get_global_rank(self.pg, rank)


def writes(group: Group | None) -> bool:
    """True on a one-process run and on rank 0 of a group."""
    return group is None or group.writes


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _rank_device(device: torch.device, index: int) -> torch.device:
    """A rank's device: card ``index`` for a CUDA device, else the CPU."""
    return torch.device("cuda", index) if device.type == "cuda" else device


def launcher_world_size() -> int:
    """The WORLD_SIZE a launcher set; exits, naming one, outside a launcher
    (as ``jax.distributed.initialize()`` fails outside a cluster)."""
    missing = [v for v in LAUNCHER_VARS if v not in os.environ]
    if missing:
        raise SystemExit(f"--distributed: {', '.join(missing)} not set; start the trainer "
                         f"under a launcher, e.g. python -m torch.distributed.run --standalone "
                         f"--nproc_per_node N -m links_tpu_torch.cli.<trainer> --distributed")
    return int(os.environ["WORLD_SIZE"])


def init_from_env(device: torch.device) -> Group:
    """Join the group that ``python -m torch.distributed.run`` describes in
    the environment (NCCL on ``cuda``, gloo on ``cpu``; a CUDA rank computes
    on ``cuda:LOCAL_RANK``). Joins once per process: a second call (the
    pipeline runs its stages in one process) returns the same group."""
    launcher_world_size()
    device = _rank_device(device, int(os.environ["LOCAL_RANK"]))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(_backend(device), init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return Group(dist.get_rank(), dist.get_world_size(), device)


def _run_rank(rank: int, fn, args: tuple, devices: list, backend: str, port: int):
    """The body of spawned rank ``rank``: join the group through the parent's
    store, run ``fn(*args, group=...)``, wait for every rank, leave."""
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // len(devices)))
    store = dist.TCPStore("127.0.0.1", port, len(devices), is_master=False)
    dist.init_process_group(backend, store=store, rank=rank, world_size=len(devices))
    group = Group(rank, len(devices), device)
    try:
        fn(*args, group=group)
        barrier(group)
    except SystemExit as e:  # the parent sees exceptions, not exits
        raise RuntimeError(f"rank {rank}: {e}") from None
    finally:
        dist.destroy_process_group()


def spawn(fn, args: tuple, devices: list, backend: str | None = None):
    """Run ``fn(*args, group=Group(i, n, devices[i]))`` on n = len(devices)
    new local processes (torch.multiprocessing's spawn; ``fn`` is imported
    by module name in each) and wait for all of them. The backend defaults
    to NCCL when every rank has its own card, gloo otherwise; the ranks meet
    at a store this process serves on a free localhost port. A rank's
    failure ends the others and is raised here."""
    import torch.multiprocessing as mp

    devices = [torch.device(d) for d in devices]
    if backend is None:
        cards = [d for d in devices if d.type == "cuda"]
        backend = "nccl" if len(set(cards)) == len(devices) else "gloo"
    store = dist.TCPStore("127.0.0.1", 0, len(devices) + 1, is_master=True,
                          wait_for_workers=False)
    mp.start_processes(_run_rank, (fn, args, devices, backend, store.port), nprocs=len(devices),
                       join=True, start_method="spawn")


def local_devices(device: torch.device, n: int) -> list:
    """The devices of ``n`` spawned ranks: ``cuda:0`` .. ``cuda:n-1`` for a
    CUDA device (refused when fewer cards are visible), else n times the
    CPU."""
    if device.type == "cuda":
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > visible:
            raise SystemExit(f"--num-devices {n}: {visible} CUDA device(s) visible; one rank "
                             f"per card (pass --device cpu for gloo ranks on the CPU)")
    return [_rank_device(device, i) for i in range(n)]


# --------------------------------------------------------------------------
# Collectives

# The collectives gloo does not carry for CUDA tensors: a call of one of them
# on a CUDA tensor over a gloo group copies its tensors to the host, runs
# there and copies the result back (``host_staged``). Probed on an H100 with
# torch 2.11 (tools/gloo_cuda_probe.py): gloo carries all_reduce, broadcast,
# all_gather_into_tensor and reduce_scatter_tensor for CUDA tensors; its
# point-to-point sends write from the device pointer and fail ("Bad
# address"). chip_smoke.py logs the choice.
GLOO_HOST_STAGED = frozenset({"batch_isend_irecv"})


def host_staged(op: str, device: torch.device, pg: dist.ProcessGroup | None = None) -> bool:
    """Whether collective ``op`` on tensors of ``device`` over ``pg`` runs on
    host copies: gloo and a CUDA device, for an op in ``GLOO_HOST_STAGED``."""
    return (device.type == "cuda" and op in GLOO_HOST_STAGED
            and dist.get_backend(pg) == "gloo")


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflatten_(tensors, flat: torch.Tensor):
    """Copy ``flat`` back into ``tensors`` in place (bumping each version)."""
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


@torch.no_grad()
def all_reduce_mean_(tensors, group: Group):
    """Average ``tensors`` over the ranks of ``group``, in place: one
    flattened buffer, a SUM all-reduce, then a division by the world size."""
    tensors = list(tensors)
    flat = _flat(tensors)
    dist.all_reduce(flat, group=group.pg)
    flat /= group.world
    _unflatten_(tensors, flat)
    return tensors


class _AllReduceSum(torch.autograd.Function):
    """SUM over the ranks. The gradient of each rank's input is the sum of
    every rank's gradient of the output, so its backward all-reduces too."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        y = x.clone()
        dist.all_reduce(y, group=pg)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.pg)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group: Group | None = None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (default: every rank),
    differentiable (every rank must call it, forward and backward, in the
    same order). Right where each rank's use of the sum differs (its own
    rows' elevation statistics, a sharded LayerNorm's); where every rank
    computes one replicated loss from it, ``reduce_from_model``."""
    return _AllReduceSum.apply(x, None if group is None else group.pg)


@torch.no_grad()
def broadcast_params_(module: torch.nn.Module, group: Group | None = None):
    """Overwrite ``module``'s parameters and floating buffers with those of
    rank 0 of ``group`` (default: of the run), in place: one broadcast per
    dtype. ``copy_`` bumps each parameter's version, so no bf16 weight plane
    cast before it is reused (``ops/resblock.py:weight_plane``)."""
    pg, src = (None, 0) if group is None else (group.pg, group.global_rank(0))
    tensors = [t for t in (*module.parameters(), *module.buffers()) if t.is_floating_point()]
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        part = [t for t in tensors if t.dtype == dtype]
        flat = _flat(part)
        dist.broadcast(flat, src=src, group=pg)
        _unflatten_(part, flat)


def broadcast_object(obj, group: Group):
    """Rank 0's ``obj`` (picklable) on every rank of ``group``."""
    box = [obj if group.writes else None]
    dist.broadcast_object_list(box, src=group.global_rank(0), group=group.pg)
    return box[0]


def replicate(module: torch.nn.Module, group: Group | None) -> torch.nn.Module:
    """``module`` with rank 0's parameters on every rank of ``group`` (JAX's
    ``replicate``); unchanged without one."""
    if group is not None:
        broadcast_params_(module, group)
    return module


def barrier(group: Group):
    """Return once every rank of ``group`` has called it (an all-reduce of
    one element)."""
    dist.all_reduce(torch.zeros(1, device=group.device), group=group.pg)


def trimmed(n: int, group: Group | None) -> int:
    """``n`` rows cut to a multiple of the world size (the JAX package trims
    a ragged train split so that it shards evenly)."""
    return n if group is None else n - n % group.world


def rows(x: torch.Tensor, group: Group) -> torch.Tensor:
    """This rank's rows of ``x`` (B, ...): ``[r b, (r + 1) b)``, b = B / W."""
    b = x.shape[0] // group.world
    return x[group.rank * b:(group.rank + 1) * b]


def _collective(op: str, fn, out_shape, x: torch.Tensor, group: Group) -> torch.Tensor:
    """``fn(out, x, group=...)`` into a new tensor of ``out_shape`` on
    ``x``'s device, or on host copies where ``host_staged``."""
    staged = host_staged(op, x.device, group.pg)
    src = x.detach().cpu() if staged else x.detach().contiguous()
    out = src.new_empty(out_shape)
    fn(out, src, group=group.pg)
    return out.to(x.device) if staged else out


def _all_gather(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order: (W, *x.shape)."""
    out = _collective("all_gather_into_tensor", dist.all_gather_into_tensor,
                      (group.world * x.shape[0], *x.shape[1:]), x, group)
    return out.view(group.world, *x.shape)


def _reduce_scatter_sum(flat: torch.Tensor, group: Group) -> torch.Tensor:
    """This rank's contiguous 1/W of the SUM over the ranks of ``flat``."""
    return _collective("reduce_scatter_tensor", dist.reduce_scatter_tensor,
                       (flat.numel() // group.world,), flat, group)


def _exchange(x: torch.Tensor, group: Group, shift: int) -> torch.Tensor:
    """Send ``x`` to rank r + shift and return what rank r - shift sent
    (mod W), as one ``batch_isend_irecv`` (a ring of blocking sends can
    deadlock)."""
    if group.world == 1:
        return x.clone()
    staged = host_staged("batch_isend_irecv", x.device, group.pg)
    send = x.detach().cpu() if staged else x.detach().contiguous()
    recv = torch.empty_like(send)
    to = group.global_rank((group.rank + shift) % group.world)
    frm = group.global_rank((group.rank - shift) % group.world)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, to, group=group.pg),
                                       dist.P2POp(dist.irecv, recv, frm, group=group.pg)]):
        req.wait()
    return recv.to(x.device) if staged else recv


class _CopyToModel(torch.autograd.Function):
    """Forward: the identity. Backward: SUM all-reduce of the gradient."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.pg)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Forward: SUM all-reduce. Backward: the identity."""

    @staticmethod
    def forward(ctx, x, pg):
        y = x.clone()
        dist.all_reduce(y, group=pg)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """Forward: all-gather on the last (feature) axis, in rank order.
    Backward: this rank's slice of the gradient's features."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = _all_gather(x, group)  # (W, ..., h)
        return torch.movedim(parts, 0, -2).reshape(*x.shape[:-1], -1)

    @staticmethod
    def backward(ctx, grad):
        g = ctx.group
        h = grad.shape[-1] // g.world
        return grad[..., g.rank * h:(g.rank + 1) * h].contiguous(), None


class _RingShift(torch.autograd.Function):
    """Forward: send to the next rank, receive from the previous one.
    Backward: the inverse shift of the gradient (send to the previous rank,
    receive from the next)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group, -1), None


def copy_to_model(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x`` unchanged; its gradient SUM all-reduced over ``group``: where a
    replicated ``x`` enters work that each rank does on its own shard
    (Megatron's f)."""
    return _CopyToModel.apply(x, group.pg)


def reduce_from_model(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The SUM of ``x`` over ``group``; its gradient passes unchanged (every
    rank computes the same replicated loss from the sum; Megatron's g)."""
    return _ReduceFromModel.apply(x, group.pg)


def gather_from_model(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Every rank's features of ``x`` (..., h) concatenated in rank order
    (..., W h); the gradient of this rank's ``x`` is its slice."""
    return _GatherFromModel.apply(x, group)


def ring_shift(x: torch.Tensor, group: Group) -> torch.Tensor:
    """What rank r - 1 (mod W) of ``group`` passed, having passed ``x`` to
    rank r + 1; the gradient takes the inverse shift. Every rank must call
    it, forward and backward, in the same order."""
    return _RingShift.apply(x, group)


# --------------------------------------------------------------------------
# Layouts (JAX's Mesh, seen from one rank)


@dataclasses.dataclass(frozen=True)
class Layout:
    """This rank's place in a mesh of named axes: for each axis a ``Group``
    whose rank is this rank's coordinate along it, whose world is the axis's
    size, and whose process group holds the ranks that share every other
    coordinate with this one."""

    axes: tuple[str, ...]
    groups: tuple[Group, ...]

    def __getitem__(self, axis: str) -> Group:
        return self.groups[self.axes.index(axis)]

    @property
    def coords(self) -> dict[str, int]:
        return {a: g.rank for a, g in zip(self.axes, self.groups)}


def _check_world(group: Group, need: int, what: str):
    if group.pg is not None or group.world != need:
        raise ValueError(f"{what} needs the {need} ranks of the whole run, got rank "
                         f"{group.rank} of {group.world}" + (" on a subgroup" if group.pg else ""))


def make_mesh_2d(n_data: int, n_model: int, group: Group) -> Layout:
    """The ('data', 'model') layout of the run's n_data x n_model ranks
    (``group``: this rank of the whole run): rank r sits at (r // n_model,
    r % n_model), as JAX's ``reshape(n_data, n_model)`` places devices. Every
    rank makes every axis group, in one order (``dist.new_group``)."""
    _check_world(group, n_data * n_model, f"a ({n_data}, {n_model}) layout")
    d, m = divmod(group.rank, n_model)
    data = [dist.new_group([i * n_model + j for i in range(n_data)]) for j in range(n_model)]
    model = [dist.new_group([i * n_model + j for j in range(n_model)]) for i in range(n_data)]
    return Layout(("data", "model"), (Group(d, n_data, group.device, data[m]),
                                      Group(m, n_model, group.device, model[d])))


def make_mesh_pipe(n_stages: int, group: Group) -> Layout:
    """The ('pipe',) layout of the run's ``n_stages`` ranks: rank r is stage
    r; the axis is the whole run."""
    _check_world(group, n_stages, f"a {n_stages}-stage pipe")
    return Layout(("pipe",), (group,))


# --------------------------------------------------------------------------
# ZeRO: parameters and Adam moments sharded over the ranks


@dataclasses.dataclass
class ZeroState:
    """Train state of the ZeRO-sharded path (JAX's ``ZeroState``): the
    model's parameters raveled in ``parameters()`` order into one f32 vector
    of ``size`` elements, padded with zeros to ``padded``, a multiple of the
    world size; this rank holds its contiguous shard of it
    (``flat_params``, padded / W elements) and ``opt``, Adam over that one
    shard: its moments are the shard's (bf16 at rest with ``bf16_moments``),
    and Adam is elementwise, so they are the moments over the parameters.
    Resident per rank: 3 P / W plus the model's one gathered copy."""

    flat_params: torch.Tensor
    opt: Adam
    size: int
    padded: int
    step: int = 0

    @property
    def pad(self) -> int:
        return self.padded - self.size


def _shard(flat: torch.Tensor, padded: int, group: Group) -> torch.Tensor:
    """This rank's contiguous shard of ``flat`` padded with zeros to ``padded``."""
    n = padded // group.world
    return F.pad(flat, (0, padded - flat.numel()))[group.rank * n:(group.rank + 1) * n].clone()


def init_zero_state(model: nn.Module, cfg: OptimConfig, group: Group, steps_per_epoch: int,
                    state: dict | None = None) -> ZeroState:
    """This rank's ``ZeroState`` of ``model``'s parameters (on the model's
    device), with fresh Adam moments; or, from ``state`` (what
    ``zero_gather`` or ``ckpt.torch_io.zero_state_from_jax`` return:
    per-parameter lists ``params``, ``mu``, ``nu``, and ``count``,
    ``step``), that state's shards."""
    device = next(model.parameters()).device

    def flat(tensors):
        return _flat([t.float() for t in tensors]).to(device)

    full = flat(p.detach() for p in model.parameters()) if state is None \
        else flat(state["params"])
    size = full.numel()
    padded = size + (-size) % group.world
    opt = Adam([_shard(full, padded, group)], cfg, steps_per_epoch)
    z = ZeroState(opt.params[0], opt, size, padded)
    if state is not None:
        opt.mu, opt.nu = ([_shard(flat(state[k]), padded, group).to(opt.mu[0].dtype)]
                          for k in ("mu", "nu"))
        opt.count, z.step = int(state["count"]), int(state["step"])
    shards = {z.flat_params.numel(), opt.mu[0].numel(), opt.nu[0].numel()}
    if shards != {padded // group.world}:
        raise RuntimeError(f"ZeRO shards of {shards} elements, expected {padded // group.world}")
    return z


def _global_sq_norm(sq: torch.Tensor, group: Group) -> torch.Tensor:
    sq = sq.reshape(1).clone()
    dist.all_reduce(sq, group=group.pg)
    return sq[0]


def dp_zero_step(grads_fn: Callable, model: nn.Module, group: Group) -> Callable:
    """-> ``step(state, batch, draws) -> aux``, one update of a
    ``ZeroState`` (JAX's ``dp_zero_step``): all-gather the parameters into
    ``model``; ``grads_fn(model, batch, draws)`` (a ``build_*_grads`` of
    train/steps.py, the lifters' built with ``group`` for the global
    elevation statistics) on this rank's rows ``batch`` and its part of the
    step's global ``draws``; the gradient flattened, padded and
    reduce-scattered (SUM, then / W: the global batch's mean); the
    global-norm clip with the squared norm summed over the ranks; coupled
    decay and Adam on the shard. Padded lanes stay exactly 0: their gradient
    is 0, and so is the decay of a zero parameter. The aux terms are this
    rank's. After the last step, ``zero_gather`` (or one more gather) gives
    the updated parameters."""
    from links_tpu_torch.train import steps  # steps imports this module

    params = list(model.parameters())

    def step(state: ZeroState, batch: torch.Tensor, draws) -> dict:
        full = _all_gather(state.flat_params, group).reshape(-1)
        with torch.no_grad():
            _unflatten_(params, full[:state.size])
        aux, grads = grads_fn(model, batch, steps.shard_draws(draws, group))
        flat = F.pad(_flat(grads), (0, state.pad))
        shard = _reduce_scatter_sum(flat, group) / group.world
        norm = None
        if state.opt.cfg.clip_grad_norm:
            norm = _global_sq_norm(shard.square().sum(), group).sqrt()
        state.opt.step([shard], norm=norm)
        state.step += 1
        return aux

    return step


@torch.no_grad()
def zero_gather(state: ZeroState, model: nn.Module, group: Group) -> dict:
    """The whole ZeRO state on every rank, unflattened into ``model``'s
    parameter shapes (f32; pads dropped): ``{"params": [...], "mu": [...],
    "nu": [...], "count": int, "step": int}``, lists in ``parameters()``
    order."""
    params = list(model.parameters())
    out = {"count": state.opt.count, "step": state.step}
    for key, shard in (("params", state.flat_params), ("mu", state.opt.mu[0]),
                       ("nu", state.opt.nu[0])):
        flat = _all_gather(shard.float(), group).reshape(-1)[:state.size]
        out[key] = [t.view_as(p).clone()
                    for t, p in zip(flat.split([p.numel() for p in params]), params)]
    return out


# --------------------------------------------------------------------------
# Tensor parallelism over a ('data', 'model') layout
#
# Megatron's split of each Linear -> ... -> Linear pair, as JAX's
# ``tp_param_specs`` annotates it: the producer's weight splits on fan_out
# (torch's dim 0, the bias with it), the consumer's on fan_in (dim 1, the
# bias replicated), so the activation between them stays split on features
# and the one communication is a sum after the second product.

_COLUMN_LINEARS = frozenset({"l1", "upscale"})           # shard fan_out
_ROW_LINEARS = frozenset({"l2", "downscale", "angles"})  # shard fan_in
_SHARDED_NORMS = frozenset({"bn1"})                      # JAX's ln1: on l1's features


class TPRole(NamedTuple):
    """How ``tp_shard_`` split a module over 'model': ``kind`` "column"
    (fan_out, bias with it), "row" (fan_in, bias replicated) or "features" (a
    LayerNorm on a column's output), and the 'model' group."""

    kind: str
    group: Group


def _role(module_name: str) -> str | None:
    name = module_name.rsplit(".", 1)[-1]
    return ("column" if name in _COLUMN_LINEARS else "row" if name in _ROW_LINEARS
            else "features" if name in _SHARDED_NORMS else None)


def tp_param_specs(model: nn.Module) -> dict[str, int | None]:
    """For each parameter of ``model`` (by name, in ``parameters()`` order)
    the dim that splits over 'model', or None (replicated), decided by the
    role of the module that owns it, as JAX's ``tp_param_specs``: ``l1`` and
    ``upscale`` weights and biases dim 0; ``l2``, ``downscale`` and
    ``angles`` weights dim 1, biases replicated; ``bn1`` (a LayerNorm on
    l1's output) dim 0; everything else (flows, attention, ``bn2``)
    replicated. Lifters, completers and the pose discriminator share these
    names."""
    specs = {}
    for name, p in model.named_parameters():
        owner, _, field = name.rpartition(".")
        role = _role(owner)
        specs[name] = (0 if role in ("column", "features")
                       else 1 if role == "row" and field == "weight" else None)
    return specs


def tp_shard_(model: nn.Module, layout: Layout) -> nn.Module:
    """Split ``model``'s parameters over 'model' in place (this rank keeps
    its part of each, ``tp_param_specs``) and mark each split ``Linear``
    and ``LayerNorm`` with its ``TPRole``, from which it and the
    ``ResBlock`` that holds it take their tensor-parallel route, which
    calls no kernel. ``ValueError`` for a width the 'model' size does not
    divide, and for a split module that is no plain ``Linear`` or
    ``LayerNorm`` (an int8 one). JAX's ``tp_state_shardings``: Adam built
    over the split model keeps shard-local moments."""
    group = layout["model"]
    specs = tp_param_specs(model)
    split = {}
    for name, module in model.named_modules():
        role = _role(name)
        if role is None:
            continue
        if not isinstance(module, LayerNorm if role == "features" else Linear):
            raise ValueError(f"tensor parallelism: {name} is a {type(module).__name__}, not "
                             f"a {'LayerNorm' if role == 'features' else 'Linear'}")
        for field, p in module.named_parameters(recurse=False):
            dim = specs[f"{name}.{field}"]
            if dim is not None and p.shape[dim] % group.world:
                raise ValueError(f"tensor parallelism: {name}.{field} has {p.shape[dim]} "
                                 f"features on dim {dim}, not a multiple of the model size "
                                 f"{group.world}")
            if dim is not None:
                split[module, field] = p.detach().chunk(group.world, dim)[group.rank].clone()
        split[module, None] = role
    for (module, field), value in split.items():
        if field is None:
            module.tp = TPRole(value, group)
        else:
            setattr(module, field, nn.Parameter(value))
    return model


@torch.no_grad()
def tp_gather(tensors, specs, group: Group) -> list:
    """Each of ``tensors`` (a model's parameters split by ``tp_shard_``, or
    tensors of their shapes: gradients, Adam moments) whole on every rank:
    all-gathered over 'model' (``group``) on its dim in ``specs`` (a
    ``tp_param_specs`` in the same order); replicated ones as they are."""
    out = []
    for t, dim in zip(tensors, specs):
        t = t.float()
        out.append(t.clone() if dim is None
                   else torch.cat(list(_all_gather(t, group)), dim=dim))
    return out


def _tp_norm(grads, specs, group: Group) -> torch.Tensor:
    """The global norm of a split model's gradient: the squares of the split
    parts summed over 'model', the replicated ones counted once."""
    sq = torch.stack([g.square().sum() for g in grads])
    split = torch.tensor([d is not None for d in specs], device=sq.device)
    return (_global_sq_norm(sq[split].sum(), group) + sq[~split].sum()).sqrt()


def dp_tp_step(grads_fn: Callable, model: nn.Module, layout: Layout) -> Callable:
    """-> ``step(state, batch, draws) -> aux``, one DP x TP update of a
    ``TrainState`` whose model ``tp_shard_`` split (JAX's ``dp_tp_step``):
    ``grads_fn(model, batch, draws)`` (the lifters' built with
    ``layout["data"]``) on this rank's rows of the global batch over 'data'
    and its part of the step's global draws; the gradients of split and
    replicated parameters alike averaged over 'data' only; the global-norm
    clip over the whole (unsplit) gradient; then Adam, shard-local. The aux
    terms are this rank's."""
    from links_tpu_torch.train import steps  # steps imports this module

    data, specs = layout["data"], list(tp_param_specs(model).values())

    def step(state, batch: torch.Tensor, draws) -> dict:
        aux, grads = grads_fn(state.model, batch, steps.shard_draws(draws, data))
        all_reduce_mean_(grads, data)
        norm = None
        if state.opt.cfg.clip_grad_norm:
            norm = _tp_norm(grads, specs, layout["model"])
        state.opt.step(grads, norm=norm)
        state.step += 1
        return aux

    return step


# --------------------------------------------------------------------------
# The GPipe trunk over a ('pipe',) layout
#
# A depth-D trunk of residual blocks, ``leaky_relu(block(h))`` each (JAX's
# ``_pp_stage``): stage s holds blocks [s D/S, (s + 1) D/S); microbatch m
# enters stage 0 at tick m and leaves stage S - 1 at tick m + S - 1, each
# tick one ``ring_shift`` of a (B / n_micro, H) activation.


def stack_blocks(blocks) -> nn.ModuleList:
    """A list of ``ResBlock``s as one depth-D trunk (JAX's stacked pytree),
    block i at index i."""
    return nn.ModuleList(blocks)


def pp_trunk_sharding(layout: Layout, blocks: nn.ModuleList) -> range:
    """The depth indices of the blocks this stage holds: [s D/S, (s + 1) D/S)
    (JAX's sharding of the depth axis over 'pipe'). ``pp_trunk_apply``
    reads no other block: a stage may hold the others on the meta device."""
    pipe = layout["pipe"]
    if len(blocks) % pipe.world:
        raise ValueError(f"trunk depth {len(blocks)} not divisible by {pipe.world} pipe stages")
    per = len(blocks) // pipe.world
    return range(pipe.rank * per, (pipe.rank + 1) * per)


def pp_trunk_apply(blocks: nn.ModuleList, x: torch.Tensor, layout: Layout, n_micro: int,
                   policy: Policy = F32) -> torch.Tensor:
    """GPipe forward of the trunk (JAX's ``pp_trunk_apply``), differentiable
    through autograd on every rank: ``x`` (B, H), replicated over 'pipe',
    with B % n_micro == 0 -> the trunk's output, replicated. The sequential
    trunk's function; each stage runs its blocks (``pp_trunk_sharding``) on
    the residual-block kernel on the card.

    Schedule: n_micro + S - 1 ticks; at tick t stage 0 takes microbatch t and
    stage s > 0 what stage s - 1 passed; stage s computes at the ticks s <=
    t < s + n_micro. Bubble ticks only exchange: a stage outside its ticks
    computes nothing and passes on what it took (JAX's masked ``where``
    computes them and discards the result), so each stage calls each of
    its D/S blocks n_micro times forward and n_micro times backward. Every
    rank posts the same ``ring_shift`` at every tick but the last, forward
    and backward: the takes and the last stage's writes are ``torch.where``
    selections, which keep every passed tensor in every rank's graph. The
    last stage's outputs become every stage's through a sum over 'pipe'
    with an identity backward (``reduce_from_model``; JAX's psum with
    ``out_specs=P()``); ``copy_to_model`` on ``x`` gives every stage the
    gradient with respect to it."""
    pipe = layout["pipe"]
    held = pp_trunk_sharding(layout, blocks)
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} not divisible by n_micro={n_micro}")
    n_stages, sid = pipe.world, pipe.rank
    micro = copy_to_model(x, pipe).reshape(n_micro, x.shape[0] // n_micro, x.shape[-1])
    first = torch.tensor(sid == 0, device=x.device)
    last = torch.tensor(sid == n_stages - 1, device=x.device)
    state = torch.zeros_like(micro[0])
    out = [torch.zeros_like(micro[0]) for _ in range(n_micro)]
    ticks = n_micro + n_stages - 1
    for t in range(ticks):
        h = torch.where(first, micro[min(t, n_micro - 1)], state)
        if sid <= t < sid + n_micro:
            for i in held:
                h = leaky_relu(blocks[i](h, policy))
        m = t - (n_stages - 1)  # the microbatch the last stage finishes now
        if m >= 0:
            out[m] = torch.where(last, h, out[m])
        if t < ticks - 1:
            state = ring_shift(h, pipe)
    return reduce_from_model(torch.cat(out), pipe).reshape(x.shape)
