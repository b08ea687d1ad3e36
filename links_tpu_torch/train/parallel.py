"""Data parallelism over ``torch.distributed`` (counterpart of make_mesh,
shard_batch, replicate, dp_jit_step and dp_epoch_fn in
links_tpu/train/parallel.py).

The JAX package's DP step is the one-device step on the global batch, with
the gradient reduction placed by XLA. Here it is written out, as JAX's
``dp_shard_map_step`` writes its psum: every rank holds the whole model,
takes its rows of each global batch and of the step's global draws
(``train.steps.shard_draws``), all-reduces the elevation statistics of the
lifter losses (``all_reduce_sum``, differentiable) and the gradients
(``all_reduce_mean_``) and runs the same Adam update. The models are not
wrapped in ``DistributedDataParallel``: the steps compute their gradients
with ``torch.autograd.grad``, which never runs the ``AccumulateGrad`` hooks
its reducer listens to.

Only ``all_reduce`` and ``broadcast`` are used (and ``broadcast_object_list``,
built on broadcast): gloo carries both for CUDA tensors too, so two gloo
ranks can share one card, which NCCL refuses.

A ``Group`` is this process's place in the run. ``init_from_env`` joins the
group a launcher (``python -m torch.distributed.run``) describes in the
environment (``--distributed``); ``spawn`` starts local ranks itself
(``--num-devices N``).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

# the variables python -m torch.distributed.run sets for each rank
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Group:
    """One rank of a data-parallel run on the default process group."""

    rank: int
    world: int
    device: torch.device

    @property
    def writes(self) -> bool:
        """Whether this rank writes logs, weights and checkpoints (rank 0)."""
        return self.rank == 0


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
    """Average ``tensors`` over the ranks, in place: one flattened buffer,
    a SUM all-reduce, then a division by the world size."""
    tensors = list(tensors)
    flat = _flat(tensors)
    dist.all_reduce(flat)
    flat /= group.world
    _unflatten_(tensors, flat)
    return tensors


class _AllReduceSum(torch.autograd.Function):
    """SUM over the ranks. The gradient of each rank's input is the sum of
    every rank's gradient of the output, so its backward all-reduces too."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable (every rank must call
    it, forward and backward, in the same order)."""
    return _AllReduceSum.apply(x)


@torch.no_grad()
def broadcast_params_(module: torch.nn.Module):
    """Overwrite ``module``'s parameters and floating buffers with rank 0's,
    in place: one broadcast per dtype. ``copy_`` bumps each parameter's
    version, so no bf16 weight plane cast before it is reused
    (``ops/resblock.py:weight_plane``)."""
    tensors = [t for t in (*module.parameters(), *module.buffers()) if t.is_floating_point()]
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        part = [t for t in tensors if t.dtype == dtype]
        flat = _flat(part)
        dist.broadcast(flat, src=0)
        _unflatten_(part, flat)


def broadcast_object(obj, group: Group):
    """Rank 0's ``obj`` (picklable) on every rank."""
    box = [obj if group.writes else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def replicate(module: torch.nn.Module, group: Group | None) -> torch.nn.Module:
    """``module`` with rank 0's parameters on every rank of ``group`` (JAX's
    ``replicate``); unchanged without one."""
    if group is not None:
        broadcast_params_(module)
    return module


def barrier(group: Group):
    """Return once every rank has called it (an all-reduce of one element)."""
    dist.all_reduce(torch.zeros(1, device=group.device))


def trimmed(n: int, group: Group | None) -> int:
    """``n`` rows cut to a multiple of the world size (the JAX package trims
    a ragged train split so that it shards evenly)."""
    return n if group is None else n - n % group.world


def rows(x: torch.Tensor, group: Group) -> torch.Tensor:
    """This rank's rows of ``x`` (B, ...): ``[r b, (r + 1) b)``, b = B / W."""
    b = x.shape[0] // group.world
    return x[group.rank * b:(group.rank + 1) * b]
