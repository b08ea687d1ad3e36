"""Lifter, completer and flow weights in and out of the port (counterpart
of links_tpu/ckpt/torch_io.py).

Lifters and completers use the reference-layout ``.pt`` files: ``{upscale,
downscale, angles}.{weight, bias}`` and ``res_*.{l1, l2}.{weight, bias}``
with torch's (out, in) weights, plus ``res_*.{bn1, bn2}.*`` LayerNorm
tensors that the reference always constructs: a model built with
``use_layernorm`` writes and reads its own, any other writes them at their
defaults and ignores them on load (the JAX package's loaders take the same
flag). A completer file also holds the reference's constructed-but-unused
``res_common`` block (written as zeros, ignored on load). The pose
discriminator's file is the reference's layout of its three blocks. An attention lifter (models/attention.py), which the
reference lacks, is saved as its state dict, and ``load_lifter_pt`` tells it
by its ``qkv`` key, as the JAX package's ``lifter_apply`` dispatches on the
``qkv`` leaf. Flows use FrEIA's ``SequenceINN`` layout
(flows/coupling.py). Orbax artifacts need jax and are not read here; the JAX
trainers write ``.pt`` files with ``--save-pt``. Every file is written
atomically (``atomic_save``). ``zero_state_from_jax`` and ``trunk_from_jax``
carry the JAX package's ZeRO state and stacked residual trunk
(links_tpu/train/parallel.py) across, from the objects themselves.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from links_tpu_torch.flows.coupling import Flow
from links_tpu_torch.models import attention
from links_tpu_torch.models.attention import AttentionLifter
from links_tpu_torch.models.completers import BLOCKS, Completer
from links_tpu_torch.models.lifters import (
    CHAIN,
    DISCRIMINATOR_BLOCKS,
    LegTorsoLifter,
    Lifter,
    PoseDiscriminator,
    ResBlock,
    StackedLifter,
)


def atomic_save(obj, path) -> None:
    """``torch.save`` to a temporary name beside ``path``, then a rename: a
    crash mid-write leaves the file as it was."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _params_from_jax(tree, linears, blocks) -> dict[str, torch.Tensor]:
    """A links_tpu pytree as numpy (``{"upscale": {"w": (in, out), "b":
    (out,)}, "res_pose1": {"l1": {...}, "l2": {...}[, "ln1": {"scale",
    "bias"}, "ln2": ...]}, ...}``) -> the port's state dict of those linears
    and residual blocks, LayerNorms as ``bn1``/``bn2``."""
    def linear(prefix, p):
        return {f"{prefix}.weight": torch.from_numpy(np.asarray(p["w"], np.float32).T.copy()),
                f"{prefix}.bias": torch.from_numpy(np.asarray(p["b"], np.float32).copy())}

    sd = {}
    for name in linears:
        sd.update(linear(name, tree[name]))
    for blk in blocks:
        for l in ("l1", "l2"):
            sd.update(linear(f"{blk}.{l}", tree[blk][l]))
        for ln, bn in (("ln1", "bn1"), ("ln2", "bn2")):
            if ln in tree[blk]:
                sd[f"{blk}.{bn}.weight"] = _t(tree[blk][ln]["scale"])
                sd[f"{blk}.{bn}.bias"] = _t(tree[blk][ln]["bias"])
    return sd


def lifter_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """A links_tpu lifter pytree as numpy -> the port's ``Lifter`` state dict."""
    return _params_from_jax(tree, ("upscale", "downscale", "angles"), CHAIN)


def attention_lifter_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """A links_tpu attention-lifter pytree as numpy -> the port's
    ``AttentionLifter`` state dict: ``qkv``'s (64, 3, heads, 64 / heads)
    weight becomes torch's (out, in) layout, (3, heads, 64 / heads, 64)."""
    sd = _params_from_jax(tree, ("embed", "proj", "upscale", "downscale", "angles"),
                          attention.BLOCKS)
    w = np.asarray(tree["qkv"]["w"], np.float32)
    d, _, nh, dh = w.shape
    sd["qkv.weight"] = torch.from_numpy(w.reshape(d, 3 * d).T.reshape(3, nh, dh, d).copy())
    sd["qkv.bias"] = _t(tree["qkv"]["b"])
    sd["pos"] = _t(tree["pos"])
    return sd


def completer_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """A links_tpu completer pytree as numpy -> the port's ``Completer``
    state dict."""
    return _params_from_jax(tree, ("upscale", "downscale"), BLOCKS)


def pose_discriminator_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """A links_tpu pose-discriminator pytree as numpy -> the port's
    ``PoseDiscriminator`` state dict."""
    return _params_from_jax(tree, ("upscale", "downscale"), DISCRIMINATOR_BLOCKS)


def _module_from_state_dict(make, state_dict: dict, unused: tuple, device):
    """``make(hidden, in_dim, out_dim)`` built on the meta device and loaded
    from ``state_dict`` without its keys that contain any of ``unused``;
    every other key must match."""
    sd = {k: v for k, v in state_dict.items() if not any(u in k for u in unused)}
    hidden, in_dim = sd["upscale.weight"].shape
    with torch.device("meta"):
        module = make(hidden, in_dim, sd["downscale.weight"].shape[0])
    module.load_state_dict({k: torch.as_tensor(v, dtype=torch.float32)
                            for k, v in sd.items()}, strict=True, assign=True)
    return module.to(device)


def _save_pt(module, path, blocks, zero_blocks=()) -> None:
    """Write ``module``'s state dict as a reference-layout ``.pt``, with the
    default LayerNorm tensors of those of ``blocks`` and ``zero_blocks`` that
    have none, and the weights of ``zero_blocks`` (constructed, unused) as
    zeros."""
    sd = {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}
    hidden = module.upscale.weight.shape[0]
    for blk in zero_blocks:
        for l in ("l1", "l2"):
            sd[f"{blk}.{l}.weight"] = torch.zeros(hidden, hidden)
            sd[f"{blk}.{l}.bias"] = torch.zeros(hidden)
    for blk in (*blocks, *zero_blocks):
        for bn in ("bn1", "bn2"):
            sd.setdefault(f"{blk}.{bn}.weight", torch.ones(hidden))
            sd.setdefault(f"{blk}.{bn}.bias", torch.zeros(hidden))
    atomic_save(sd, path)


def _unused(use_layernorm: bool, *more: str) -> tuple:
    """The state-dict keys a loader drops: the LayerNorm tensors unless the
    model is built ``use_layernorm``, and ``more``."""
    return (*more, *(() if use_layernorm else (".bn",)))


def lifter_from_state_dict(state_dict: dict, device="cpu",
                           use_layernorm: bool = False) -> Lifter | AttentionLifter:
    """Build a ``Lifter`` of the state dict's width (its ``bn*`` keys read
    with ``use_layernorm``, else ignored), or an ``AttentionLifter`` of its
    joints, heads and width when it holds a ``qkv`` weight; every other key
    must match."""
    if "qkv.weight" in state_dict:
        joints, heads = state_dict["pos"].shape[0], state_dict["qkv.weight"].shape[1]
        return _module_from_state_dict(
            lambda hidden, *_: AttentionLifter(joints, heads, hidden), state_dict, (), device)
    return _module_from_state_dict(
        lambda hidden, in_dim, _: Lifter(in_dim // 2, hidden, use_layernorm=use_layernorm),
        state_dict, _unused(use_layernorm), device)


def load_lifter_pt(path, device="cpu", use_layernorm: bool = False) -> Lifter | AttentionLifter:
    """A lifter checkpoint -> ``Lifter`` (reference layout; LayerNorms read
    with ``use_layernorm``) or ``AttentionLifter`` (its state dict)."""
    return lifter_from_state_dict(
        torch.load(path, map_location="cpu", weights_only=True), device, use_layernorm)


def save_lifter_pt(lifter: Lifter | AttentionLifter, path) -> None:
    """Write ``lifter``: a ``Lifter`` as a reference-layout ``.pt``, with the
    default LayerNorm tensors the reference's loaders expect when it has
    none; an ``AttentionLifter`` as its state dict."""
    if isinstance(lifter, AttentionLifter):
        atomic_save({k: v.detach().cpu().clone() for k, v in lifter.state_dict().items()}, path)
    else:
        _save_pt(lifter, path, CHAIN)


def completer_from_state_dict(state_dict: dict, device="cpu",
                              use_layernorm: bool = False) -> Completer:
    """Build a ``Completer`` of the state dict's width and part sizes; the
    ``res_common`` keys are ignored, the ``bn*`` keys too unless
    ``use_layernorm``; every other key must match."""
    return _module_from_state_dict(
        lambda hidden, in_dim, out_dim: Completer(in_dim // 3, out_dim // 3, hidden,
                                                  use_layernorm=use_layernorm),
        state_dict, _unused(use_layernorm, "res_common."), device)


def load_completer_pt(path, device="cpu", use_layernorm: bool = False) -> Completer:
    """A reference-layout ``.pt`` completer checkpoint -> ``Completer``."""
    return completer_from_state_dict(
        torch.load(path, map_location="cpu", weights_only=True), device, use_layernorm)


def save_completer_pt(completer: Completer, path) -> None:
    """Write ``completer`` as a reference-layout ``.pt``: the keys of the JAX
    package's ``completer_to_torch``, with the zero ``res_common`` block and
    the default LayerNorm tensors where it has none."""
    _save_pt(completer, path, BLOCKS, zero_blocks=("res_common",))


def pose_discriminator_from_state_dict(state_dict: dict, device="cpu",
                                       use_layernorm: bool = False) -> PoseDiscriminator:
    """Build a ``PoseDiscriminator`` of the state dict's width and joints
    (its ``bn*`` keys read with ``use_layernorm``, else ignored); every
    other key must match."""
    return _module_from_state_dict(
        lambda hidden, in_dim, _: PoseDiscriminator(in_dim // 2, hidden,
                                                    use_layernorm=use_layernorm),
        state_dict, _unused(use_layernorm), device)


def load_pose_discriminator_pt(path, device="cpu",
                               use_layernorm: bool = False) -> PoseDiscriminator:
    """A reference-layout ``.pt`` pose-discriminator checkpoint ->
    ``PoseDiscriminator``."""
    return pose_discriminator_from_state_dict(
        torch.load(path, map_location="cpu", weights_only=True), device, use_layernorm)


def save_pose_discriminator_pt(discriminator: PoseDiscriminator, path) -> None:
    """Write ``discriminator`` as a reference-layout ``.pt`` (its three
    blocks, with the default LayerNorm tensors where it has none)."""
    _save_pt(discriminator, path, DISCRIMINATOR_BLOCKS)


def flow_params_from_jax(params, perm) -> dict[str, torch.Tensor]:
    """A links_tpu flow as numpy (``params`` with every leaf stacked over the
    K blocks, ``perm`` (K, D, D)) -> the port's ``Flow`` state dict."""
    sd = {}
    for k in range(len(perm)):
        pre = f"module_list.{k}"
        for i, name in ((0, "l1"), (2, "l2")):
            sd[f"{pre}.subnet.{i}.weight"] = _t(params["subnet"][name]["w"][k]).T.contiguous()
            sd[f"{pre}.subnet.{i}.bias"] = _t(params["subnet"][name]["b"][k])
        sd[f"{pre}.global_scale"] = _t(params["global_scale"][k])[None]
        sd[f"{pre}.global_offset"] = _t(params["global_offset"][k])[None]
        sd[f"{pre}.w_perm"] = _t(perm[k])
        sd[f"{pre}.w_perm_inv"] = _t(perm[k]).T.contiguous()
    return sd


def flow_from_state_dict(state_dict: dict, device="cpu") -> Flow:
    """Build a ``Flow`` of the state dict's dimension, width and depth; every
    key must match."""
    n_blocks = 1 + max(int(k.split(".")[1]) for k in state_dict if k.startswith("module_list."))
    hidden, _ = state_dict["module_list.0.subnet.0.weight"].shape
    dim = state_dict["module_list.0.w_perm"].shape[0]
    with torch.device("meta"):
        flow = Flow(dim, n_blocks, hidden)
    shapes = {k: v.shape for k, v in flow.state_dict().items()}
    flow.load_state_dict({k: torch.as_tensor(v, dtype=torch.float32).reshape(shapes[k])
                          for k, v in state_dict.items()}, strict=True, assign=True)
    return flow.to(device)


def load_flow_pt(path, device="cpu") -> Flow:
    """A FrEIA-layout ``.pt`` flow checkpoint -> ``Flow``."""
    return flow_from_state_dict(torch.load(path, map_location="cpu", weights_only=True), device)


def save_flow_pt(flow: Flow, path) -> None:
    """Write ``flow`` as a FrEIA-layout ``.pt``."""
    atomic_save({k: v.detach().cpu().clone() for k, v in flow.state_dict().items()}, path)


def _index(tree, i: int):
    """Leaf ``[i]`` of every array of a nested dict (one of a stack)."""
    return {k: _index(v, i) if isinstance(v, dict) else np.asarray(v)[i] for k, v in tree.items()}


def _params_of(model, tree) -> list[torch.Tensor]:
    """A links_tpu lifter pytree of ``model`` (a ``StackedLifter``: leaves
    stacked (left, right); a ``LegTorsoLifter``: ``{"legs", "torso"}``; a
    ``Lifter``) -> its tensors in ``model.parameters()`` order, as
    ``lifter_params_from_jax`` converts them."""
    if isinstance(model, StackedLifter):
        parts = {"left": _index(tree, 0), "right": _index(tree, 1)}
    elif isinstance(model, LegTorsoLifter):
        parts = {"legs": tree["legs"], "torso": tree["torso"]}
    elif isinstance(model, Lifter):
        parts = {"": tree}
    else:
        raise ValueError(f"no links_tpu layout for a {type(model).__name__}")
    sd = {(f"{name}." if name else "") + k: v for name, part in parts.items()
          for k, v in lifter_params_from_jax(part).items()}
    return [sd[name].reshape(p.shape) for name, p in model.named_parameters()]


def zero_state_from_jax(z_state, unravel, model) -> dict:
    """A links_tpu ``ZeroState`` and the ``unravel`` of its
    ``init_zero_state`` -> the port's ZeRO state of ``model`` (a
    ``StackedLifter``, ``LegTorsoLifter`` or ``Lifter``), unflattened:
    ``{"params", "mu", "nu"}`` lists of f32 tensors in ``model.parameters()``
    order, ``"count"`` (Adam's updates) and ``"step"``, the form
    ``parallel.zero_gather`` returns and ``parallel.init_zero_state`` takes.
    JAX's flat vector follows ``ravel_pytree``'s sorted-key order in the
    (in, out) layout, so each vector is unravelled there (pads dropped) and
    converted tensor by tensor; never compare the two flat vectors."""
    size = sum(p.numel() for p in model.parameters())
    adam = next(s for s in z_state.opt_state if hasattr(s, "mu") and hasattr(s, "nu"))
    out = {"count": int(np.asarray(adam.count)), "step": int(np.asarray(z_state.step))}
    for key, flat in (("params", z_state.flat_params), ("mu", adam.mu), ("nu", adam.nu)):
        out[key] = _params_of(model, unravel(np.asarray(flat, np.float32)[:size]))
    return out


def trunk_from_jax(stacked) -> torch.nn.ModuleList:
    """A links_tpu ``stack_blocks`` trunk as numpy (each leaf with a leading
    depth axis; LayerNorms as ``ln1``/``ln2``) -> the port's depth-D
    ``ModuleList`` of ``ResBlock``s (``parallel.stack_blocks``'s layout)."""
    depth, hidden, _ = np.asarray(stacked["l1"]["w"]).shape
    blocks = []
    for i in range(depth):
        sd = {k.split(".", 1)[1]: v for k, v in _params_from_jax(
            {"blk": _index(stacked, i)}, (), ("blk",)).items()}
        with torch.device("meta"):
            block = ResBlock(hidden, use_layernorm="ln1" in stacked)
        block.load_state_dict(sd, strict=True, assign=True)
        blocks.append(block)
    return torch.nn.ModuleList(blocks)
