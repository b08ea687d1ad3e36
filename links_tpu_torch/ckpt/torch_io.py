"""Lifter and flow weights in and out of the port (counterpart of
links_tpu/ckpt/torch_io.py).

Lifters use the reference-layout ``.pt`` files: ``{upscale, downscale,
angles}.{weight, bias}`` and ``res_*.{l1, l2}.{weight, bias}`` with torch's
(out, in) weights, plus ``res_*.{bn1, bn2}.*`` LayerNorm tensors that the
reference always constructs and no path uses (present, ignored). Flows use
FrEIA's ``SequenceINN`` layout (flows/coupling.py). Orbax artifacts need jax
and are not read here; the JAX trainers write ``.pt`` files with
``--save-pt``.
"""

from __future__ import annotations

import numpy as np
import torch

from links_tpu_torch.flows.coupling import Flow
from links_tpu_torch.models.lifters import CHAIN, Lifter


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def lifter_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """A links_tpu lifter pytree as numpy (``{"upscale": {"w": (in, out),
    "b": (out,)}, "res_common": {"l1": {...}, "l2": {...}}, ...}``) -> the
    port's ``Lifter`` state dict."""
    def linear(prefix, p):
        return {f"{prefix}.weight": torch.from_numpy(np.asarray(p["w"], np.float32).T.copy()),
                f"{prefix}.bias": torch.from_numpy(np.asarray(p["b"], np.float32).copy())}

    sd = {}
    for name in ("upscale", "downscale", "angles"):
        sd.update(linear(name, tree[name]))
    for blk in CHAIN:
        for l in ("l1", "l2"):
            sd.update(linear(f"{blk}.{l}", tree[blk][l]))
    return sd


def lifter_from_state_dict(state_dict: dict, device="cpu") -> Lifter:
    """Build a ``Lifter`` of the state dict's width; ``bn*`` keys are
    ignored, every other key must match."""
    sd = {k: v for k, v in state_dict.items() if ".bn" not in k}
    hidden, in_dim = sd["upscale.weight"].shape
    with torch.device("meta"):
        lifter = Lifter(in_dim // 2, hidden)
    lifter.load_state_dict({k: torch.as_tensor(v, dtype=torch.float32)
                            for k, v in sd.items()}, strict=True, assign=True)
    return lifter.to(device)


def load_lifter_pt(path, device="cpu") -> Lifter:
    """A reference-layout ``.pt`` lifter checkpoint -> ``Lifter``."""
    return lifter_from_state_dict(
        torch.load(path, map_location="cpu", weights_only=True), device)


def save_lifter_pt(lifter: Lifter, path) -> None:
    """Write ``lifter`` as a reference-layout ``.pt``, with the default
    LayerNorm tensors the reference's loaders expect."""
    sd = {k: v.detach().cpu().clone() for k, v in lifter.state_dict().items()}
    hidden = lifter.upscale.weight.shape[0]
    for blk in CHAIN:
        for bn in ("bn1", "bn2"):
            sd[f"{blk}.{bn}.weight"] = torch.ones(hidden)
            sd[f"{blk}.{bn}.bias"] = torch.zeros(hidden)
    torch.save(sd, path)


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
    torch.save({k: v.detach().cpu().clone() for k, v in flow.state_dict().items()}, path)
