"""Serving-artifact export (counterpart of links_tpu/ckpt/export_io.py): a
``torch.export`` program in place of the JAX package's serialized StableHLO.

``export_serving`` traces a serving forward, an ``nn.Module`` whose
parameters and buffers are its weights, into one ``ExportedProgram`` and
saves it with ``torch.export.save``: the weights and the program in one
file, written atomically, with the batch dimension symbolic by default
(``torch.export.Dim``) or pinned, and a small JSON record of the platforms
it is meant for, the pinned batch and the torch version that wrote it.
``load_exported`` turns it back into a plain callable on a device.

What it costs: the residual blocks stay the hand-written kernel. The traced
program holds one ``links_tpu_torch::res_block_forward`` op per block
(``ops/resblock.py:res_block_op``) and not the plain path, so the process
that loads an artifact imports ``links_tpu_torch.ops.resblock``, which
registers the op (``load_exported`` and ``exported_info`` do it), and on a
CUDA device the kernel is built from ``ops/csrc/`` at the op's first call.
The JAX artifact needs nothing of its package; this one needs the op
library. Inspecting an artifact needs neither a card nor a build. The fused
serving kernel is not exported (``links_tpu_torch.cli.export_model`` refuses
``--fused``, as the JAX package does).
"""

from __future__ import annotations

import io
import json
import os
from pathlib import Path
from typing import Callable, NamedTuple, Sequence

import torch
from torch import nn

__all__ = ["ServingProgram", "Artifact", "export_serving", "deserialize_exported",
           "program_specs", "load_exported", "exported_info"]

META = "links_tpu_torch_artifact.json"  # the artifact's own record, in its extra files
# the traced sample's rows: torch.export pins a sample dimension of 1
SAMPLE_BATCH = 4


class ServingProgram(nn.Module):
    """A serving forward ``forward(poses_2d (B, 34)) -> (B, 51)`` with the
    modules it reads its weights from (``models``, by name), so that their
    parameters and buffers become the program's."""

    def __init__(self, forward: Callable, models: dict[str, nn.Module]):
        super().__init__()
        self.models = nn.ModuleDict(models)
        self._forward = forward

    def forward(self, poses_2d: torch.Tensor) -> torch.Tensor:
        return self._forward(poses_2d)


def _spec(t) -> str:
    """'float32[b,34]': a traced tensor's dtype and shape, the symbolic batch
    as 'b' (the JAX package's aval text)."""
    dims = ",".join(str(d) if isinstance(d, int) else "b" for d in t.shape)
    return f"{str(t.dtype).removeprefix('torch.')}[{dims}]"


def program_specs(ep) -> tuple[list[str], list[str]]:
    """The user inputs' and outputs' specs of an ``ExportedProgram``."""
    user = set(ep.graph_signature.user_inputs)
    inputs = [_spec(n.meta["val"]) for n in ep.graph.nodes
              if n.op == "placeholder" and n.name in user]
    outputs = [_spec(n.meta["val"]) for n in ep.graph.output_node().args[0]]
    return inputs, outputs


def export_serving(program: nn.Module, out_path, *, batch: int | None = None,
                   platforms: Sequence[str] = ("cuda", "cpu"), device="cpu",
                   mlir_out=None):
    """Trace ``program`` (a ``ServingProgram``; its weights on ``device``) on
    a (B, 34) f32 input and save it to ``out_path``. ``batch=None``
    makes B symbolic (B >= 1); an integer pins it. ``platforms`` names the
    device types the file may be loaded on (``deserialize_exported`` refuses
    any other). ``mlir_out`` also writes the
    program as text (the counterpart of the StableHLO MLIR).

    -> (the ``ExportedProgram``, the file's size in bytes)."""
    sample = torch.zeros(batch or SAMPLE_BATCH, 34, device=device)
    dynamic = None if batch else ({0: torch.export.Dim("b", min=1)},)
    with torch.no_grad():
        ep = torch.export.export(program, (sample,), dynamic_shapes=dynamic)
    inputs, outputs = program_specs(ep)
    meta = {"platforms": list(platforms), "batch": batch, "torch": torch.__version__,
            "inputs": inputs, "outputs": outputs}
    buf = io.BytesIO()
    torch.export.save(ep, buf, extra_files={META: json.dumps(meta)})
    data = buf.getvalue()
    tmp = str(out_path) + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, out_path)  # never a torn artifact
    if mlir_out:
        Path(mlir_out).write_text(str(ep))
    return ep, len(data)


class Artifact(NamedTuple):
    """A loaded serving artifact."""

    call: Callable          # (B, 34) f32 tensor on ``device`` -> (B, 51)
    program: object         # the ExportedProgram, on ``device``
    platforms: list[str]
    batch: int | None       # the pinned batch, or None (symbolic)
    inputs: list[str]


def _load(path):
    import links_tpu_torch.ops.resblock  # noqa: F401  registers links_tpu_torch::res_block_forward

    if not Path(path).is_file():
        raise FileNotFoundError(f"no serving artifact at {path} (write one with "
                                f"links_tpu_torch.cli.export_model)")
    extra = {META: ""}
    ep = torch.export.load(str(path), extra_files=extra)
    return ep, json.loads(extra[META]) if extra[META] else {}


def deserialize_exported(path, device="cpu") -> Artifact:
    """Load a serving artifact onto ``device`` (one read): the program, its
    callable (run without autograd) and its record. A device whose type the
    artifact's platforms do not name is refused, as a JAX artifact refuses a
    platform it was not lowered for."""
    import torch.export.passes  # not loaded by torch.export itself

    ep, meta = _load(path)
    device = torch.device(device)
    platforms = meta.get("platforms", [])
    if device.type not in platforms:
        raise ValueError(f"the artifact {path} was exported for platforms {platforms}, not "
                         f"{device.type}: export it with --platforms naming {device.type}")
    ep = torch.export.passes.move_to_device_pass(ep, device)
    module = ep.module()

    @torch.no_grad()
    def call(poses_2d: torch.Tensor) -> torch.Tensor:
        return module(poses_2d)

    return Artifact(call, ep, meta.get("platforms", []), meta.get("batch"),
                    program_specs(ep)[0])


def load_exported(path, device="cpu") -> Callable:
    """A serving artifact as a plain callable on ``device``: it takes a
    (B, 34) f32 tensor there (B as the artifact allows: any B >= 1 unless
    pinned) and returns the (B, 51) poses."""
    return deserialize_exported(path, device).call


def exported_info(path) -> dict:
    """An artifact's record without running it (``export_model --inspect``):
    the JAX package's keys, with the version of torch that wrote the file in
    place of the calling convention's."""
    ep, meta = _load(path)
    inputs, outputs = program_specs(ep)
    return {"path": str(path), "bytes": os.path.getsize(path),
            "platforms": meta.get("platforms", []), "inputs": inputs, "outputs": outputs,
            "torch_version": meta.get("torch", "")}
