"""Occlusion-completion MLPs of stage 4 (counterpart of
links_tpu/models/completers.py).

Each completer infills a hidden part of a 3D pose from the other joints:

    upscale:  Linear(3 in_joints -> H)
    blocks:   3 x LeakyReLU(res_block)        (the residual-block kernel on the card)
    downscale: Linear(H -> 3 out_joints)

with (in_joints, out_joints) (14, 3) for the four limb predictors, (11, 6)
for both legs and for each side, (7, 10) for the torso. Module names are the
reference's state-dict keys (ckpt/torch_io.py adds the reference's unused
``res_common`` block on save and ignores it on load; a block's LayerNorm
tensors are written at their defaults when it has none, and read only into
a ``use_layernorm`` completer).

The JAX package runs same-shaped completers as vmapped groups; here the
eight run one after the other, which is the same function.
"""

from __future__ import annotations

import torch
from torch import nn

from links_tpu_torch.core.nn import F32, Linear, Policy, leaky_relu
from links_tpu_torch.models.lifters import HIDDEN, ResBlock

# (in_joints, out_joints) per completer, in the reference's training-step
# order, which fixes ``Completers.parameters()``'s
COMPLETER_SPECS = {
    "left_leg": (14, 3),
    "right_leg": (14, 3),
    "left_arm": (14, 3),
    "right_arm": (14, 3),
    "both_legs": (11, 6),
    "torso": (7, 10),
    "left_side": (11, 6),
    "right_side": (11, 6),
}
BLOCKS = ("res_pose1", "res_pose2", "res_pose3")


class Completer(nn.Module):
    """(B, 3 in_joints) partial 3D pose -> (B, 3 out_joints) infilled part."""

    def __init__(self, in_joints: int, out_joints: int, hidden: int = HIDDEN, *,
                 use_layernorm: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        self.upscale = Linear(3 * in_joints, hidden, generator=generator)
        for name in BLOCKS:
            setattr(self, name, ResBlock(hidden, use_layernorm=use_layernorm, generator=generator))
        self.downscale = Linear(hidden, 3 * out_joints, generator=generator)

    def forward(self, x: torch.Tensor, policy: Policy = F32) -> torch.Tensor:
        h = self.upscale(x, policy)
        for name in BLOCKS:
            h = leaky_relu(getattr(self, name)(h, policy))
        return self.downscale(h, policy)


class Completers(nn.ModuleDict):
    """The eight completers keyed by name, in ``COMPLETER_SPECS`` order.
    Built on the CPU from ``generator``."""

    def __init__(self, hidden: int = HIDDEN, *, use_layernorm: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__({name: Completer(*spec, hidden, use_layernorm=use_layernorm,
                                          generator=generator)
                          for name, spec in COMPLETER_SPECS.items()})
