"""Stage configurations of the port (counterpart of the optimizer and
stage-3 configurations in links_tpu/config.py; same defaults). The CLIs
override some defaults (cli/train_left_right_lifter.py). The JAX package's
``use_elevation`` is not carried over: no entry point turns it off, and the
port always draws the elevation from the predicted angles' statistics."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 2e-4
    weight_decay: float = 1e-5   # coupled L2, added to the gradient before Adam
    lr_gamma: float = 0.95       # per-epoch staircase decay
    clip_grad_norm: float = 0.0  # global-norm clip before Adam; 0 disables
    bf16_moments: bool = False   # Adam moments stored as bf16 at rest


@dataclasses.dataclass(frozen=True)
class LifterTrainConfig:
    """Stage 3 (the reference's train_left_right_lifter.py:42-57)."""

    batch_size: int = 256
    n_epochs: int = 100
    depth: float = 10.0  # --translation
    weight_bl: float = 50.0  # --bl
    weight_2d: float = 1.0  # --rep2d
    weight_3d: float = 1.0  # --rot3d
    weight_velocity: float = 1.0  # --velocity
    weight_likeli: float = 1.0  # --likelihood
    noise_factor: float = 0.2
    nll_cap: float = 0.0  # soft cap of the part-flow NLL (flows.soft_cap_nll); 0 disables
    optim: OptimConfig = OptimConfig()
    bf16: bool = True
