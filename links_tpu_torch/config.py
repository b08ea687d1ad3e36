"""Stage configurations of the port (counterpart of the optimizer, flow,
stage-3 and stage-4 configurations in links_tpu/config.py; same defaults).
The CLIs override some defaults (cli/_common.py:add_train_flags). The JAX package's
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
class FlowTrainConfig:
    """Stage 1, the full-pose flow (the reference's
    train_full_pose_norm_flow.py:31-36)."""

    num_keypoints: int = 34
    batch_size: int = 4 * 64
    n_epochs: int = 100
    noise_factor: float = 0.2
    nll_cap: float = 0.0  # soft cap of the per-sample NLLs (flows.soft_cap_nll); 0 disables
    optim: OptimConfig = OptimConfig()
    bf16: bool = True


@dataclasses.dataclass(frozen=True)
class PartFlowTrainConfig:
    """Stage 2, the four part flows (the reference's
    train_leg_torso_left_right_norm_flow.py:37-44)."""

    side_keypoints: int = 22
    leg_keypoints: int = 14
    torso_keypoints: int = 20
    batch_size: int = 256
    n_epochs: int = 100
    noise_factor: float = 0.2
    nll_cap: float = 0.0  # as FlowTrainConfig.nll_cap
    optim: OptimConfig = OptimConfig()
    bf16: bool = True


@dataclasses.dataclass(frozen=True)
class LifterTrainConfig:
    """Stages 3a and 3b (the reference's train_left_right_lifter.py:42-57;
    identical in train_leg_torso_lifter.py:44-58)."""

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


@dataclasses.dataclass(frozen=True)
class OcclusionTrainConfig:
    """Stage 4, the eight completers (the reference's
    train_occlusion_models.py:51-63)."""

    batch_size: int = 256
    n_epochs: int = 10
    depth: float = 10.0  # --translation
    # extra cumulative random y-rotations of the pseudo-3D per step (the
    # reference's 2) and the Gaussian jitter of the completers' inputs only
    # (the reference has none)
    n_rot: int = 2
    input_noise: float = 0.0
    optim: OptimConfig = OptimConfig()
    bf16: bool = True
