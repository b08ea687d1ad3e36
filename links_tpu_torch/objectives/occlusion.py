"""The occlusion-completion objective of stage 4 and the scenario lifts
(counterpart of links_tpu/objectives/occlusion.py).

The frozen legs and torso lifters make root-centered pseudo-3D poses from
the 2D batch; each of the eight completers infills a hidden part from the
complementary joints. The loss is the squared error summed over a part's
coordinates, meaned over the batch, over three orientations: the pose and
two cumulative random y-rotations of it. The orientations are concatenated
into one ((n_rot + 1) B) batch and every completer runs once on it; since
the orientation groups are equal-sized, (n_rot + 1) times the mean over the
concatenation is the sum of the per-orientation means. The completers run
one after the other (the JAX package vmaps same-shaped groups: the same
function).

The random draws are tensors the caller gives: ``u_rot`` (n_rot, B, 1)
uniforms on [0, 1) for the rotations and ``eps_input`` ((n_rot + 1) B, 3,
17) standard normals for the input noise, so the tests hand both packages
the same numbers.
"""

from __future__ import annotations

import torch

from links_tpu_torch.core.geometry import PI, rotation_about_y
from links_tpu_torch.core.nn import F32, Policy
from links_tpu_torch.core.skeleton import (
    NUM_JOINTS,
    combine_left_right_occluded_3d,
    combine_pose_and_limb,
    split_data_left_right,
    split_data_left_right_3d,
    split_data_legs_torso,
)
from links_tpu_torch.models.lifters import StackedLifter
from links_tpu_torch.objectives.lifter import (
    globalize,
    lift_left_right_eval,
    pin_root,
    reconstruct_3d,
)

# the completer that infills each scenario's hidden part
SCENARIO_COMPLETER = {"la": "left_arm", "ra": "right_arm", "ll": "left_leg", "rl": "right_leg",
                      "torso": "torso", "legs": "both_legs", "left": "left_side",
                      "right": "right_side"}

# Joints zeroed per dropout scenario (keys as SCENARIO_COMPLETER's). Limb
# scenarios use the reference's occlusion_create keypoint sets at full
# count; the side, legs and torso scenarios drop the whole part.
DROPOUT_SCENARIO_JOINTS = {
    "ll": (4, 5, 6),
    "rl": (1, 2, 3),
    "la": (11, 12, 13),
    "ra": (14, 15, 16),
    "legs": (1, 2, 3, 4, 5, 6),
    "torso": (7, 8, 9, 10, 11, 12, 13, 14, 15, 16),
    "left": (4, 5, 6, 11, 12, 13),
    "right": (1, 2, 3, 14, 15, 16),
}


def pseudo_3d_from_lifters(legs, torso, poses_2d: torch.Tensor, depth: float = 10.0,
                           policy: Policy = F32) -> torch.Tensor:
    """The legs and torso ``Lifter``s on (B, 34) 2D -> root-centered
    pseudo-3D (B, 3, 17) (no depth clamp here)."""
    legs_split, torso_split = split_data_legs_torso(poses_2d)
    legs_pred, _ = legs(legs_split, policy)
    torso_pred, _ = torso(torso_split, policy)
    return reconstruct_3d(poses_2d, pin_root(torch.cat([legs_pred, torso_pred], dim=1)) + depth)


def _flat(p: torch.Tensor, *parts) -> torch.Tensor:
    """The joint ranges ``parts`` of (..., 3, 17) poses, concatenated on the
    joint axis and flattened to (..., 3 J)."""
    cat = torch.cat([p[..., :, a:b] for a, b in parts], dim=-1)
    return cat.reshape(*p.shape[:-2], -1)


def part_targets(pose_3d: torch.Tensor) -> dict[str, torch.Tensor]:
    """The 8 completers' regression targets from (..., 3, 17) poses."""
    p = pose_3d
    return {
        "left_arm": _flat(p, (11, 14)),
        "right_arm": _flat(p, (14, 17)),
        "left_leg": _flat(p, (4, 7)),
        "right_leg": _flat(p, (1, 4)),
        "left_side": _flat(p, (4, 7), (11, 14)),
        "right_side": _flat(p, (1, 4), (14, 17)),
        "both_legs": _flat(p, (1, 7)),
        "torso": _flat(p, (7, 17)),
    }


def part_inputs(pose_3d: torch.Tensor) -> dict[str, torch.Tensor]:
    """The 8 completers' complementary inputs from (..., 3, 17) poses."""
    p = pose_3d
    lead = p.shape[:-2]
    no_right_side, no_left_side = split_data_left_right_3d(p)
    return {
        "left_arm": _flat(p, (0, 11), (14, 17)),
        "right_arm": _flat(p, (0, 14)),
        "left_leg": _flat(p, (0, 4), (7, 17)),
        "right_leg": _flat(p, (0, 1), (4, 17)),
        "torso": _flat(p, (0, 7)),
        "both_legs": _flat(p, (0, 1), (7, 17)),
        # the left-side completer sees the pose without its left side (the
        # right split), and the other way round
        "left_side": no_left_side.reshape(*lead, 33),
        "right_side": no_right_side.reshape(*lead, 33),
    }


def completer_losses(completers, pose_3d: torch.Tensor, policy: Policy = F32,
                     input_pose_3d: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """Each completer's squared error, summed over the part's coordinates and
    meaned over the batch, on (B, 3, 17) poses. ``input_pose_3d`` (default:
    ``pose_3d``) is what the completers see; the targets come from
    ``pose_3d``. ``completers``: a ``Completers``."""
    inputs = part_inputs(pose_3d if input_pose_3d is None else input_pose_3d)
    targets = part_targets(pose_3d)
    return {name: ((completer(inputs[name], policy) - targets[name]) ** 2).sum(dim=1).mean()
            for name, completer in completers.items()}


def occlusion_loss(completers, pose_3d: torch.Tensor, u_rot: torch.Tensor,
                   eps_input: torch.Tensor | None = None, policy: Policy = F32,
                   input_noise: float = 0.0):
    """The stage-4 loss of (B, 3, 17) pseudo-3D poses over the identity and
    ``n_rot = len(u_rot)`` cumulative random y-rotations (azimuth (u - 0.5)
    1.99 pi; the rotations in f32). With ``input_noise``, the completers see
    the poses plus ``input_noise * eps_input``; the targets stay clean.
    -> (loss, aux) with the JAX package's ``threed_loss_*`` keys."""
    poses = [pose_3d]
    for u in u_rot:
        poses.append(rotation_about_y((u - 0.5) * 1.99 * PI) @ poses[-1])
    cat = torch.cat(poses, dim=0)
    inp = cat + input_noise * eps_input if input_noise else cat
    scale = float(len(u_rot) + 1)
    aux = {f"threed_loss_{name}": scale * v
           for name, v in completer_losses(completers, cat, policy, inp).items()}
    loss = sum(aux.values())
    aux["loss"] = loss
    return loss, aux


def _to_3d(split_2d: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """(B, 2 J) 2D part and its (B, J) depths -> (B, 3, J) camera-frame part."""
    s = split_2d.reshape(-1, 2, depth.shape[1])
    return torch.cat([s * depth[:, None, :], depth[:, None, :]], dim=1)


def occlusion_validation_poses(completers, lifters: dict, test_2d: torch.Tensor,
                               depth: float = 10.0, policy: Policy = F32,
                               scenarios=None) -> dict[str, torch.Tensor]:
    """The reference's validation scenarios: partial 3D poses built from
    different lifters (the side lifters give the side poses, the legs and
    torso lifters the part poses), each scenario's completer infills its
    part, and the merged poses go back to the camera frame.

    ``lifters``: the ``{'left', 'right', 'legs', 'torso'}`` ``Lifter``s;
    ``completers``: a ``Completers``. -> {scenario: (B, 51)} for the 8
    scenarios of ``SCENARIO_COMPLETER``, or the ``scenarios`` asked for (only
    their completers run; all four lifters do)."""
    left_split, right_split = split_data_left_right(test_2d)
    legs_split, torso_split = split_data_legs_torso(test_2d)
    legs_pred, _ = lifters["legs"](legs_split, policy)
    torso_pred, _ = lifters["torso"](torso_split, policy)
    left_pred, _ = lifters["left"](left_split, policy)
    right_pred, _ = lifters["right"](right_split, policy)

    pred_lt = pin_root(torch.cat([legs_pred, torso_pred], dim=1)) + depth
    p_legs = _to_3d(legs_split, pred_lt[:, :7])
    p_torso = _to_3d(torso_split, pred_lt[:, 7:])
    p_left = _to_3d(left_split, pin_root(left_pred) + depth)
    p_right = _to_3d(right_split, pin_root(right_pred) + depth)
    # root-centering: the torso takes the legs' root (it has none of its own)
    p_torso = p_torso - p_legs[:, :, 0:1]
    p_legs = p_legs - p_legs[:, :, 0:1]
    p_left = p_left - p_left[:, :, 0:1]
    p_right = p_right - p_right[:, :, 0:1]

    n = test_2d.shape[0]
    inputs = {
        "la": torch.cat([p_legs, p_right[:, :, 4:]], dim=2).reshape(n, 42),
        "ra": torch.cat([p_legs, p_left[:, :, 4:]], dim=2).reshape(n, 42),
        "ll": torch.cat([p_right[:, :, :4], p_torso], dim=2).reshape(n, 42),
        "rl": torch.cat([p_left[:, :, :4], p_torso], dim=2).reshape(n, 42),
        "torso": p_legs.reshape(n, 21),
        "legs": torch.cat([p_legs[:, :, 0:1], p_torso], dim=2).reshape(n, 33),
        "left": p_right.reshape(n, 33),  # the pose without its left side
        "right": p_left.reshape(n, 33),
    }

    def full(name: str, pred: torch.Tensor) -> torch.Tensor:
        inp = inputs[name]
        if name in ("la", "ra", "ll", "rl"):
            return combine_pose_and_limb(inp, pred, name)
        if name == "torso":
            return torch.cat([inp.reshape(n, 3, 7), pred.reshape(n, 3, 10)], dim=2).reshape(n, 51)
        if name == "legs":
            inp = inp.reshape(n, 3, 11)
            return torch.cat([inp[:, :, :1], pred.reshape(n, 3, 6), inp[:, :, 1:]],
                             dim=2).reshape(n, 51)
        return combine_left_right_occluded_3d(pred, inp, name).reshape(n, 51)

    names = tuple(scenarios) if scenarios is not None else tuple(SCENARIO_COMPLETER)
    return {name: globalize(full(name, completers[SCENARIO_COMPLETER[name]](inputs[name],
                                                                              policy)), depth)
            for name in names}


def drop_keypoints(poses_2d: torch.Tensor, joints) -> torch.Tensor:
    """Zero the given joints of (B, 34) 2D poses (the full-limb variant of
    the reference's occlusion_create, for the scenario lifts)."""
    mask = torch.ones(NUM_JOINTS, dtype=poses_2d.dtype, device=poses_2d.device)
    mask[list(joints)] = 0.0
    return (poses_2d.reshape(-1, 2, NUM_JOINTS) * mask).reshape(-1, 34)


def dropout_eval_poses(completers, lifters: dict, test_2d: torch.Tensor, depth: float = 10.0,
                       policy: Policy = F32, choice: str = "right",
                       scenarios=None) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """Lifting under simulated 2D keypoint dropout: for each scenario of
    ``DROPOUT_SCENARIO_JOINTS`` (or each of ``scenarios``) its keypoints are
    zeroed, the partial pose is lifted by the lifters that do not read them
    and the scenario's completer infills the missing 3D part
    (``occlusion_validation_poses``). -> {scenario: (recovered (B, 51),
    naive (B, 51))}, ``naive`` being the plain left/right lift of the same
    corrupted 2D (shared joints from ``choice``): the no-completion
    baseline. A scenario's values do not depend on which others run."""
    stacked = StackedLifter(lifters["left"], lifters["right"])
    names = tuple(scenarios) if scenarios is not None else tuple(DROPOUT_SCENARIO_JOINTS)
    out = {}
    for name in names:
        occluded = drop_keypoints(test_2d, DROPOUT_SCENARIO_JOINTS[name])
        recovered = occlusion_validation_poses(completers, lifters, occluded, depth, policy,
                                               scenarios=(name,))[name]
        out[name] = (recovered, lift_left_right_eval(stacked, occluded, depth, choice, policy))
    return out
