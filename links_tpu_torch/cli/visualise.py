"""Render skeletons, predictions and flow samples (counterpart of
links_tpu/cli/visualise.py).

``--what``:
  * ``gt3d``: a test frame's 3D ground truth (``--style bones``: the 16-edge
    bone map, side-coloured; ``32slot``: the reference's 32-slot buffer,
    kinematic tree, axis order and view);
  * ``gt2d``: its 2D keypoints;
  * ``prediction``: GT vs the left/right lift, aligned; prints the frame's
    PA-MPJPE;
  * ``occlusion``: GT vs the pose completed under ``--scenario`` (default
    left);
  * ``video``: a GT-vs-prediction clip of ``--frames`` frames from
    ``--frame``; with ``--scenario``, three panels: GT | naive lift of the
    occluded 2D | completer-recovered;
  * ``samples``: real test poses above samples of ``--flow`` (the full flow,
    or a part flow, whose split of the test poses is chosen from its name),
    drawn from a ``torch.Generator`` seeded with ``--seed``.

The lifts run on ``--device`` (the residual-block kernel on the card) in
f32; drawing is on the host. Needs matplotlib: without it the command
exits 2 naming it, before reading any data.

Usage:
    python -m links_tpu_torch.cli.visualise --data data/h36m_data.pkl --frame 0 \\
        --what prediction --out pred.png
"""

from __future__ import annotations

import argparse
import sys

import torch

from links_tpu_torch.cli import _common as C
from links_tpu_torch.objectives.occlusion import DROPOUT_SCENARIO_JOINTS


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Render skeletons / predictions")
    parser.add_argument("--what", default="prediction",
                        choices=["gt3d", "gt2d", "prediction", "occlusion", "samples", "video"])
    parser.add_argument("--frame", type=int, default=0)
    parser.add_argument("--frames", type=int, default=50,
                        help="sequence length for --what video (starting at --frame)")
    parser.add_argument("--fps", type=int, default=25)
    parser.add_argument("--scenario", default=None, choices=list(DROPOUT_SCENARIO_JOINTS),
                        help="occlusion scenario (--what occlusion default: left). With "
                             "--what video: the 3-panel occlusion clip, GT | naive lift of "
                             "the occluded 2D | completer-recovered")
    parser.add_argument("--flow", default=C.FULL_FLOW, help="flow artifact for --what samples")
    parser.add_argument("--style", choices=["bones", "32slot"], default="bones",
                        help="--what gt3d rendering: 'bones' = the 16-edge bone map "
                             "(side-coloured); '32slot' = the reference's 32-slot H36M "
                             "buffer and kinematic tree with its axis order and view")
    parser.add_argument("--depth", type=float, default=10.0)
    parser.add_argument("--choice", choices=["left", "right"], default="right",
                        help="which side's lifter supplies the shared root/torso columns "
                             "of the video clips (as eval_h36m's --choice)")
    parser.add_argument("--out", default=None, help="output image path")
    C.add_common_flags(parser)
    C.add_lr_pt_flags(parser)
    C.add_use_best_flag(parser)
    C.add_device_flag(parser)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("links_tpu_torch.cli.visualise: drawing needs the matplotlib package, which "
              "is not installed", file=sys.stderr)
        raise SystemExit(2)
    from links_tpu_torch import viz

    device = C.resolve_device(args.device)
    test = C.load_test(args)
    test2d, test3d = test.poses_2d, test.poses_3d
    if not 0 <= args.frame < test2d.shape[0]:
        raise SystemExit(f"--frame {args.frame} out of range (test set has "
                         f"{test2d.shape[0]} poses)")
    out = args.out or f"{args.what}_{args.frame}.{'gif' if args.what == 'video' else 'png'}"

    if args.what == "gt3d":
        if args.style == "32slot":
            _save_axes(viz.plot_skeleton_3d_32slot(test3d[args.frame].numpy(),
                                                   title="ground truth"), out)
        else:
            viz.compare_poses_3d([test3d[args.frame].numpy()], ["ground truth"], out_path=out)
    elif args.what == "gt2d":
        _save_axes(viz.plot_skeleton_2d(test2d[args.frame].numpy(), title="ground truth 2D"),
                   out)
    elif args.what == "prediction":
        _, err = viz.visualise_prediction(C.load_stacked_lr(args, device), test2d, test3d,
                                          args.frame, args.depth, out_path=out)
        print(f"frame {args.frame}: PA-MPJPE {err:.2f}mm")
    elif args.what == "occlusion":
        scenario = args.scenario or "left"
        _, err = viz.visualise_occlusion(C.load_completers(args, device),
                                         C.load_all_lifters(args, device), test2d, test3d,
                                         args.frame, scenario, args.depth, out_path=out)
        print(f"frame {args.frame} scenario {scenario}: PA {err:.2f}mm")
    elif args.what == "video":
        if args.frames < 1:
            raise SystemExit(f"--frames must be >= 1 (got {args.frames})")
        clip = slice(args.frame, min(args.frame + args.frames, test2d.shape[0]))
        if args.scenario:
            gt, naive, rec = viz.occlusion_sequence_data(
                C.load_completers(args, device), C.load_all_lifters(args, device),
                test2d[clip], test3d[clip], args.scenario, args.depth, args.choice)
            viz.render_multi_video([gt, naive, rec],
                                   ["ground truth", f"naive lift ({args.scenario} occluded)",
                                    "occlusion-recovered"], out, fps=args.fps)
        else:
            gt, aligned = viz.sequence_data(C.load_stacked_lr(args, device), test2d[clip],
                                            test3d[clip], args.depth, args.choice)
            viz.render_comparison_video(gt, aligned, out, fps=args.fps)
    elif args.what == "samples":
        flow = C.load_flow(args, args.flow, device)
        poses = _flow_inputs(args.flow, flow.dim, test2d)
        eps = torch.randn(8, flow.dim, generator=torch.Generator().manual_seed(args.seed))
        viz.visualise_flow_samples(flow, poses, eps, out_path=out)
    print(f"wrote {out}")


def _save_axes(ax, out):
    import matplotlib.pyplot as plt

    ax.figure.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(ax.figure)


def _flow_inputs(name: str, dim: int, test2d: torch.Tensor) -> torch.Tensor:
    """The test poses a flow of ``dim`` inputs reads: the whole poses, or
    the part split named in the flow's name (left, right, legs, torso)."""
    if dim == test2d.shape[-1]:
        return test2d
    from links_tpu_torch.core.skeleton import split_data_left_right, split_data_legs_torso

    left, right = split_data_left_right(test2d)
    legs, torso = split_data_legs_torso(test2d)
    by_name = {"left": left, "right": right, "legs": legs, "torso": torso}
    part = next((p for p in by_name if p in name), None)
    if part is None or by_name[part].shape[-1] != dim:
        raise SystemExit(f"--flow {name} expects {dim}-dim inputs; cannot infer the "
                         f"matching pose split from the name")
    return by_name[part]


if __name__ == "__main__":
    main()
