"""Host-side matplotlib skeleton rendering (counterpart of
links_tpu/viz/skeletons.py).

``plot_skeleton_3d`` and ``plot_skeleton_2d`` draw the 16-edge bone map over
the 17 joints, right-side bones in their own colour. ``plot_skeleton_3d_32slot``
draws the reference's way: the 17 joints scattered into the 32-slot H36M
buffer (``expand_to_32_slots``) and its kinematic tree walked with the axis
order (x, z, -y), viewed at azim -45 / elev 15. Clips are written with
ffmpeg when it is on the PATH, otherwise with pillow.

matplotlib is imported inside the plotting functions only (``_require_plt``):
the constants and ``expand_to_32_slots`` need numpy alone.
"""

from __future__ import annotations

import shutil

import numpy as np

from links_tpu_torch.core.skeleton import BONE_MAP_ALL

# Right-side bones drawn in a distinct colour (right leg 0-2, right arm 13-15).
_RIGHT_BONES = {0, 1, 2, 13, 14, 15}
RIGHT_COLOR = "#d62728"
LEFT_COLOR = "#1f77b4"

# The 32-slot H36M buffer: the slot of each of the 17 joints, and the
# kinematic tree's edges in slot space.
H36M_32SLOT_INDICES = (0, 1, 2, 3, 6, 7, 8, 12, 13, 14, 15, 17, 18, 19, 25, 26, 27)
H36M_32SLOT_KIN_TREE = np.array(
    [[0, 12], [12, 13], [13, 14], [15, 14], [13, 17], [17, 18], [18, 19],
     [13, 25], [25, 26], [26, 27], [0, 1], [1, 2], [2, 3], [0, 6], [6, 7],
     [7, 8]])


def _require_plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_skeleton_3d(pose_3d, ax=None, title=None, color_by_side=True):
    """(3, 17) or (51,) pose -> 3D skeleton axes, plotted as (x, z, -y)."""
    plt = _require_plt()
    p = np.asarray(pose_3d).reshape(3, 17)
    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(111, projection="3d")
    for i, (a, b) in enumerate(BONE_MAP_ALL):
        c = RIGHT_COLOR if (color_by_side and i in _RIGHT_BONES) else LEFT_COLOR
        ax.plot([p[0, a], p[0, b]], [p[2, a], p[2, b]], [-p[1, a], -p[1, b]], c=c)
    ax.scatter(p[0], p[2], -p[1], s=8, c="k")
    ax.set_box_aspect((1, 1, 1))
    _equal_3d(ax, p[0], p[2], -p[1])
    if title:
        ax.set_title(title)
    return ax


def plot_skeleton_2d(pose_2d, ax=None, title=None, color_by_side=True, invert_y=True):
    """(2, 17) or (34,) pose -> 2D skeleton axes."""
    plt = _require_plt()
    p = np.asarray(pose_2d).reshape(2, 17)
    if ax is None:
        _, ax = plt.subplots()
    for i, (a, b) in enumerate(BONE_MAP_ALL):
        c = RIGHT_COLOR if (color_by_side and i in _RIGHT_BONES) else LEFT_COLOR
        ax.plot([p[0, a], p[0, b]], [p[1, a], p[1, b]], c=c)
    ax.scatter(p[0], p[1], s=8, c="k")
    ax.set_aspect("equal")
    if invert_y:
        ax.invert_yaxis()
    if title:
        ax.set_title(title)
    return ax


def expand_to_32_slots(pose):
    """(3, 17)/(51,) (or (2, 17)/(34,)) pose -> (C, 32) H36M buffer with the
    17 joints at their slots; the other slots stay zero."""
    p = np.asarray(pose)
    c = 3 if p.size % 3 == 0 and p.size != 34 else 2
    p = p.reshape(c, 17)
    buff = np.zeros((c, 32), p.dtype)
    buff[:, list(H36M_32SLOT_INDICES)] = p
    return buff


def plot_skeleton_3d_32slot(pose_3d, ax=None, title=None):
    """3D skeleton drawn the reference's way: 32-slot buffer, kinematic
    tree, axis order (x, z, -y) (the vertical axis is the negated y), view
    azim -45 / elev 15."""
    plt = _require_plt()
    buff = expand_to_32_slots(np.asarray(pose_3d).reshape(3, 17))
    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(111, projection="3d")
        ax.view_init(azim=-45, elev=15)
    x, y, z = buff[0], buff[2], -buff[1]
    for a, b in H36M_32SLOT_KIN_TREE:
        ax.plot([x[a], x[b]], [y[a], y[b]], [z[a], z[b]], c=LEFT_COLOR)
    used = list(H36M_32SLOT_INDICES)
    ax.scatter(x[used], y[used], z[used], s=8, c="k")
    ax.set_box_aspect((1, 1, 1))
    _equal_3d(ax, x[used], y[used], z[used])
    if title:
        ax.set_title(title)
    return ax


def _equal_3d(ax, x, y, z):
    r = max(np.ptp(x), np.ptp(y), np.ptp(z)) / 2
    mx, my, mz = x.mean(), y.mean(), z.mean()
    ax.set_xlim(mx - r, mx + r)
    ax.set_ylim(my - r, my + r)
    ax.set_zlim(mz - r, mz + r)


def compare_poses_3d(poses, titles=None, out_path=None):
    """Side-by-side 3D renders (e.g. GT vs prediction vs completed)."""
    plt = _require_plt()
    n = len(poses)
    fig = plt.figure(figsize=(4 * n, 4))
    for i, pose in enumerate(poses):
        ax = fig.add_subplot(1, n, i + 1, projection="3d")
        plot_skeleton_3d(pose, ax=ax, title=titles[i] if titles else None)
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def render_comparison_video(gt_seq, pred_seq, out_path, fps: int = 25):
    """GT-vs-prediction clip; gt_seq, pred_seq: (T, 3, 17)."""
    return render_multi_video([gt_seq, pred_seq], ["ground truth", "prediction"], out_path, fps)


def render_multi_video(seqs, titles, out_path, fps: int = 25):
    """N-panel skeleton clip, e.g. the occlusion layout (GT | naive lift of
    the occluded 2D | completer-recovered). Each seq: (T, 3, 17), equal
    lengths."""
    plt = _require_plt()
    from matplotlib import animation

    n = len(seqs)
    fig = plt.figure(figsize=(4 * n, 4))
    axes = [fig.add_subplot(1, n, i + 1, projection="3d") for i in range(n)]

    def draw(t):
        for ax, seq, title in zip(axes, seqs, titles):
            ax.cla()
            plot_skeleton_3d(seq[t], ax=ax, title=title)

    anim = animation.FuncAnimation(fig, draw, frames=len(seqs[0]))
    anim.save(out_path, fps=fps, writer="ffmpeg" if _has_ffmpeg() else "pillow")
    plt.close(fig)
    return out_path


def _has_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None
