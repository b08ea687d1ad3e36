"""Flow-sample visualiser (counterpart of links_tpu/viz/latent.py): draw
generative samples from a trained flow next to the real 2D poses they
perturb. The standard-normal draw is a tensor the caller gives."""

from __future__ import annotations

import numpy as np
import torch

from links_tpu_torch import flows
from links_tpu_torch.viz.skeletons import _require_plt, plot_skeleton_2d


@torch.no_grad()
def flow_samples_data(flow: flows.Flow, poses_2d: torch.Tensor, eps: torch.Tensor,
                      noise_factor: float = 0.2):
    """The first ``len(eps)`` poses and their perturbed-latent resamples
    (``flows.draw_samples`` with ``eps`` (n, D); the root pinned for the
    34-d full-pose flow only) -> (real (n, D), sampled (n, D))."""
    dev = next(flow.parameters()).device
    real = poses_2d[:eps.shape[0]].to(dev)
    samples = flows.draw_samples(flow, real, eps.to(dev), noise_factor,
                                 zero_root=flow.dim == 34)
    return real.cpu().numpy(), samples.cpu().numpy()


def visualise_flow_samples(flow: flows.Flow, poses_2d, eps: torch.Tensor, n: int = 8,
                           noise_factor: float = 0.2, out_path=None):
    """Grid: top row ``n`` real poses, bottom row their perturbed-latent
    resamples; ``eps``: the (n, D) standard-normal draw."""
    if tuple(eps.shape) != (n, flow.dim):
        raise ValueError(f"eps must be ({n}, {flow.dim}), got {tuple(eps.shape)}")
    plt = _require_plt()
    real, samples = flow_samples_data(flow, poses_2d, eps, noise_factor)
    fig, axes = plt.subplots(2, n, figsize=(2.2 * n, 5))
    for i in range(n):
        _plot_any(axes[0, i], real[i], "real" if i == 0 else None)
        _plot_any(axes[1, i], samples[i], "sampled" if i == 0 else None)
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def _plot_any(ax, flat: np.ndarray, title):
    if flat.shape[-1] == 34:
        plot_skeleton_2d(flat, ax=ax, title=title)
    else:  # a part pose: scatter its keypoints
        nj = flat.shape[-1] // 2
        p = flat.reshape(2, nj)
        ax.scatter(p[0], p[1], s=10)
        ax.set_aspect("equal")
        ax.invert_yaxis()
        if title:
            ax.set_title(title)
