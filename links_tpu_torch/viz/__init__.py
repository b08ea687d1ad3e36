"""Skeleton, prediction and flow-sample rendering (counterpart of
links_tpu/viz). matplotlib is imported only when something is drawn."""

from links_tpu_torch.viz.latent import flow_samples_data, visualise_flow_samples  # noqa: F401
from links_tpu_torch.viz.prediction import (  # noqa: F401
    occlusion_data,
    occlusion_sequence_data,
    prediction_data,
    sequence_data,
    visualise_occlusion,
    visualise_prediction,
)
from links_tpu_torch.viz.skeletons import (  # noqa: F401
    compare_poses_3d,
    expand_to_32_slots,
    plot_skeleton_2d,
    plot_skeleton_3d,
    plot_skeleton_3d_32slot,
    render_comparison_video,
    render_multi_video,
)
