"""Normalizing flows (counterpart of links_tpu/flows)."""

from links_tpu_torch.flows.coupling import Flow  # noqa: F401
from links_tpu_torch.flows.sequence import (  # noqa: F401
    draw_samples,
    forward,
    inverse,
    nll,
    nll_mean,
    soft_cap_nll,
)
