"""The CUDA kernels of links_tpu_torch on the card, each against its plain
PyTorch version. Every test here is marked ``cuda`` and skips without a CUDA
device. The file imports neither jax nor links_tpu, so it also runs on a
machine without jax, where tests/conftest.py (which imports jax) is skipped:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from links_tpu_torch.models.lifters import Lifter, StackedLifter
from links_tpu_torch.ops import fused_infer as K2

# Kernel vs plain version: both sum bf16 x bf16 products in f32 in different
# orders, and a last-bit difference can flip the bf16 rounding of the next
# layer's input (the tolerance of chip_smoke.py).
TOL = {"rtol": 1e-3, "atol": 1e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _stacked(hidden, g, device):
    return StackedLifter(Lifter(11, hidden, generator=g),
                         Lifter(11, hidden, generator=g)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [128, 1024])
def test_fused_sides_kernel_matches_plain_version(cuda, hidden):
    g = torch.Generator().manual_seed(0)
    prep = K2.prepare_fused_weights(_stacked(hidden, g, cuda))
    for batch in (1, 37, 65, 512):
        x = (torch.randn(2, batch, 22, generator=g) * 0.1).to(cuda)
        before = K2.fused_sides_forward.launches
        with torch.no_grad():
            got = K2.fused_sides_forward(prep, x[0], x[1])
            torch.cuda.synchronize()
            want = K2.fused_sides_forward_reference(prep, x[0], x[1])
        assert K2.fused_sides_forward.launches == before + 1
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **TOL)


@pytest.mark.cuda
def test_fused_sides_kernel_is_deterministic(cuda):
    """The split-K partial sums are added in split order, not in the order
    the blocks finish."""
    g = torch.Generator().manual_seed(1)
    prep = K2.prepare_fused_weights(_stacked(1024, g, cuda))
    x = (torch.randn(2, 16, 22, generator=g) * 0.1).to(cuda)
    with torch.no_grad():
        first = K2.fused_sides_forward(prep, x[0], x[1])
        second = K2.fused_sides_forward(prep, x[0], x[1])
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_sides_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    g = torch.Generator().manual_seed(2)
    prep = K2.prepare_fused_weights(_stacked(128, g, cuda))
    x = torch.zeros(4, 22, device=cuda)
    with pytest.raises(ValueError, match="latency path"):
        K2.fused_sides_forward(prep, torch.zeros(513, 22, device=cuda),
                               torch.zeros(513, 22, device=cuda))
    with pytest.raises(ValueError, match="w_chain"):
        K2.fused_sides_forward({**prep, "w_chain": prep["w_chain"].float()}, x, x)
    with pytest.raises(ValueError, match="b_up"):
        K2.fused_sides_forward({**prep, "b_up": prep["b_up"].cpu()}, x, x)
