"""The DSTformer's glue (ops/dst_glue.py) on the CPU, where each entry point
takes its plain version: each plain version against the op sequence it
replaced in models/dstformer.py (a bias add, a residual add, F.layer_norm,
the cast that mm_bf16 makes, the qkv bias add through a permuted view, the
exact GELU in place), bit for bit under f32 and bf16 outputs; a whole forward at a
small size (dim 64, MLP 128, depth 2, 4 heads, two windows of 27 frames, one
a padded tail) against the forward built from that op sequence; the glue
calls a forward makes, by kind; and the checks of the entry points. The
kernels themselves are held to these plain versions on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_suite import one_cpu_thread  # noqa: F401  (an autouse fixture)
import dstformer_reference as R
from links_tpu_torch.core.nn import BF16, F32
from links_tpu_torch.models import dstformer
from links_tpu_torch.ops import dst_glue as G

WINDOW, HEADS, C, HIDDEN, M = 27, 4, 64, 128, 300
DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["f32", "bf16"]


def _randn(*shape, seed):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def _as_operand(t, dtype):
    """What the product after a glue pass read of ``t`` before it: mm_bf16
    cast an f32 operand to bf16 itself; under f32 the product read it."""
    return t.to(torch.bfloat16) if dtype == torch.bfloat16 else t


def _ln(x, gamma, beta):  # models/dstformer.py:_ln
    return F.layer_norm(x, (x.shape[-1],), gamma, beta, dstformer.LN_EPS)


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("mode", ["layernorm", "residual_layernorm", "residual"])
def test_residual_layernorm_is_the_op_sequence_it_replaced(mode, dtype):
    """LayerNorm only (a stream's first, of z), a residual add with the next
    LayerNorm, and the last residual add alone: s and h bit for bit what the
    bias add of _linear, the residual add and _ln followed by mm_bf16's cast
    made, and z left as it is."""
    z, u = _randn(M, C, seed=1), _randn(M, C, seed=2)
    bias, gamma, beta = _randn(C, seed=3), 1 + 0.1 * _randn(C, seed=4), _randn(C, seed=5)
    z0 = z.clone()
    residual, norm = mode != "layernorm", mode != "residual"
    want_s = z + u.clone().add_(bias) if residual else z
    got_s, got_h = G.residual_layernorm(z, *((u, bias) if residual else (None, None)),
                                        *((gamma, beta) if norm else (None, None)), dtype=dtype)
    _equal(got_s, want_s)
    if norm:
        _equal(got_h, _as_operand(_ln(want_s, gamma, beta), dtype))
    else:
        assert got_h is None
    _equal(z, z0)
    # the running residual, added to in place, as the later sub-steps did
    out = z.clone()
    out.add_(u.clone().add_(bias))
    _equal(G.residual_layernorm(z.clone(), u, bias)[0], out)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("temporal", [False, True], ids=["spatial", "temporal"])
def test_qkv_bias_split_is_the_permuted_bias_add(dtype, temporal):
    """The planes q, k, v bit for bit what the bias add into the permuted
    (3, M, C) tensor wrote, and the attention views of them the same."""
    W, Fr, J, H = 2, WINDOW, 17, HEADS
    m = W * Fr * J
    y, bias = _randn(m, 3 * C, seed=6), _randn(3 * C, seed=7)
    want = torch.empty(3, m, C, dtype=dtype)
    torch.add(y.view(m, 3, C), bias.view(3, C), out=want.permute(1, 0, 2))
    got = G.qkv_bias_split(y, bias, dtype)
    _equal(got, want)
    shape = (W, Fr, J * H, C // H) if temporal else (W * Fr, J, H, C // H)
    for a, b in zip(got, want):
        _equal(a.view(shape).transpose(1, 2), b.view(shape).transpose(1, 2))


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_bias_gelu_cast_is_bias_add_gelu_and_cast(dtype):
    """fc1's bias add, the exact GELU in place and the cast mm_bf16 made
    before fc2, bit for bit."""
    y, bias = _randn(M, HIDDEN, seed=8), _randn(HIDDEN, seed=9)
    want = _as_operand(torch.ops.aten.gelu_(y.clone().add_(bias)), dtype)
    _equal(G.bias_gelu_cast(y, bias, dtype), want)


class _OpSequenceDSTformer(dstformer.DSTformer):
    """The DSTformer's streams as PyTorch's op sequence, before the glue."""

    def _stream(self, blk, z, order, shape, keys, policy, args):
        out = None
        for sfx in order:
            temporal = sfx == "t"
            norm = getattr(blk, f"norm1_{sfx}")
            u = self._attention(getattr(blk, f"attn_{sfx}"),
                                _ln(z if out is None else out, norm.weight, norm.bias),
                                shape, keys if temporal else None, temporal, policy)
            out = z + u if out is None else out.add_(u)
            mlp, norm = getattr(blk, f"mlp_{sfx}"), getattr(blk, f"norm2_{sfx}")
            u = torch.ops.aten.gelu_(_linear(_ln(out, norm.weight, norm.bias), mlp.fc1,
                                             policy))
            out.add_(_linear(u, mlp.fc2, policy))
        return out

    def _attention(self, attn, h, shape, keys, temporal, policy):
        W, Fr, J = shape
        M_, C_ = h.shape
        H = self.num_heads
        D = C_ // H
        y = dstformer._mm(h, attn.qkv.weight, policy)
        qkv = torch.empty(3, M_, C_, dtype=policy.compute_dtype, device=h.device)
        torch.add(y.view(M_, 3, C_), attn.qkv.bias.view(3, C_), out=qkv.permute(1, 0, 2))
        if temporal:
            q, k, v = (t.view(W, Fr, J * H, D).transpose(1, 2) for t in qkv)
        else:
            q, k, v = (t.view(W * Fr, J, H, D).transpose(1, 2) for t in qkv)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=keys)
        return _linear(o.transpose(1, 2).reshape(M_, C_), attn.proj, policy)


def _linear(x, lin, policy):
    return dstformer._mm(x, lin.weight, policy).add_(lin.bias)


@pytest.fixture(scope="module")
def params():
    return R.init_params(torch.Generator().manual_seed(22), dim_feat=C, mlp_hidden=HIDDEN,
                         depth=2, maxlen=WINDOW)


def _windows():
    """A full window and a 10-frame tail padded to 27, with its lengths."""
    x = _randn(2, WINDOW, 17, 3, seed=10)
    x[1, 10:] = 0.0
    return x, np.array([WINDOW, 10])


@pytest.mark.parametrize("policy", [F32, BF16], ids=["f32", "bf16"])
def test_forward_is_the_op_sequence_forward_bit_for_bit(params, policy):
    model = dstformer.from_state_dict(params, num_heads=HEADS)
    ops = dstformer.from_state_dict(params, num_heads=HEADS)
    ops.__class__ = _OpSequenceDSTformer
    x, lens = _windows()
    _equal(model(x, lens, policy), ops(x, lens, policy))


@pytest.mark.parametrize("policy", [F32, BF16], ids=["f32", "bf16"])
def test_forward_makes_nine_glue_calls_per_stream(params, policy, monkeypatch):
    """Per stream: the first LayerNorm alone, three residual adds each with
    the next LayerNorm, the last residual add alone, two qkv splits and two
    bias + GELU passes, each writing the policy's compute dtype."""
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            kind, written = name, out
            if name == "residual_layernorm":
                residual = (args[1] if len(args) > 1 else kwargs.get("u")) is not None
                written = out[1]
                kind = {(False, True): "layernorm", (True, True): "residual_layernorm",
                        (True, False): "residual"}[residual, written is not None]
            calls.append((kind, written))
            return out
        return wrapped

    for name in ("residual_layernorm", "qkv_bias_split", "bias_gelu_cast"):
        monkeypatch.setattr(G, name, spy(name, getattr(G, name)))
    model = dstformer.from_state_dict(params, num_heads=HEADS)
    x, lens = _windows()
    model(x, lens, policy)
    streams = 2 * len(model.blocks_st)
    kinds = [k for k, _ in calls]
    assert len(calls) == 9 * streams
    assert {k: kinds.count(k) for k in set(kinds)} == {
        "layernorm": streams, "residual_layernorm": 3 * streams, "residual": streams,
        "qkv_bias_split": 2 * streams, "bias_gelu_cast": 2 * streams}
    for kind, out in calls:
        if out is not None:
            assert out.dtype == policy.compute_dtype, kind


def test_no_kernel_launches_on_the_cpu(params):
    counters = (G.residual_layernorm, G.qkv_bias_split, G.bias_gelu_cast)
    before = [f.launches for f in counters]
    model = dstformer.from_state_dict(params, num_heads=HEADS)
    model(*_windows(), BF16)
    assert [f.launches for f in counters] == before


def _bad(width):
    y = torch.zeros(8, width)
    b = torch.zeros(width)
    return {"residual_layernorm": lambda: G.residual_layernorm(y, y.clone(), b, b, b),
            "layernorm": lambda: G.residual_layernorm(y, gamma=b, beta=b),
            "qkv_bias_split": lambda: G.qkv_bias_split(torch.zeros(8, 3 * width),
                                                       torch.zeros(3 * width)),
            "bias_gelu_cast": lambda: G.bias_gelu_cast(y, b)}


@pytest.mark.parametrize("entry", ["residual_layernorm", "layernorm", "qkv_bias_split",
                                   "bias_gelu_cast"])
def test_a_width_not_a_multiple_of_8_is_refused(entry):
    _bad(64)[entry]()  # the same call at a width of 64 runs
    with pytest.raises(ValueError, match="row width 60 is not a multiple of 8"):
        _bad(60)[entry]()


def test_other_misuse_is_refused():
    x, b = torch.zeros(8, 64), torch.zeros(64)
    with pytest.raises(ValueError, match="at least one pair"):
        G.residual_layernorm(x)
    with pytest.raises(ValueError, match="u with its bias"):
        G.residual_layernorm(x, x.clone())
    with pytest.raises(ValueError, match="float32 tensor"):
        G.residual_layernorm(x.double(), gamma=b, beta=b)
    with pytest.raises(ValueError, match="not contiguous"):
        G.bias_gelu_cast(torch.zeros(64, 8).t(), b)
    with pytest.raises(ValueError, match=r"shape \(64,\)"):
        G.bias_gelu_cast(x, torch.zeros(32))
    with pytest.raises(ValueError, match="writes f32 or bf16"):
        G.qkv_bias_split(torch.zeros(8, 192), torch.zeros(192), torch.float16)
    with pytest.raises(ValueError, match="not 3 C"):
        G.qkv_bias_split(torch.zeros(8, 64), b)
    with pytest.raises(ValueError, match="above 512"):
        G.residual_layernorm(torch.zeros(2, 520), gamma=torch.zeros(520), beta=torch.zeros(520))


@pytest.mark.parametrize("entry", ["residual_layernorm", "qkv_bias_split", "bias_gelu_cast"])
def test_an_input_that_needs_a_gradient_is_refused_while_autograd_records(entry):
    """The glue serves and does not train: on the card its kernels write
    outside autograd, so a caller that records a graph is refused on either
    device; under no_grad the same call runs."""
    x, b = torch.zeros(8, 64), torch.zeros(64, requires_grad=True)
    call = {"residual_layernorm": lambda: G.residual_layernorm(x, gamma=b, beta=b),
            "qkv_bias_split": lambda: G.qkv_bias_split(torch.zeros(8, 192),
                                                       torch.zeros(192, requires_grad=True)),
            "bias_gelu_cast": lambda: G.bias_gelu_cast(x, b)}[entry]
    with pytest.raises(ValueError, match="serves and does not train"):
        call()
    with torch.no_grad():
        call()
