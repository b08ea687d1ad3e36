"""MotionBERT's DSTformer in the port (models/dstformer.py) on the CPU, at a
small size (dim 64, MLP 128, depth 2, 4 heads, windows of 27 frames),
against the plain reference of tests/dstformer_reference.py: the f32
forward, the bf16 forward against the reference at its bf16 points, a
padded and masked tail against its unpadded window, MotionBERT's state-dict
keys, windowed serving (lift, serve's WindowCoalescer and HTTP daemon) and
the flags it refuses."""

import ast
import contextlib
import functools
import io
import json
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_suite import one_cpu_thread  # noqa: F401  (an autouse fixture)
import dstformer_reference as R
from links_tpu_torch.cli import lift as tlift
from links_tpu_torch.cli import serve as tserve
from links_tpu_torch.core.nn import BF16, F32
from links_tpu_torch.models import dstformer
from links_tpu_torch.train.profiling import totals

WINDOW, HEADS = 27, 4
SMALL = {"dim_feat": 64, "mlp_hidden": 128, "depth": 2, "maxlen": WINDOW}
# f32: the same function, summed in other orders (relative to the largest output)
F32_TOL = 1e-5
# bf16 against the reference rounded at the same points: the attention kernel
# rounds its probabilities before normalizing them and the reference after,
# and each bf16 rounding can flip the next operand's; the fp8 control reads
# 0.08-0.09 at this size
BF16_TOL = 2e-2


@pytest.fixture(scope="module")
def params():
    return R.init_params(torch.Generator().manual_seed(3), **SMALL)


@pytest.fixture(scope="module")
def model(params):
    return dstformer.from_state_dict(params, num_heads=HEADS)


def _windows(seed, w=3):
    return torch.randn(w, WINDOW, 17, 3, generator=torch.Generator().manual_seed(seed))


def _gap(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_f32_forward_matches_the_reference(model, params):
    x = _windows(5)
    got = model(x)
    for w in range(x.shape[0]):
        assert _gap(got[w], R.forward(params, x[w], HEADS)) < F32_TOL


def test_bf16_forward_matches_the_reference_at_bf16(model, params):
    x = _windows(6)
    got = model(x, policy=BF16)
    for w in range(x.shape[0]):
        want = R.forward(params, x[w], HEADS, R.BF16)
        assert _gap(got[w], want) < BF16_TOL
        assert _gap(R.forward(params, x[w], HEADS, R.FP8), want) > BF16_TOL


@pytest.mark.parametrize("policy", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("valid", [1, 13, 26])
def test_padded_masked_tail_equals_the_unpadded_window(model, policy, valid):
    """A short window padded to the batch's length, its padding masked out
    of temporal attention's keys: its valid frames' outputs are the unpadded
    window's, and the full windows beside it are untouched. Under bf16 the
    masked batch runs another attention kernel than the unmasked window,
    which rounds its bf16 probabilities otherwise. Under f32 the unmasked
    batch (the fault) is 100x beyond."""
    tol = F32_TOL if policy is F32 else BF16_TOL
    x = _windows(7)
    padded = x.clone()
    padded[1, valid:] = 0.0
    got = model(padded, np.array([WINDOW, valid, WINDOW]), policy)
    alone = model(x[1:2, :valid], policy=policy)
    assert _gap(got[1, :valid], alone[0]) < tol
    full = model(x[[0, 2]], policy=policy)
    assert _gap(got[[0, 2]], full) < tol
    if policy is F32:
        unmasked = model(padded, policy=policy)
        assert _gap(unmasked[1, :valid], alone[0]) > 100 * tol


def test_state_dict_keys_are_motionberts(model, params):
    keys = set(model.state_dict())
    assert keys == set(params)
    for key in ("joints_embed.weight", "pos_embed", "temp_embed", "blocks_st.0.norm1_s.weight",
                "blocks_st.1.attn_s.qkv.weight", "blocks_st.0.attn_t.proj.bias",
                "blocks_ts.1.norm2_t.bias", "blocks_ts.0.mlp_s.fc1.weight",
                "blocks_ts.1.mlp_t.fc2.bias", "ts_attn.1.weight", "norm.weight",
                "pre_logits.fc.weight", "head.bias"):
        assert key in keys, key
    assert model.state_dict()["temp_embed"].shape == (1, WINDOW, 1, 64)
    assert model.state_dict()["pos_embed"].shape == (1, 17, 64)


def test_reference_state_dict_loads_through_a_pt(tmp_path, params):
    torch.save(params, tmp_path / "dst.pt")
    m = dstformer.load_pt(tmp_path / "dst.pt", num_heads=HEADS)
    assert m.maxlen == WINDOW and len(m.blocks_st) == 2
    for k, v in m.state_dict().items():
        torch.testing.assert_close(v, params[k], rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="Missing key"):
        dstformer.from_state_dict({k: v for k, v in params.items() if k != "ts_attn.0.bias"})


def test_pack_windows_aligns_each_clip_to_its_own_windows():
    clips = [np.full((n, 34), n, np.float32) for n in (1, 27, 28, 0, 55)]
    windows, lens = tlift.pack_windows(clips, WINDOW)
    assert windows.shape == (1 + 1 + 2 + 3, WINDOW, 34)
    assert lens.tolist() == [1, 27, 27, 1, 27, 27, 1]
    assert (windows[0, 1:] == 0).all() and (windows[3, 1:] == 0).all()
    assert (windows[4:, :][lens[4:, None] > np.arange(WINDOW)] == 55).all()


def _serving_fn(model, policy=F32):
    fn = functools.partial(model.lift, policy=policy)
    fn.window = WINDOW
    return fn


def test_window_coalescer_replies_equal_per_request_forwards(model, params):
    """Requests of 1, 26, 27, 28 and 100 frames merged across chunks of 2
    windows: each caller gets its own frames, as its request's forward
    alone gives them, and the reference's lift window by window."""
    fn = _serving_fn(model)
    rng = np.random.default_rng(8)
    reqs = [(rng.normal(size=(n, 34)) * 0.3).astype(np.float32) for n in (1, 26, 27, 28, 100)]
    release = threading.Event()
    held = []

    def slow(x, lens, args=None):  # hold the first run so that the rest queue behind it
        held.append(x.shape[0])
        release.wait(10)
        return fn(x, lens, args=args)

    slow.window = WINDOW
    co = tserve.WindowCoalescer(slow, 2 * WINDOW, window=WINDOW)
    outs = [None] * len(reqs)
    try:
        first = threading.Thread(target=lambda: outs.__setitem__(0, co.submit(reqs[0])))
        first.start()
        while not held:
            threading.Event().wait(0.005)
        rest = [threading.Thread(target=lambda i=i: outs.__setitem__(i, co.submit(reqs[i])))
                for i in range(1, len(reqs))]
        for t in rest:
            t.start()
        while co._q.qsize() < len(rest):
            threading.Event().wait(0.005)
        release.set()
        for t in [first, *rest]:
            t.join(timeout=20)
            assert not t.is_alive()
    finally:
        release.set()
        co.close()
    # the second run merged 1 + 1 + 2 + 4 windows, in chunks of at most 2
    assert held == [1, 2, 2, 2, 2]
    assert co.stats["device_batches"] == 2 and co.stats["merged_requests"] == 5
    assert co.stats["windows"] == 9 and co.stats["tail_windows"] == 4
    assert co.stats["frames_run"] == 9 * WINDOW
    assert co.stats["frames_padded"] == 9 * WINDOW - 182
    for r, o in zip(reqs, outs):
        assert o.shape == (r.shape[0], 51)
        np.testing.assert_allclose(o, tlift.lift_windows(fn, r, WINDOW, "cpu"), rtol=0, atol=1e-6)
        want = torch.cat([R.lift(params, torch.from_numpy(r[i:i + WINDOW]), HEADS)
                          for i in range(0, r.shape[0], WINDOW)])
        assert _gap(torch.from_numpy(o), want) < F32_TOL


def test_window_coalescer_fails_only_the_poisoned_request(model):
    fn = _serving_fn(model)

    def picky(x, lens, args=None):
        if np.isnan(x.numpy()).any():
            raise ValueError("a NaN pose")
        return fn(x, lens, args=args)

    picky.window = WINDOW
    co = tserve.WindowCoalescer(picky, 4 * WINDOW, window=WINDOW)
    good = np.zeros((30, 34), np.float32)
    bad = np.full((3, 34), np.nan, np.float32)
    try:
        assert co.submit(good).shape == (30, 51)
        with pytest.raises(ValueError, match="NaN"):
            co.submit(bad)
        assert co.submit(good).shape == (30, 51)
    finally:
        co.close()


@pytest.fixture
def dst_pt(tmp_path):
    p = R.init_params(torch.Generator().manual_seed(4), dim_feat=64, mlp_hidden=128, depth=2)
    torch.save(p, tmp_path / "dst.pt")
    return tmp_path / "dst.pt", p


def test_lift_cli_serves_dstformer_windows(tmp_path, dst_pt):
    """``lift --model dstformer`` on 300 poses (a full 243-frame window and a
    57-frame tail) against the reference, published heads (8 of 8 here)."""
    path, p = dst_pt
    poses = (np.random.default_rng(9).normal(size=(300, 34)) * 0.3).astype(np.float32)
    np.save(tmp_path / "p.npy", poses)
    pred = tlift.main(["--model", "dstformer", "--dst-pt", str(path), "--raw-2d",
                       str(tmp_path / "p.npy"), "--out", str(tmp_path / "o.npz"),
                       "--device", "cpu", "--batch-size", "512"])
    assert pred.shape == (300, 3, 17)
    want = torch.cat([R.lift(p, torch.from_numpy(poses[:243])),
                      R.lift(p, torch.from_numpy(poses[243:]))])
    assert _gap(torch.from_numpy(pred.reshape(300, 51)), want) < F32_TOL


@pytest.mark.parametrize("flags", [["--fused"], ["--quant", "int8"], ["--scenario", "torso"],
                                   ["--mode", "leg_torso"], []],
                         ids=["fused", "quant", "scenario", "leg_torso", "no_dst_pt"])
def test_lift_cli_refuses_what_dstformer_does_not_take(tmp_path, dst_pt, flags):
    np.save(tmp_path / "p.npy", np.zeros((5, 34), np.float32))
    dst = ["--dst-pt", str(dst_pt[0])] if flags else []
    with pytest.raises(SystemExit, match="dstformer"):
        tlift.main(["--model", "dstformer", *dst, *flags, "--raw-2d", str(tmp_path / "p.npy"),
                    "--out", str(tmp_path / "o.npz"), "--device", "cpu"])


@contextlib.contextmanager
def _server(*flags):
    args = tserve.build_parser().parse_args(["--port", "0", "--device", "cpu", *flags])
    srv = tserve.make_server(args)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)


@pytest.mark.parametrize("coalesce", [True, False], ids=["coalesced", "no_coalesce"])
def test_serve_daemon_answers_dstformer_requests(dst_pt, coalesce):
    path, p = dst_pt
    poses = (np.random.default_rng(10).normal(size=(250, 34)) * 0.3).astype(np.float32)
    buf = io.BytesIO()
    np.save(buf, poses)
    flags = ["--model", "dstformer", "--dst-pt", str(path), "--batch-size", "243",
             "--no-warmup", *([] if coalesce else ["--no-coalesce"])]
    before = totals().get("dst.attn_t", (0, 0.0))[0]
    with _server(*flags) as base:
        req = urllib.request.Request(f"{base}/lift", data=buf.getvalue(),
                                     headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = json.loads(r.read())
    got = torch.tensor(out["poses_3d"]).reshape(250, 51)
    want = torch.cat([R.lift(p, torch.from_numpy(poses[:243])),
                      R.lift(p, torch.from_numpy(poses[243:]))])
    assert out["count"] == 250 and _gap(got, want) < F32_TOL
    assert health["model"]["model"] == "dstformer"
    if coalesce:
        assert health["windows"] == 2 and health["tail_windows"] == 1
        assert health["frames_padded"] == 2 * 243 - 250
    # two forwards of one window (--batch-size 243), each 2 levels x 2 streams
    assert totals()["dst.attn_t"][0] - before == 2 * 2 * 2


def test_reference_imports_no_port_and_no_jax():
    path = Path(R.__file__)
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert tops == {"__future__", "math", "torch"}
    code = (f"import sys; sys.path.insert(0, {str(path.parent)!r}); import dstformer_reference; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'links_tpu', 'links_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
