"""The serving daemon of links_tpu_torch (cli/serve.py) on the CPU: the
``Coalescer`` (merging, scattering, failure delivery and isolation, as
tests/test_serve.py holds the JAX package's), and the HTTP server on port 0
(JSON and ``.npy`` requests against the JAX package's lift of the same
weights, concurrent clients, bad input, ``--no-coalesce``, ``--fused`` and
``--quant``, an ``--artifact`` that is not one; tests/test_torch_export.py
serves real artifacts)."""

import contextlib
import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_suite import one_cpu_thread  # noqa: F401  (an autouse fixture)
from links_tpu import ckpt as jckpt
from links_tpu import models as jmodels
from links_tpu.objectives import lift_left_right_eval as j_left_right
from links_tpu_torch.cli import serve as tserve
from links_tpu_torch.cli.serve import Coalescer, _parse_poses

HID = 128
F32_TOL = {"rtol": 1e-5, "atol": 2e-5}  # tests/test_torch_lift_cli.py's f32 lift tolerance


def _payloads(rng, sizes):
    return [rng.normal(size=(n, 34)).astype(np.float32) for n in sizes]


def test_coalescer_merges_and_scatters(rng):
    """Concurrent submits merge into fewer device runs, each caller gets its
    own rows back, and a failing run reaches its caller without stopping the
    dispatcher."""
    def fn(chunk):
        time.sleep(0.02)  # hold the "device" so submitters pile up
        return chunk * 2.0

    co = Coalescer(fn, batch=16)
    try:
        payloads = _payloads(rng, (3, 5, 4, 7, 2, 6))
        outs = [None] * len(payloads)

        def worker(i):
            outs[i] = co.submit(payloads[i])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(payloads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        for p, o in zip(payloads, outs):
            np.testing.assert_allclose(o, p * 2.0, rtol=1e-6)
        assert co.stats["merged_requests"] == 6 and co.stats["device_batches"] < 6

        def boom(chunk):
            raise RuntimeError("kaboom")

        co.fn = boom
        with pytest.raises(RuntimeError, match="kaboom"):
            co.submit(payloads[0])
        co.fn = fn
        np.testing.assert_allclose(co.submit(payloads[1]), payloads[1] * 2.0, rtol=1e-6)
    finally:
        co.close()


def test_coalescer_failure_isolation(rng):
    """A poisoned request merged with clean ones fails alone: the merged run
    is retried request by request."""
    def fn(chunk):
        if torch.isnan(chunk).any():
            raise RuntimeError("poisoned rows")
        time.sleep(0.02)
        return chunk * 2.0

    co = Coalescer(fn, batch=64)
    try:
        blocker = rng.normal(size=(8, 34)).astype(np.float32)  # occupies the dispatcher
        clean = _payloads(rng, (3, 5, 4))
        poison = np.full((2, 34), np.nan, dtype=np.float32)
        payloads = [blocker, clean[0], poison, *clean[1:]]
        outs: list = [None] * len(payloads)

        def worker(i):
            try:
                outs[i] = co.submit(payloads[i])
            except Exception as e:
                outs[i] = e

        threads = []
        for i in range(len(payloads)):
            threads.append(threading.Thread(target=worker, args=(i,)))
            threads[-1].start()
            if i == 0:
                time.sleep(0.005)  # let the blocker start its run
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        for i, (p, o) in enumerate(zip(payloads, outs)):
            if i == 2:
                assert isinstance(o, RuntimeError), o
            else:
                assert not isinstance(o, Exception), (i, o)
                np.testing.assert_allclose(o, p * 2.0, rtol=1e-6)
    finally:
        co.close()


def test_coalescer_runs_in_inference_mode(rng):
    """Inference mode is per thread: the dispatcher enters it itself."""
    seen = []

    def fn(chunk):
        seen.append(torch.is_inference_mode_enabled())
        return chunk

    co = Coalescer(fn, batch=8)
    try:
        co.submit(_payloads(rng, (3,))[0])
    finally:
        co.close()
    assert seen == [True]


@pytest.mark.parametrize("shape", [(34,), (3, 34), (3, 2, 17)])
@pytest.mark.parametrize("kind", ["json", "npy"])
def test_parse_poses(rng, shape, kind):
    arr = rng.normal(size=shape).astype(np.float32)
    if kind == "json":
        got = _parse_poses(json.dumps({"poses_2d": arr.tolist()}).encode(), "application/json")
    else:
        buf = io.BytesIO()
        np.save(buf, arr)
        got = _parse_poses(buf.getvalue(), "application/octet-stream")
    np.testing.assert_array_equal(got, arr.reshape(-1, 34))


@pytest.mark.parametrize("body", [b'{"poses_2d": [[1.0, 2.0]]}', b'{"poses": []}', b"[]",
                                  b'{"poses_2d": []}'])
def test_parse_poses_refuses(body):
    with pytest.raises(ValueError, match="poses_2d"):
        _parse_poses(body, "application/json")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A reference-layout .pt pair of seeded JAX side lifters, and the JAX
    pair stacked."""
    ws = tmp_path_factory.mktemp("serve")
    trees = [jmodels.init_lifter(jax.random.PRNGKey(s), 11, hidden=HID) for s in (0, 1)]
    for side, tree in zip(("left", "right"), trees):
        jckpt.save_pt(ws / f"{side}_lifter.pt", jckpt.lifter_to_torch(tree))
    return ws, jax.tree.map(lambda a, b: jnp.stack([a, b]), *trees)


@contextlib.contextmanager
def _server(ws, *flags):
    """The port's server on an ephemeral port, serving in a thread."""
    args = tserve.build_parser().parse_args([
        "--left-pt", str(ws / "left_lifter.pt"), "--right-pt", str(ws / "right_lifter.pt"),
        "--port", "0", "--device", "cpu", "--batch-size", "8", *flags])
    srv = tserve.make_server(args)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    host, port = srv.server_address[:2]
    try:
        yield f"http://{host}:{port}"
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=5)
    assert not thread.is_alive()


def _post(url, data: bytes, content_type: str):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": content_type})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _health(base):
    with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
        return json.loads(resp.read())


def _poses(rng, n):
    p = rng.normal(size=(n, 2, 17)).astype(np.float32) * 0.1
    p[:, :, 0] = 0.0
    return p.reshape(n, 34)


def _want(stacked, poses):
    return np.asarray(jax.jit(j_left_right)(stacked, jnp.asarray(poses))).reshape(-1, 3, 17)


def test_serve_json_and_npy_match_the_jax_lift(weights, rng):
    """A JSON request and a .npy request ((N, 2, 17) layout) answered with
    the JAX package's lift of the same poses and weights; the counters
    advance."""
    ws, stacked = weights
    poses = _poses(rng, 5)
    with _server(ws) as base:
        health = _health(base)
        assert health["ok"] and health["coalescing"] and health["batch"] == 8
        assert health["model"]["device"] == "cpu"
        out = _post(base + "/lift", json.dumps({"poses_2d": poses.tolist()}).encode(),
                    "application/json")
        assert out["count"] == 5 and out["ms"] >= 0
        np.testing.assert_allclose(np.asarray(out["poses_3d"], np.float32),
                                   _want(stacked, poses), **F32_TOL)
        buf = io.BytesIO()
        np.save(buf, poses.reshape(5, 2, 17))
        out2 = _post(base + "/lift", buf.getvalue(), "application/octet-stream")
        np.testing.assert_array_equal(out2["poses_3d"], out["poses_3d"])
        health = _health(base)
    assert health["requests"] == 2 and health["poses"] == 10 and health["errors"] == 0


@pytest.mark.parametrize("flags", [[], ["--no-coalesce"]])
def test_serve_concurrent_clients(weights, rng, flags):
    """Concurrent clients each get their own poses' lift (more rows than a
    chunk in all); with coalescing, /healthz reports the merges."""
    ws, stacked = weights
    poses = [_poses(rng, n) for n in (2, 3, 4, 5, 9, 1)]
    outs = [None] * len(poses)
    with _server(ws, *flags) as base:
        def client(i):
            outs[i] = _post(base + "/lift", json.dumps({"poses_2d": poses[i].tolist()}).encode(),
                            "application/json")

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(poses))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        health = _health(base)
    for p, o in zip(poses, outs):
        np.testing.assert_allclose(np.asarray(o["poses_3d"], np.float32), _want(stacked, p),
                                   **F32_TOL)
    assert health["requests"] == len(poses) and health["poses"] == sum(map(len, poses))
    assert health["coalescing"] is (not flags)
    if not flags:
        assert health["merged_requests"] == len(poses) and health["device_batches"] >= 1


def test_serve_rejects_bad_input(weights):
    """Malformed input is answered with 400 and an unknown route with 404;
    the server stays alive and counts the error."""
    ws, _ = weights
    with _server(ws, "--no-warmup") as base:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base + "/lift", json.dumps({"poses_2d": [[1.0, 2.0]]}).encode(),
                  "application/json")
        assert exc.value.code == 400
        assert "poses_2d" in json.loads(exc.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base + "/lift", b"not json", "application/json")
        assert exc.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base + "/nope", b"{}", "application/json")
        assert exc.value.code == 404
        health = _health(base)
        assert health["errors"] == 2 and health["requests"] == 0


def test_serve_model_failure_is_500_and_the_server_lives(weights, rng, monkeypatch):
    """A failure inside the model is answered with 500; the next request is
    served."""
    ws, stacked = weights
    with _server(ws) as base:
        failing = {"on": True}
        real = tserve.Coalescer._run

        def run(self, poses):
            if failing["on"]:
                raise RuntimeError("device fault")
            return real(self, poses)

        monkeypatch.setattr(tserve.Coalescer, "_run", run)
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base + "/lift", json.dumps({"poses_2d": _poses(rng, 2).tolist()}).encode(),
                  "application/json")
        assert exc.value.code == 500 and "device fault" in json.loads(exc.value.read())["error"]
        failing["on"] = False
        poses = _poses(rng, 3)
        out = _post(base + "/lift", json.dumps({"poses_2d": poses.tolist()}).encode(),
                    "application/json")
        np.testing.assert_allclose(np.asarray(out["poses_3d"], np.float32),
                                   _want(stacked, poses), **F32_TOL)


@pytest.mark.parametrize("flags", [["--fused"], ["--quant", "int8"], ["--policy", "bf16"]])
def test_serve_takes_lifts_serving_flags(weights, rng, flags, tmp_path):
    """--fused, --quant and --policy serve what lift serves for the same
    flags and poses."""
    from links_tpu_torch.cli import lift as tlift

    ws, _ = weights
    poses = _poses(rng, 6)
    np.save(tmp_path / "p.npy", poses)
    want = tlift.main(["--left-pt", str(ws / "left_lifter.pt"), "--right-pt",
                       str(ws / "right_lifter.pt"), "--device", "cpu", "--raw-2d",
                       str(tmp_path / "p.npy"), "--batch-size", "8",
                       "--out", str(tmp_path / "o.npz"), *flags])
    with _server(ws, *flags) as base:
        out = _post(base + "/lift", json.dumps({"poses_2d": poses.tolist()}).encode(),
                    "application/json")
        assert _health(base)["model"]["quant"] == (flags[1] if "--quant" in flags else None)
    np.testing.assert_array_equal(np.asarray(out["poses_3d"], np.float32), want)


def test_serve_refuses_an_artifact(weights, tmp_path):
    """--artifact naming no artifact is refused before the server starts."""
    ws, _ = weights
    with pytest.raises(FileNotFoundError, match="no serving artifact"):
        with _server(ws, "--artifact", str(tmp_path / "model.pt2")):
            pass
