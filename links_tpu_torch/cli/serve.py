"""An HTTP serving daemon for 2D->3D lifting (counterpart of
links_tpu/cli/serve.py), on the standard library's HTTP server.

It loads the model once, through ``lift``'s flags and its
``build_serving_fn`` (the left/right pair on the residual-block kernel's
forward, ``--fused`` on the fused serving kernel, ``--mode leg_torso``,
``--scenario``, ``--quant``, ``--policy``), then answers requests:

* ``POST /lift``: a JSON body ``{"poses_2d": [[34 floats], ...]}`` or a raw
  ``.npy`` (Content-Type ``application/octet-stream``) of normalized (34,),
  (N, 34) or (N, 2, 17) poses -> ``{"poses_3d": [[[3 x 17]], ...], "count":
  N, "ms": t}``; malformed input is answered with 400, a failure of the
  model with 500, and the server stays up;
* ``GET /healthz``: liveness, the model's description and the request, pose
  and error counters; with coalescing, the dispatcher's ``stats``: device
  batches, merged requests, ``queue_wait_s`` (the seconds requests waited
  in its queue, summed: over ``merged_requests``, the mean wait) and
  ``dispatch_host_s`` (its host seconds merging requests and replying,
  outside the device runs); and ``spans``, the process's span totals since
  it started (train/profiling.py), ``{name: {"count", "seconds"}}``: the
  dispatcher's ``serve.wait``, ``serve.merge``, ``serve.reply`` and each
  chunk's ``lift.h2d``, ``lift.forward``, ``lift.d2h``.

One dispatcher thread owns the device (the ``Coalescer``): HTTP threads hand
it their poses and wait, and it merges the requests that queued while the
device was busy into one chunked run, so that N concurrent small requests
cost fewer than N device runs. A merged run that fails is retried request
by request, so that one poisoned request fails alone. ``--no-coalesce``
serializes each request's device work behind a lock instead. Autograd's
inference mode is a per-thread setting, so the dispatcher (or the lock
holder) enters it itself. ``profiling.trace`` shows the dispatcher's spans
beside the device's kernels.

``--artifact`` serves an exported model (``links_tpu_torch.cli.export_model``)
in place of the checkpoints: the model flags are then ignored, with a warning,
and an artifact of pinned batch is called at that batch, its last chunk
padded. The process registers the artifact's residual-block op by importing
``links_tpu_torch.ops`` (ckpt/export_io.py).

Usage:
    python -m links_tpu_torch.cli.serve --data data/h36m_data.pkl --model-dir models \\
        [--fused | --quant int8] [--port 8321] [--device cuda]
    python -m links_tpu_torch.cli.serve --artifact lr.pt2 [--port 8321]
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from links_tpu_torch.cli import _common as C
from links_tpu_torch.cli.lift import _chunked, _chunks, add_serving_flags, build_serving_fn
from links_tpu_torch.train.profiling import span, totals

MAX_BODY = 256 * 1024 * 1024  # 256 MB, about 2M poses: anything larger is refused


class Coalescer:
    """Cross-request batching on one device (the JAX package's ``Coalescer``).

    HTTP threads ``submit()`` their (N, 34) poses and block; one dispatcher
    thread runs ``fn`` over chunks of at most ``batch`` poses on ``device``.
    Each time it finishes a run it drains what queued meanwhile (and, with
    ``max_wait_ms``, what arrives within that window while the first chunk
    is unfilled), up to ``max_merge_chunks`` chunks of rows, concatenates
    it, runs it once and hands each caller its slice. A lone request waits
    for nothing. When a merged run raises, each of its requests is run alone,
    so only a request that fails by itself gets the error.

    ``stats``: ``device_batches`` (runs), ``merged_requests`` (the requests
    they answered), ``queue_wait_s`` (the seconds from each ``submit`` to the
    dispatcher taking the request) and ``dispatch_host_s`` (the seconds of
    its ``serve.merge`` and ``serve.reply`` spans). The dispatcher's spans
    (train/profiling.py): ``serve.wait`` for the next request, ``serve.merge``
    (the drain and the concatenation), the ``lift.*`` spans of each chunk
    (cli/lift.py:_chunks) and ``serve.reply`` (the outputs' concatenation,
    the callers' slices and their wake-up); a run's spans carry its number
    and request count as ``args``."""

    _CLOSE = object()

    def __init__(self, fn, batch: int, device="cpu", max_wait_ms: float = 0.0,
                 max_merge_chunks: int = 4):
        self.fn = fn
        self.batch = batch
        self.device = device
        self.max_wait = max_wait_ms / 1e3
        self.max_rows = max_merge_chunks * batch
        self.stats = {"device_batches": 0, "merged_requests": 0, "queue_wait_s": 0.0,
                      "dispatch_host_s": 0.0}
        self._q: queue.Queue = queue.Queue()
        self._args = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="links-serve-dispatch")
        self._thread.start()

    def submit(self, poses: np.ndarray) -> np.ndarray:
        ev = threading.Event()
        slot: dict = {}
        self._q.put((poses, ev, slot, time.perf_counter()))
        ev.wait()
        if "err" in slot:
            raise slot["err"]
        return slot["out"]

    def close(self):
        self._q.put(self._CLOSE)
        self._thread.join(timeout=5)

    def _take(self, item):
        self.stats["queue_wait_s"] += time.perf_counter() - item[3]

    def _drain(self, pending, rows):
        """Merge queued requests into ``pending`` up to max_rows; with a wait
        window, also those arriving before its end while the first chunk is
        unfilled."""
        deadline = time.monotonic() + self.max_wait
        while rows < self.max_rows:
            try:
                wait = deadline - time.monotonic()
                if wait > 0 and rows < self.batch:
                    nxt = self._q.get(timeout=wait)
                else:
                    nxt = self._q.get_nowait()
            except queue.Empty:
                break
            if nxt is self._CLOSE:
                self._q.put(self._CLOSE)  # stop after this run
                break
            self._take(nxt)
            pending.append(nxt)
            rows += nxt[0].shape[0]
        return pending

    def _run(self, poses: np.ndarray) -> list:
        return _chunks(self.fn, poses, self.batch, self.device, self._args)

    def _reply(self, requests, outs) -> float:
        """Hand each of ``requests`` its rows of ``outs`` (their outputs'
        chunks), or its error (an exception); -> the span's seconds."""
        with span("serve.reply", self._args) as reply:
            if isinstance(outs, Exception):
                for _, ev, slot, _ in requests:
                    slot["err"] = outs
                    ev.set()
            else:
                out = torch.cat(outs).numpy()
                ofs = 0
                for poses, ev, slot, _ in requests:
                    n = poses.shape[0]
                    slot["out"] = out[ofs:ofs + n]
                    ofs += n
                    ev.set()
        return reply.seconds

    def _loop(self):
        with torch.inference_mode():  # per thread: this one runs the device work
            run = 0
            while True:
                with span("serve.wait"):
                    item = self._q.get()
                if item is self._CLOSE:
                    return
                run += 1
                with span("serve.merge", f"run {run}") as merge:
                    self._take(item)
                    pending = self._drain([item], item[0].shape[0])
                    arr = (pending[0][0] if len(pending) == 1 else
                           np.concatenate([p[0] for p in pending]))
                host_s = merge.seconds
                self._args = f"run {run} requests {len(pending)}"  # the run's spans' args
                try:
                    outs = self._run(arr)
                except Exception as e:  # the dispatcher must outlive a failed run
                    if len(pending) == 1:
                        host_s += self._reply(pending, e)
                    else:  # one poisoned request must not fail the others merged with it
                        for p in pending:
                            try:
                                outs_i = self._run(p[0])
                                self.stats["device_batches"] += 1
                                self.stats["merged_requests"] += 1
                            except Exception as e_i:
                                outs_i = e_i
                            host_s += self._reply([p], outs_i)
                    self.stats["dispatch_host_s"] += host_s
                    continue
                self.stats["device_batches"] += 1
                self.stats["merged_requests"] += len(pending)
                self.stats["dispatch_host_s"] += host_s + self._reply(pending, outs)


def _parse_poses(body: bytes, content_type: str) -> np.ndarray:
    """A request body -> (N, 34) f32 poses, N >= 1; ValueError otherwise."""
    if content_type.startswith("application/octet-stream"):
        arr = np.load(io.BytesIO(body), allow_pickle=False)
    else:
        payload = json.loads(body.decode("utf-8"))
        if not isinstance(payload, dict) or "poses_2d" not in payload:
            raise ValueError('JSON body must be {"poses_2d": [[...], ...]}')
        arr = np.asarray(payload["poses_2d"], np.float32)
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 1 and arr.size == 34:
        arr = arr[None]
    if arr.ndim == 3 and arr.shape[1:] == (2, 17):
        arr = arr.reshape(-1, 34)
    if arr.ndim != 2 or arr.shape[1] != 34 or arr.shape[0] == 0:
        raise ValueError(f"poses_2d must be non-empty (N, 34) or (N, 2, 17) normalized 2D "
                         f"poses, got {arr.shape}")
    return arr


def _padded(fn, batch: int):
    """``fn`` of a pinned batch, called on chunks of at most ``batch`` rows:
    a shorter chunk is padded with copies of its last row, and its rows of
    the output kept."""
    def call(p2d: torch.Tensor) -> torch.Tensor:
        n = p2d.shape[0]
        if n == batch:
            return fn(p2d)
        return fn(torch.cat([p2d, p2d[-1:].expand(batch - n, -1)]))[:n]

    return call


def _load_artifact(args, device):
    """--artifact: (its callable, the chunk batch, the model's description)."""
    from links_tpu_torch import ckpt

    ignored = [f for f, on in (("--scenario", args.scenario), ("--quant", args.quant),
                               ("--fused", args.fused), ("--mode", args.mode != "left_right"),
                               ("--policy", args.policy != "f32")) if on]
    if ignored:
        print(f"[links_tpu_torch] serve: {' '.join(ignored)} ignored: the model is baked into "
              f"the artifact at export time", file=sys.stderr)
    art = ckpt.deserialize_exported(args.artifact, device)
    fn, batch = art.call, args.batch_size or 256
    if art.batch:  # a pinned batch: chunk at it
        fn, batch = _padded(fn, art.batch), art.batch
    return fn, batch, {"artifact": args.artifact, "platforms": art.platforms,
                       "inputs": art.inputs, "device": str(device)}


def make_server(args) -> ThreadingHTTPServer:
    """The HTTP server with the model (or --artifact) loaded and warmed,
    unless --no-warmup, bound to --host/--port (port 0: any free one); its
    ``server_close`` also stops the dispatcher."""
    device = C.resolve_device(args.device)
    if getattr(args, "artifact", None):
        fn, batch, model_desc = _load_artifact(args, device)
    else:
        with torch.inference_mode():  # the weights load as inference tensors, as in lift
            fn, batch, _ = build_serving_fn(args, args.batch_size or 256, device)
        model_desc = {"mode": args.mode, "scenario": args.scenario, "quant": args.quant,
                      "fused": args.fused, "policy": args.policy, "model_dir": args.model_dir,
                      "device": str(device)}
    if args.warmup:
        with torch.inference_mode():
            _chunked(fn, np.zeros((batch, 34), np.float32), batch, device)
    lock = threading.Lock()
    stats = {"requests": 0, "poses": 0, "errors": 0, "started": time.time()}
    coalescer = None
    if getattr(args, "coalesce", True):
        coalescer = Coalescer(fn, batch, device,
                              max_wait_ms=getattr(args, "coalesce_wait_ms", 0.0))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *log_args):  # quiet unless --verbose
            if args.verbose:
                BaseHTTPRequestHandler.log_message(self, fmt, *log_args)

        def _reply(self, code: int, obj: dict):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _error(self, code: int, msg: str):
            with lock:
                stats["errors"] += 1
            self._reply(code, {"error": msg})

        def do_GET(self):
            if self.path not in ("/healthz", "/"):
                return self._reply(404, {"error": f"no route {self.path}"})
            with lock:
                snap = dict(stats)
            if coalescer is not None:
                snap.update(coalescer.stats)
            snap["spans"] = {name: {"count": n, "seconds": sec}
                             for name, (n, sec) in totals().items()}
            self._reply(200, {"ok": True, "model": model_desc, "batch": batch,
                              "coalescing": coalescer is not None, **snap})

        def do_POST(self):
            if self.path != "/lift":
                return self._reply(404, {"error": f"no route {self.path}"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                if not 0 < length <= MAX_BODY:
                    raise ValueError(f"Content-Length must be in (0, {MAX_BODY}]")
                poses = _parse_poses(self.rfile.read(length),
                                     self.headers.get("Content-Type", "application/json"))
            except Exception as e:  # malformed input: 400, not a crash
                return self._error(400, str(e))
            t0 = time.perf_counter()
            try:
                if coalescer is not None:
                    pred = coalescer.submit(poses)
                else:
                    with lock, torch.inference_mode():  # one device: one request at a time
                        pred = _chunked(fn, poses, batch, device)
            except Exception as e:  # a failure of the model: 500, and the server lives on
                return self._error(500, f"{type(e).__name__}: {e}")
            ms = (time.perf_counter() - t0) * 1e3
            n = poses.shape[0]
            with lock:
                stats["requests"] += 1
                stats["poses"] += n
            self._reply(200, {"poses_3d": pred.reshape(n, 3, 17).tolist(), "count": n,
                              "ms": round(ms, 3)})

    server = ThreadingHTTPServer((args.host, args.port), Handler)
    server.links_model_desc = model_desc
    server.links_coalescer = coalescer
    close = server.server_close

    def _close():
        if coalescer is not None:
            coalescer.close()
        close()

    server.server_close = _close
    return server


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="HTTP serving daemon for 2D->3D pose lifting (PyTorch port)")
    parser.add_argument("--artifact", default=None,
                        help="serve an exported model (links_tpu_torch.cli.export_model) "
                             "instead of checkpoints; the model flags are ignored")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8321)
    parser.add_argument("--no-warmup", dest="warmup", action="store_false",
                        help="skip the startup warm-up run (the first request pays it)")
    parser.add_argument("--verbose", action="store_true",
                        help="per-request access log on stderr")
    parser.add_argument("--no-coalesce", dest="coalesce", action="store_false",
                        help="no cross-request batching: each request's device work runs "
                             "alone behind a lock")
    parser.add_argument("--coalesce-wait-ms", type=float, default=0.0,
                        help="wait up to this long for more requests while the next chunk "
                             "is unfilled (default 0: merge only what queued while the "
                             "device was busy)")
    add_serving_flags(parser)
    C.add_device_flag(parser)
    C.add_common_flags(parser)
    C.add_lr_pt_flags(parser)
    C.add_use_best_flag(parser)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    server = make_server(args)
    host, port = server.server_address[:2]
    print(json.dumps({"serving": f"http://{host}:{port}", "model": server.links_model_desc}),
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("[links_tpu_torch] serve: interrupted", file=sys.stderr)
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
