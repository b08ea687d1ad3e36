"""Serving cells: the path ``serve`` runs, without HTTP. Set-up writes a
seeded lifter pair under ``TMPDIR`` and builds the serving forward from
``serve``'s own flags (``cli/lift.py:build_serving_fn``), warmed as
``serve`` warms it, behind the daemon's dispatcher (``cli/serve.py:
Coalescer``), then sends one request of each size in ``warm_sizes`` through
it, one at a time (no backlog).

The load (``portbench/traffic.py``) is either a closed loop of the mix's
``callers``, each calling ``Coalescer.submit`` as the daemon's HTTP
handlers do and sending its next clip as soon as its reply comes, or an
open loop at the mix's fixed ``rate_per_s``: at each request's due time the
sender hands it to a caller thread of its own, as the daemon's threading
HTTP server gives each connection a thread (an idle one takes the next
request, a new one starts whenever all are busy). Past what the dispatcher
sustains an open loop needs a thread per queued request (on an H100 at
1,500 clips/s of this mix, 2,551 threads that starved the sender). A request's latency runs from when it
was sent (closed) or due (open) to its reply. With ``--trace 1`` a further
stretch of the mix runs under the profiler.

``correct``: every request sent in the window is answered with (N, 51)
poses, and a sample drawn from the seed, with the longest request in it,
matches the plain reference's lift of the same poses (``lift_gap``: the
widest gap over the sample, against each request's largest value).
"""

from __future__ import annotations

import math
import queue
import shutil
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from portbench import core, data, flops, trace, traffic, weights
from portbench.reference import model as ref

CALLER = "portbench-caller"


class ForwardSpans:
    """The benchmark's span around each call of the serving forward: its
    rows, and the thread that makes the calls (the dispatcher's)."""

    def __init__(self, fn):
        self.fn, self.rows, self.thread = fn, [], None

    def __call__(self, poses):
        self.thread = threading.get_ident()
        with trace.span("forward"):
            self.rows.append(poses.shape[0])
            return self.fn(poses)


def _lifters(config: dict, seed: int, device) -> dict:
    g = torch.Generator(device).manual_seed(core.derive(seed, "weights"))
    return weights.draw_linears({s: weights.lifter_linears(j, config["hidden"])
                                 for s, j in config["lifters"].items()}, g)


def warm_sizes(batch: int) -> list[int]:
    """Run sizes that meet every tile plan and vector width of the forward
    up to one chunk (1 to ``batch`` rows: powers of 2, 3 x powers of 2, and
    one either side of each), and one run of the most rows the dispatcher
    merges (4 chunks)."""
    sizes = {1, batch, 4 * batch}
    k = 1
    while k <= batch:
        sizes.update(s for s in (k - 1, k, k + 1, 3 * k) if 1 <= s <= batch)
        k *= 2
    return sorted(sizes)


def build(cell, seed: int, device):
    """The serving forward behind a Coalescer, warmed, and the request pool."""
    from links_tpu_torch.cli import _common as C
    from links_tpu_torch.cli import serve
    from links_tpu_torch.cli.lift import _chunked, build_serving_fn

    mix, sv = cell.traffic, cell.config["serve"]
    sds = _lifters(cell.config, seed, device)
    tmp = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        for side, sd in sds.items():
            torch.save({k: v.cpu() for k, v in sd.items()}, tmp / f"{side}.pt")
        args = serve.build_parser().parse_args([
            "--left-pt", str(tmp / "left.pt"), "--right-pt", str(tmp / "right.pt"),
            "--mode", sv["mode"], "--policy", sv["precision"], "--choice", sv["choice"],
            "--depth", str(sv["depth"]), "--batch-size", str(mix["batch_size"]),
            "--coalesce-wait-ms", str(mix["coalesce_wait_ms"]), "--device", str(device)])
        dev = C.resolve_device(args.device)
        with torch.inference_mode():
            fn, batch, _ = build_serving_fn(args, args.batch_size, dev)
            _chunked(fn, np.zeros((batch, 34), np.float32), batch, dev)  # serve's warm-up
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    spans = ForwardSpans(fn)
    co = serve.Coalescer(spans, batch, dev, max_wait_ms=args.coalesce_wait_ms)
    pool = data.test_poses(mix["pool_poses"],
                           torch.Generator(device).manual_seed(core.derive(seed, "data")))
    pool = pool.cpu().numpy()
    reps = np.resize(pool, (4 * batch, 34))
    for n in warm_sizes(batch):
        co.submit(reps[:n])
    return {"coalescer": co, "spans": spans, "pool": pool, "sds": sds}


class Callers:
    """Caller threads, each calling ``submit`` for one request at a time: an
    idle one takes the next request, and a new one starts when none is idle."""

    def __init__(self, call):
        self.call, self.work = call, queue.SimpleQueue()
        self.idle, self.threads, self.lock = 0, [], threading.Lock()

    def put(self, item):
        with self.lock:
            if self.idle:
                self.idle -= 1
                self.work.put(item)
                return
            t = threading.Thread(target=self._loop, args=(item,), daemon=True,
                                 name=f"{CALLER}-{len(self.threads)}")
            self.threads.append(t)
        t.start()

    def _loop(self, item):
        while item is not None:
            self.call(item)
            with self.lock:
                self.idle += 1
            item = self.work.get()

    def stop(self):
        """Ends the idle threads; one still waiting on its reply ends with the process."""
        with self.lock:
            n, self.idle = self.idle, 0
        for _ in range(n):
            self.work.put(None)


def open_loop(submit, pool: np.ndarray, sched, keep=(), settle_s: float = 60.0):
    """Send ``sched``'s requests at their due times, each through a caller
    thread of its own. -> (records, lag, callers, cpu): per request (latency
    s, reply s from the start, ok, output if kept), None for one that failed
    or never came within ``settle_s`` of the last due time; how late the
    sender handed each request over; how many caller threads it took; and
    ``thread_cpu()`` once every reply came, before the callers end."""
    keep = set(keep)
    records = [None] * len(sched)
    left, all_done = [len(sched)], threading.Event()
    lock = threading.Lock()

    def call(i):
        due, n, ofs = sched[i]
        try:
            out = submit(pool[ofs:ofs + n])
            t = time.perf_counter() - start
            records[i] = (t - due, t, out.shape == (n, 51), out if i in keep else None)
        except Exception:  # a refused or failed request
            pass
        with lock:
            left[0] -= 1
            if not left[0]:
                all_done.set()

    callers = Callers(call)
    lag = []
    if not sched:
        all_done.set()
    start = time.perf_counter()
    for i, (due, _, _) in enumerate(sched):
        wait = due - (time.perf_counter() - start)
        if wait > 0:
            time.sleep(wait)
        lag.append(time.perf_counter() - start - due)
        callers.put(i)
    all_done.wait(timeout=settle_s)
    cpu = thread_cpu()
    callers.stop()
    return ([r if r is not None and r[2] else None for r in records], lag, len(callers.threads),
            cpu)


def closed_loop(submit, pool: np.ndarray, reqs, callers: int, seconds: float, keep=(),
                settle_s: float = 60.0):
    """``callers`` threads, each sending the next request of ``reqs`` as
    soon as its own reply came, until ``seconds`` have passed. -> (records,
    sent, CPU seconds of the caller threads): records as ``open_loop``'s,
    the latency from when the request was sent; ``sent``, how many of
    ``reqs`` went out."""
    keep = set(keep)
    records = [None] * len(reqs)
    nxt, cpu, lock = [0], [], threading.Lock()

    def caller():
        while True:
            with lock:
                i = nxt[0]
                if i >= len(reqs) or time.perf_counter() - start >= seconds:
                    break
                nxt[0] += 1
            _, n, ofs = reqs[i]
            sent = time.perf_counter() - start
            try:
                out = submit(pool[ofs:ofs + n])
                t = time.perf_counter() - start
                records[i] = (t - sent, t, out.shape == (n, 51), out if i in keep else None)
            except Exception:  # a refused or failed request
                pass
        with lock:
            cpu.append(time.thread_time())

    threads = [threading.Thread(target=caller, daemon=True, name=f"{CALLER}-{k}")
               for k in range(callers)]
    start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=max(0.0, start + seconds + settle_s - time.perf_counter()))
    sent = nxt[0]
    return [r if r is not None and r[2] else None for r in records[:sent]], sent, sum(cpu)


def drive(co, spans, pool, mix: dict, seed: int, seconds: float, keep=(), what="window"):
    """The mix through the dispatcher for ``seconds``: an open loop at its
    rate, or a closed loop of its callers. -> (requests as (due, size,
    offset), records, a note, CPU seconds by thread)."""
    cpu0, proc0 = thread_cpu(), time.process_time()
    if "callers" in mix:
        reqs = [(0.0, n, ofs) for n, ofs in
                traffic.sequence(mix, seed, mix["max_requests"], what)]
        records, sent, caller_cpu = closed_loop(co.submit, pool, reqs, mix["callers"], seconds,
                                                keep, mix["settle_s"])
        cpu = cpu_by_thread(cpu0, thread_cpu(), spans.thread)
        cpu["callers"] = caller_cpu
        note = f"closed loop of {mix['callers']} callers"
        reqs = reqs[:sent]
    else:
        reqs = traffic.schedule(mix, seed, seconds, what)
        records, lag, n_callers, cpu1 = open_loop(co.submit, pool, reqs, keep,
                                                  mix["settle_s"])
        cpu = cpu_by_thread(cpu0, cpu1, spans.thread)
        note = (f"open loop offering {traffic.mean_poses_per_s(mix):.1f} poses/s, sender "
                f"lag p95 {sorted(lag)[int(0.95 * (len(lag) - 1))] * 1e3 if lag else 0.0:.3f}"
                f" ms, {n_callers} caller threads")
    cpu["process"] = time.process_time() - proc0
    return reqs, records, note, cpu


def thread_cpu() -> dict:
    """{thread ident: (name, CPU seconds)} of the process's Python threads."""
    out = {}
    for t in threading.enumerate():
        try:
            out[t.ident] = (t.name, time.clock_gettime(time.pthread_getcpuclockid(t.ident)))
        except (AttributeError, OSError, TypeError, ValueError):
            pass
    return out


def cpu_by_thread(before: dict, after: dict, dispatcher) -> dict:
    """CPU seconds between two ``thread_cpu`` readings: the dispatcher's
    thread, the caller threads, the sender (the main thread)."""
    def delta(ident):
        return after[ident][1] - before.get(ident, (None, 0.0))[1]

    main = threading.main_thread().ident
    return {"dispatcher": delta(dispatcher) if dispatcher in after else None,
            "callers": sum(delta(i) for i, (name, _) in after.items()
                           if name.startswith(CALLER)),
            "sender": delta(main) if main in after else None}


def reference_gaps(sds: dict, cell, pool: np.ndarray, sched, records, sample, device,
                   prod=ref.F32) -> float:
    """The widest gap over ``sample`` between a request's reply and the
    reference's lift of its poses, against its largest value."""
    sv = cell.config["serve"]
    worst = 0.0
    with torch.no_grad():
        for i in sample:
            _, n, ofs = sched[i]
            x = torch.from_numpy(pool[ofs:ofs + n]).to(device)
            want = ref.lift(sds, x, sv["depth"], sv["choice"], prod)
            got = torch.from_numpy(records[i][3]).to(device)
            worst = max(worst, float((got - want).abs().max() / want.abs().max()))
    return worst


def choose_sample(mix: dict, seed: int, seconds: float) -> list[int]:
    """``check_requests`` requests drawn from the seed, and the longest:
    among those due in the window (an open loop), or among the first
    ``check_span`` that the callers send (a closed loop)."""
    if "callers" in mix:
        reqs = [(0.0, n, o) for n, o in traffic.sequence(mix, seed, mix["check_span"])]
    else:
        reqs = traffic.schedule(mix, seed, seconds)
    rng = np.random.default_rng(core.derive(seed, "sample"))
    k = min(mix["check_requests"], len(reqs))
    pick = set(rng.choice(len(reqs), size=k, replace=False).tolist())
    pick.add(max(range(len(reqs)), key=lambda i: reqs[i][1]))
    return sorted(pick)


def percentile_ms(lat: list, q: float) -> float:
    """The ``q`` quantile (nearest rank) of sorted latencies, in ms."""
    return float(lat[math.ceil(q * len(lat)) - 1]) * 1e3 if lat else math.inf


def run(cell, seed: int, seconds: float, traced: bool, device, clock: dict) -> core.Outcome:
    """One run; sets ``clock['window_start']`` (host clock) when the window opens."""
    from links_tpu_torch.ops import resblock as K1

    mix = cell.traffic
    prog = build(cell, seed, device)
    co, spans, pool = prog["coalescer"], prog["spans"], prog["pool"]
    sample = choose_sample(mix, seed, seconds)
    stats0 = dict(co.stats)
    clock["window_start"] = time.perf_counter()
    sched, records, note, cpu = drive(co, spans, pool, mix, seed, seconds, keep=sample)
    stats = {k: co.stats[k] - stats0[k] for k in stats0}
    failed = sum(r is None for r in records)
    lat = sorted(r[0] for r in records if r is not None)
    poses_in_window = sum(sched[i][1] for i, r in enumerate(records)
                          if r is not None and r[1] <= seconds)
    e2e = {"lift_poses_per_s": poses_in_window / seconds,
           "lift_p50_ms": percentile_ms(lat, 0.50), "lift_p95_ms": percentile_ms(lat, 0.95)}
    readings = {"config": cell.config, "window_s": seconds, "coalescer": stats,
                "poses": poses_in_window, "flops_per_pose": flops.lift_flops(cell.config, 1)}
    notes = [f"requests {len(sched)}, answered {len(lat)}, latency p50 "
             f"{e2e['lift_p50_ms']:.3f} ms p95 {e2e['lift_p95_ms']:.3f} ms p99 "
             f"{percentile_ms(lat, 0.99):.3f} ms, returned {e2e['lift_poses_per_s']:.1f} "
             f"poses/s; {note}",
             "host CPU seconds in the window and its drain: " + ", ".join(
                 f"{k} {v:.4f}" for k, v in cpu.items() if v is not None)]
    tr = None
    if traced:
        before, rows0 = K1.res_block_forward.f32_launches, len(spans.rows)
        kern0 = K1.res_block_forward.kernel_launches
        tr = trace.traced(lambda: drive(co, spans, pool, mix, seed, mix["trace_s"],
                                        what="trace"))
        rows = spans.rows[rows0:]
        per_call = 7 * len(cell.config["lifters"])
        readings.update(trace=tr, counters={"forward": K1.res_block_forward.f32_launches
                                            - before,
                                            "kernels": K1.res_block_forward.kernel_launches
                                            - kern0},
                        k1_calls=[("forward", r, per_call, False) for r in rows])
    co.close()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    sds = prog["sds"]
    del prog, co, spans
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref.full_f32()
    kept = [i for i in sample if i < len(records) and records[i] is not None]
    value = (reference_gaps(sds, cell, pool, sched, records, kept, device)
             if len(kept) == len(sample) else math.inf)
    checks = [core.Check("lift_gap", value, cell.limits["lift_gap"])]
    return core.Outcome(attempted=len(sched), failed=failed, end_to_end=e2e,
                        readings=readings, checks=checks, memory_peak_bytes=peak, trace=tr,
                        notes=notes)


def calibrate(cell, seed: int, device, control: bool, seconds: float = 3.0) -> dict:
    """The readings behind the limit, for one seed: ``lift_gap`` of a short
    window at the cell's load; with ``control``, the gap of the reference
    computed with TF32 products against the f32 reference on the same
    sample."""
    mix = cell.traffic
    prog = build(cell, seed, device)
    co, pool, sds = prog["coalescer"], prog["pool"], prog["sds"]
    sample = choose_sample(mix, seed, seconds)
    sched, records, _, _ = drive(co, prog["spans"], pool, mix, seed, seconds, keep=sample)
    co.close()
    del prog, co
    ref.full_f32()
    out = {"program": {"lift_gap": reference_gaps(sds, cell, pool, sched, records, sample,
                                                  device)}}
    if control:
        sv = cell.config["serve"]
        with torch.no_grad():
            for i in sample:
                _, n, ofs = sched[i]
                x = torch.from_numpy(pool[ofs:ofs + n]).to(device)
                rec = records[i]
                records[i] = rec[:3] + (ref.lift(sds, x, sv["depth"], sv["choice"],
                                                 ref.TF32).cpu().numpy(),)
        out["control_tf32"] = {"lift_gap": reference_gaps(sds, cell, pool, sched, records,
                                                          sample, device)}
    return out
