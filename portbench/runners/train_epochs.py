"""Training cells: the trainers' epoch loop (``train/loop.py:run_epoch``) over
the port's own step (``train/steps.py``), as the stage-3a and stage-4
trainers build it, on a pool of seeded poses on the device.

Set-up makes the weights and the pool from the seed, builds one step with
its model and Adam state, and drives it through one epoch, whose first three
steps are recorded for the check. The window then runs whole epochs until
``--seconds`` have passed; each epoch reads its loss means back once, as the
trainers do, so the host dispatches ahead within an epoch. With
``--trace 1`` one more epoch runs under the profiler.

``correct``: the plain reference (``reference/model.py``, f32) follows the
first three steps from the same weights, rows and draws. Compared (the
cell's file names which): the norm of each leaf's first gradient as Adam
took it (the program's from its first moment after one step), by its worst
leaf; the norm of each leaf's change after three steps, by its worst leaf
and its median leaf. The losses are recorded, not compared: a step's loss
is one signed sum whose gap swings from seed to seed past what separates
the control, and after an Adam step (about lr times the sign of each
gradient) the later losses follow the signs of near-zero gradients, not the
precision of the products (PERF.md gives the readings).
"""

from __future__ import annotations

import functools
import math
import statistics
import time

import torch

from portbench import core, data, flops, trace, weights
from portbench.reference import draws
from portbench.reference import model as ref

B1 = 0.9  # Adam's first-moment decay: the first moment after one step is (1 - B1) g


def _weights(config: dict, seed: int, device) -> dict:
    """{model: state dict} of a configuration, from the seed, on ``device``."""
    h = config["hidden"]
    g = torch.Generator(device).manual_seed(core.derive(seed, "weights"))
    if config["stage"] == "left_right":
        linears = {side: weights.lifter_linears(j, h) for side, j in config["lifters"].items()}
        linears.update({name: weights.flow_linears(dim, config["flow_blocks"],
                                                   config["flow_hidden"])
                        for name, dim in config["flows"].items()})
        sds = weights.draw_linears(linears, g)
        for name, dim in config["flows"].items():
            weights.add_flow_buffers(sds[name], dim, config["flow_blocks"], g)
        return sds
    linears = {f"lifter_{part}": weights.lifter_linears(j, h)
               for part, j in config["lifters"].items()}
    linears.update({name: weights.completer_linears(i, o, h)
                    for name, (i, o) in config["completers"].items()})
    return weights.draw_linears(linears, g)


def trained_models(config: dict) -> list[str]:
    return list(config["lifters"]) if config["stage"] == "left_right" \
        else list(config["completers"])


class StepSpans:
    """The benchmark's span around each step call (host seconds, no
    synchronise), and the record of the first three steps: each loss, the
    first moments after step 1, the parameters after step 3."""

    def __init__(self, step):
        self.step, self.calls, self.host_s = step, 0, 0.0
        self.losses, self.mu1, self.p3 = [], None, None

    def __call__(self, state, batch, step_draws):
        with trace.span("step"):
            t0 = time.perf_counter()
            aux = self.step(state, batch, step_draws)
            self.host_s += time.perf_counter() - t0
        self.calls += 1
        if self.calls <= 3:
            self.losses.append(aux["loss"].detach().clone())
            if self.calls == 1:
                self.mu1 = [m.detach().clone() for m in state.opt.mu]
            if self.calls == 3:
                self.p3 = [p.detach().clone() for p in state.model.parameters()]
        return aux


def build(cell, seed: int, device, batch: int | None = None):
    """The program's step, state and feed for ``cell``; -> a dict."""
    from links_tpu_torch import flows as port_flows
    from links_tpu_torch.config import LifterTrainConfig, OcclusionTrainConfig, OptimConfig
    from links_tpu_torch.models.completers import Completers
    from links_tpu_torch.models.lifters import Lifter, StackedLifter
    from links_tpu_torch.objectives.lifter import LifterFrozen
    from links_tpu_torch.train import steps
    from links_tpu_torch.train.optim import Adam

    config, tc = cell.config, cell.config["train"]
    batch = batch or cell.traffic["batch"]
    h = config["hidden"]
    sds = _weights(config, seed, device)

    def module(make, sd):
        with torch.device("meta"):
            m = make()
        m.load_state_dict(weights.clone(sd), strict=True, assign=True)
        return m

    optim = OptimConfig(learning_rate=tc["learning_rate"], weight_decay=tc["weight_decay"],
                        lr_gamma=tc["lr_gamma"], clip_grad_norm=tc["clip_grad_norm"],
                        bf16_moments=tc["adam_moments"] == "bf16")
    bf16 = tc["precision"] == "bf16"
    if config["stage"] == "left_right":
        frozen = LifterFrozen(*(module(functools.partial(port_flows.Flow, config["flows"][n],
                                                         config["flow_blocks"],
                                                         config["flow_hidden"]),
                                       sds[n]).requires_grad_(False)
                                for n in ("full_flow", "flow_left", "flow_right")))
        model = StackedLifter(*(module(functools.partial(Lifter, config["lifters"][s], h), sds[s])
                                for s in ("left", "right")))
        cfg = LifterTrainConfig(batch_size=batch, depth=tc["depth"], weight_bl=tc["weight_bl"],
                                weight_2d=tc["weight_2d"], weight_3d=tc["weight_3d"],
                                weight_velocity=tc["weight_velocity"],
                                weight_likeli=tc["weight_likeli"],
                                noise_factor=tc["noise_factor"], nll_cap=tc["nll_cap"],
                                optim=optim, bf16=bf16)
        means = torch.tensor(ref.BONE_MEANS[tc["bone_means"]], dtype=torch.float32,
                             device=device)
        step = steps.build_left_right_step(frozen, cfg, means)

        def draw(g, b, dev):
            return steps.StepDraws(*draws.left_right(g, b, dev))
    else:
        legs, torso = (module(functools.partial(Lifter, config["lifters"][p], h),
                              sds[f"lifter_{p}"]).requires_grad_(False) for p in ("legs", "torso"))
        model = module(functools.partial(Completers, h),
                       {f"{n}.{k}": v for n in config["completers"] for k, v in sds[n].items()})
        cfg = OcclusionTrainConfig(batch_size=batch, depth=tc["depth"], n_rot=tc["n_rot"],
                                   input_noise=0.0, optim=optim, bf16=bf16)
        step = steps.build_occlusion_step(legs, torso, cfg)

        def draw(g, b, dev):
            return steps.OcclusionDraws(draws.occlusion(g, b, dev, tc["n_rot"]), None)

    pool_batches = cell.traffic["pool_batches"]
    state = steps.TrainState(model, Adam(model.parameters(), optim, pool_batches))
    pool = data.train_poses(pool_batches * batch,
                            torch.Generator(device).manual_seed(core.derive(seed, "data")))
    gen = torch.Generator(device).manual_seed(core.derive(seed, "steps"))
    return {"state": state, "step": StepSpans(step), "draw": draw, "pool": pool, "gen": gen,
            "batch": batch, "sds": sds}


def epoch(prog: dict) -> dict:
    from links_tpu_torch.train import loop

    return loop.run_epoch(prog["step"], prog["state"], prog["pool"], prog["batch"], prog["gen"],
                          draw=prog["draw"])


def k1_counters() -> dict:
    from links_tpu_torch.ops import resblock as K1

    return {"forward": K1.res_block_forward.launches,
            "forward_f32": K1.res_block_forward.f32_launches,
            "backward": K1.res_block_backward.launches,
            "backward_f32": K1.res_block_backward.f32_launches,
            "kernels": K1.res_block_forward.kernel_launches
            + K1.res_block_backward.kernel_launches}


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


# -- the reference and the comparison -------------------------------------------------------

def reference_steps(cell, seed: int, device, sds: dict, pool, batch: int,
                    prod=ref.F32, half: bool = False, n_steps: int = 3) -> dict:
    """The reference's first ``n_steps`` steps from the benchmark's weights,
    rows and draws. ``half``: a planted fault, each step's loss over the
    first half of its batch. -> {'losses', 'grad1' (leaf -> gradient as
    Adam took it), 'params' (leaf -> after the last step)}."""
    config, tc = cell.config, cell.config["train"]
    trained = trained_models(config)
    params = {f"{m}.{k}": v.detach().clone().requires_grad_(True)
              for m in trained for k, v in sds[m].items()}
    models = {m: {k: params[f"{m}.{k}"] for k in sds[m]} for m in trained}
    frozen = {m.removeprefix("lifter_"): sds[m] for m in sds if m not in trained}
    g = torch.Generator(device).manual_seed(core.derive(seed, "steps"))
    rows = draws.epoch_rows(g, pool.shape[0], batch, device)
    adam = ref.Adam(params, tc, cell.traffic["pool_batches"])
    losses, grad1 = [], None
    for s in range(n_steps):
        b = pool[rows[s * batch:(s + 1) * batch]]
        k = batch // 2 if half else batch
        if config["stage"] == "left_right":
            eps, u, e = draws.left_right(g, batch, device)
            if half:
                u = torch.cat([u[:k], u[batch:batch + k]])
                e = torch.cat([e[:k], e[batch:batch + k]])
            loss = ref.left_right_loss(models, frozen, b[:k], (eps[:k], u, e), tc, prod)
        else:
            u_rot = draws.occlusion(g, batch, device, tc["n_rot"])
            loss = ref.occlusion_loss(models, frozen, b[:k], u_rot[:, :k], tc, prod)
        grads = torch.autograd.grad(loss, list(params.values()))
        taken = adam.step(params, dict(zip(params, grads)))
        losses.append(float(loss.detach()))
        if s == 0:
            grad1 = {n: t.detach().clone() for n, t in taken.items()}
    return {"losses": losses, "grad1": grad1,
            "params": {n: p.detach() for n, p in params.items()}}


def compare(prog: dict, refr: dict, sds: dict) -> dict:
    """The numbers of the program's first three steps (``prog``: 'losses',
    'grad1', 'params', as ``reference_steps`` gives them) against the
    reference's. Each leaf's gap of norms is taken against the reference's
    norm of that leaf or of the median leaf, whichever is larger; the change
    leaves out leaves whose reference gradient is under a thousandth of the
    median leaf's (they move by round-off alone). A cell's file names the
    numbers it checks."""
    norm = lambda t: float(torch.linalg.vector_norm(t.float()))  # noqa: E731
    g_ref = {n: norm(t) for n, t in refr["grad1"].items()}
    g_med = statistics.median(g_ref.values())
    grad = [abs(norm(prog["grad1"][n]) - g_ref[n]) / max(g_ref[n], g_med) for n in g_ref]
    p0 = {f"{m}.{k}": v for m, sd in sds.items() for k, v in sd.items()}
    kept = [n for n in g_ref if g_ref[n] >= 1e-3 * g_med]
    d_ref = {n: norm(refr["params"][n] - p0[n]) for n in kept}
    d_med = statistics.median(d_ref.values())
    change = [abs(norm(prog["params"][n] - p0[n]) - d_ref[n]) / max(d_ref[n], d_med)
              for n in kept]
    return {"loss1_gap": core.gap(prog["losses"][0], refr["losses"][0]),
            "grad_gap": max(grad), "change_gap": max(change),
            "change_med_gap": statistics.median(change)}


def matched_grad1(cell, seed: int, device, sds: dict, pool, batch: int, prod=ref.BF16,
                  half: bool = False) -> dict:
    """The first step's gradient as the configuration's own precision gives
    it (the reference's first step with ``prod``, bf16 products by
    default), in the form the program's record holds it: through Adam's
    first moment, rounded to bf16 where the configuration keeps the moments
    in bf16. ``half``: the planted fault, as in ``reference_steps``."""
    g1 = reference_steps(cell, seed, device, sds, pool, batch, prod=prod, half=half,
                         n_steps=1)["grad1"]
    if cell.config["train"]["adam_moments"] != "bf16":
        return g1
    return {n: ref.round_bf16(g * (1 - B1)) / (1 - B1) for n, g in g1.items()}


def grad_rel(prog_grad1: dict, matched: dict) -> dict:
    """The norm of the difference between the program's first gradient and
    the one at the configuration's own precision, by the worst leaf and the
    median leaf, each against max(that leaf's norm, the median leaf's norm).
    Unlike a gap of norms it sees which rows went into the step: half of a
    batch draws its gradient from the same law, but not the same gradient."""
    norm = lambda t: float(torch.linalg.vector_norm(t.float()))  # noqa: E731
    g_ref = {n: norm(t) for n, t in matched.items()}
    g_med = statistics.median(g_ref.values())
    rel = {n: norm(prog_grad1[n].float() - matched[n].float()) / max(g_ref[n], g_med)
           for n in g_ref}
    worst = max(rel, key=rel.get)
    return {"grad_rel": rel[worst], "grad_rel_med": statistics.median(rel.values()),
            "grad_rel_leaf": worst}


def later_losses(prog: dict, refr: dict) -> list:
    """The gaps of the later steps' losses (not compared; for the record)."""
    return [core.gap(a, b) for a, b in zip(prog["losses"][1:], refr["losses"][1:])]


def program_record(prog: dict) -> dict:
    """The program's first three steps in ``reference_steps``' form."""
    names = [n for n, _ in prog["state"].model.named_parameters()]
    rec = prog["step"]
    return {"losses": [float(x) for x in rec.losses],
            "grad1": {n: m.float() / (1 - B1) for n, m in zip(names, rec.mu1)},
            "params": dict(zip(names, rec.p3))}


# -- one run --------------------------------------------------------------------------------

def run(cell, seed: int, seconds: float, traced: bool, device, clock: dict) -> core.Outcome:
    """One run; sets ``clock['window_start']`` (host clock) when the window opens."""
    from links_tpu_torch.cli import _common as C

    C.resolve_device(str(device))  # as the trainers: f32 matmuls stay f32 on the card
    prog = build(cell, seed, device)
    epoch(prog)  # the recorded first steps and the warm-up: one whole epoch
    batch, rec = prog["batch"], prog["step"]
    record = program_record(prog)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    calls0, host0 = rec.calls, rec.host_s
    t0 = clock["window_start"] = time.perf_counter()
    ends, finite = [], True
    while True:
        means = epoch(prog)
        ends.append(time.perf_counter() - t0)
        finite = finite and all(math.isfinite(v) for v in means.values())
        if ends[-1] >= seconds:
            break
    window_s = ends[-1]
    steps_done = rec.calls - calls0
    readings = {"config": cell.config, "batch": batch, "window_s": window_s,
                "steps": steps_done, "host_step_s": rec.host_s - host0,
                "flops_per_step": flops.train_step_flops(cell.config, batch)}
    tr = None
    if traced:
        before, calls1 = k1_counters(), rec.calls
        tr = trace.traced(lambda: epoch(prog))
        n = rec.calls - calls1
        readings.update(trace=tr, counters=_delta(k1_counters(), before),
                        k1_calls=[(d, rows, calls * n, cell.config["train"]["precision"] == "bf16")
                                  for d, rows, calls in flops.k1_calls_per_step(cell.config,
                                                                                batch)])
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    sds, pool = prog["sds"], prog["pool"]
    del prog, rec
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref.full_f32()
    refr = reference_steps(cell, seed, device, sds, pool, batch)
    numbers = compare(record, refr, sds)
    numbers.update(grad_rel(record["grad1"], matched_grad1(cell, seed, device, sds, pool, batch)))
    checks = [core.Check(name, numbers[name], limit) for name, limit in cell.limits.items()]
    # the rate, under the training cell's own end-to-end name
    rate = steps_done * batch / window_s
    e2e = {m["name"]: rate for m in cell.end_to_end if m["name"].endswith("train_poses_per_s")}
    epoch_s = [b - a for a, b in zip([0.0] + ends, ends)]
    notes = ["epoch seconds in the window: " + " ".join(f"{x:.4f}" for x in epoch_s)]
    return core.Outcome(attempted=steps_done, failed=0 if finite else steps_done,
                        end_to_end=e2e, readings=readings, checks=checks,
                        memory_peak_bytes=peak, trace=tr, notes=notes)


def calibrate(cell, seed: int, device, control: bool) -> dict:
    """The readings behind the limits, for one seed: the program's numbers
    (set-up and its recorded first steps, as a run makes them); with
    ``control``, those of the reference computed in fp8 in the program's
    place, and of the reference with half of each batch left out."""
    from links_tpu_torch.cli import _common as C

    C.resolve_device(str(device))
    prog = build(cell, seed, device)
    epoch(prog)
    record, sds, pool, batch = program_record(prog), prog["sds"], prog["pool"], prog["batch"]
    del prog
    ref.full_f32()
    refr = reference_steps(cell, seed, device, sds, pool, batch)
    matched = matched_grad1(cell, seed, device, sds, pool, batch)
    sides = {"program": (record, record["grad1"])}
    if control:
        sides["control_fp8"] = (reference_steps(cell, seed, device, sds, pool, batch,
                                                prod=ref.FP8),
                                matched_grad1(cell, seed, device, sds, pool, batch,
                                              prod=ref.FP8))
        # the fault at the configuration's precision, as the program would run it
        sides["fault_half_batch"] = (reference_steps(cell, seed, device, sds, pool, batch,
                                                     half=True),
                                     matched_grad1(cell, seed, device, sds, pool, batch,
                                                   half=True))
    return {k: dict(compare(v, refr, sds), **grad_rel(g1, matched),
                    later_loss_gaps=later_losses(v, refr))
            for k, (v, g1) in sides.items()}
