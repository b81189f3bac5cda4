"""Training cells: the port's train step (``make_train_step``: gradient
accumulation, global-norm clipping, AdamW on the linear schedule, the flash
kernels forward and backward, remat) on full-context synthetic conversations.

Set-up makes the float32 master weights on the card from the seed, builds
the optimizer and the step, and drives that one object through its first
``check_steps`` steps on the window's own feed (the first builds and loads
every kernel); their losses, the first clipped gradient (from AdamW's first
moment after one step) and the parameters' change are kept for the check.
The same object then trains in the window, each step ending in a host read
of its loss.  After the window the program's state is freed and the
reference trains the same weights on the same batches for the same steps.
The model's config, shapes, reference and FLOPs come from its family
(``families/<family>.py``)."""

from __future__ import annotations

import statistics
import time
from types import SimpleNamespace

import torch

from benchmark import spec
from benchmark import traffic as gen
from benchmark import trace as tr
from benchmark import weights, yardstick
from benchmark.shapes import leaves


def straight_through(fn):
    """A cast for the reference's forward whose gradient is the identity,
    as the gradient through a dtype cast is."""
    return lambda w: w + (fn(w.detach()) - w.detach())


def fp8(w: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 e4m3, the control's precision below bf16."""
    s = w.abs().amax().clamp(min=1e-30) / 448.0
    return (w / s).to(torch.float8_e4m3fn).float() * s


def _opt(tc: dict):
    from csm_tpu_torch.train.loop import make_optimizer

    return make_optimizer(tc["lr"], tc["total_steps"], tc["warmup_steps"], tc["weight_decay"],
                          tc["max_grad_norm"])


def max_decoder_frames(t: dict) -> int:
    """The trainer's cap (``CSMTrainer._max_dec``): the amortized frames of
    the batch, plus one per row."""
    return (t["batch"] * t["seq_len"]) // t["amortization_ratio"] + t["batch"]


def program(cell: dict, seed: int, dev, fault=None):
    """The program's training object from the seed's weights, driven through
    its first ``check_steps`` steps; returns ``(step, state, readings)``.
    ``fault`` (the tests' and the control script's seam) maps ``(step_fn,
    state, batch)`` to ``(state, metrics)`` in place of the program's step."""
    from csm_tpu_torch.train.loop import flatten, make_train_step

    conf, t = cell["config"], cell["traffic"]
    fam = spec.family(conf)
    cfg = fam.config(conf["model"])
    params = weights.model_params(fam, cfg, seed, torch.float32, dev)
    state = _opt(conf["train"]).init(params)
    step_fn = make_train_step(cfg, _opt(conf["train"]), max_decoder_frames(t),
                              compute_dtype=torch.bfloat16, remat=True, remat_policy="auto")

    def step(i: int):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in gen.train_batch(cfg, t, seed, i).items()}
        if fault is not None:
            return fault(step_fn, state, batch)
        return step_fn(state, None, batch)

    named = flatten(state.params)
    readings = {"loss": [], "grad_norm": []}
    for i in range(t["check_steps"]):
        _, m = step(i)
        readings["loss"].append(float(m["loss"]))
        readings["grad_norm"].append(float(m["grad_norm"]))
        if i == 0:
            st = state.optimizer.state
            readings["grad"] = {n: float(st[p]["exp_avg"].norm()) / (1 - 0.9) if p in st else 0.0
                                for n, p in named.items()}
    with torch.no_grad():
        start = dict(leaves(weights.model_params(fam, cfg, seed, torch.float32, dev)))
        readings["change"] = {n: float((p - start[n]).norm()) for n, p in named.items()}
    return step, state, readings


def run(cell: dict, seed: int, seconds: float, trace: bool, started: float,
        device: str = "cuda", fault=None, control: bool = False) -> SimpleNamespace:
    """One run of a training cell (``fault``: see :func:`program`;
    ``control`` also reads the control's numbers, ``out.control_checks``)."""
    conf, t = cell["config"], cell["traffic"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    fam = spec.family(conf)
    cfg = fam.config(conf["model"])
    step, state, readings = program(cell, seed, dev, fault)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    clock = tr.Clock()
    prof = None
    traced = {}
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    setup_s = time.perf_counter() - started
    t0 = time.perf_counter()
    end = t0 + seconds
    i = t["check_steps"]
    steps = 0
    while time.perf_counter() < end:
        profiled = trace and steps == t["trace_after_steps"]
        if profiled:
            prof.start()
            traced["start"] = time.perf_counter()
        with clock.span("call.step"):
            _, m = step(i)
            float(m["loss"])
        if profiled:
            traced["stop"] = time.perf_counter()
            prof.stop()
        i += 1
        steps += 1
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    seqs = steps * t["accum"] * t["batch"]
    n_dec = (t["seq_len"] - t["n_text"]) // t["amortization_ratio"]
    spans = {name: clock.durations(name) for name in clock.spans}
    out = SimpleNamespace(kind="train", window_s=t1 - t0, sequences=seqs, steps=steps,
                          setup_s=setup_s, spans=spans, trace=None, attempted=seqs, failed=0,
                          span_total_s=sum(spans.get("call.step", [])),
                          flops=seqs * fam.train_sequence_flops(cfg, t["seq_len"], n_dec))
    if trace and "stop" in traced:
        summary = tr.summarize(prof)
        work = fam.flash_train_work(cfg, t["batch"], t["seq_len"])
        g = summary["groups"]
        bound = sum(g.get(k, [0, 0.0])[0] * yardstick.bound_s(*work[w])
                    for k, w in (("flash_fwd", "fwd"), ("flash_bwd_dq", "dq"),
                                 ("flash_bwd_dkv", "dkv")))
        out.trace = dict(summary, window_s=traced["stop"] - traced["start"],
                         span_s=clock.durations("call.step", traced["start"],
                                                traced["stop"])[0],
                         bounds_s={"flash": bound})
    del prof, state, step
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_readings(fam, cfg, conf, t, seed, dev,
                             straight_through(fam.reference.bf16_round))
    lim = conf["limits"]
    out.checks = [(k, v, lim[k], "<=") for k, v in compare(readings, ref).items()]
    if control:
        low = reference_readings(fam, cfg, conf, t, seed, dev, straight_through(fp8))
        out.control_checks = {"fp8": [(k, v, lim[k], "<=") for k, v in compare(low, ref).items()]}
    out.readings, out.reference = readings, ref
    out.peak = peak
    return out


def reference_readings(fam, cfg, conf, t, seed, dev, cast) -> dict:
    """The family reference's losses, pre-clip norms, first clipped
    gradient and change per leaf after ``check_steps`` steps from the
    seed's weights."""
    tc = conf["train"]
    flat = {n: p.requires_grad_(True)
            for n, p in leaves(weights.model_params(fam, cfg, seed, torch.float32, dev))}
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in gen.train_batch(cfg, t, seed, i).items()}
               for i in range(t["check_steps"])]
    opt = dict(lr=tc["lr"], total_steps=tc["total_steps"], warmup_steps=tc["warmup_steps"],
               weight_decay=tc["weight_decay"], max_grad_norm=tc["max_grad_norm"])
    return fam.reference.train_steps(flat, cfg, batches, opt, max_decoder_frames(t), cast)


def compare(got: dict, ref: dict) -> dict:
    """The numbers compared, each the worst over steps or leaves:
    ``loss_rel`` and ``gnorm_rel`` (the global norm before clipping) relative
    to the reference's; ``grad_rel`` and ``change_rel``, per leaf the gap
    between the program's norm and the reference's over the larger of the
    reference's norm of that leaf and of the median leaf.  Leaves whose
    reference gradient is under a thousandth of the median leaf's move by
    round-off alone and are left out of ``change_rel``."""
    def rel(a, b):
        return abs(a - b) / abs(b)

    out = {"loss_rel": max(rel(a, b) for a, b in zip(got["loss"], ref["loss"])),
           "gnorm_rel": max(rel(a, b) for a, b in zip(got["grad_norm"], ref["grad_norm"]))}
    med_g = statistics.median(ref["grad"].values())
    out["grad_rel"] = max(abs(got["grad"][n] - g) / max(g, med_g) for n, g in ref["grad"].items())
    moved = [n for n, g in ref["grad"].items() if g >= 1e-3 * med_g]
    med_c = statistics.median(ref["change"][n] for n in moved)
    out["change_rel"] = max(abs(got["change"][n] - ref["change"][n]) / max(ref["change"][n], med_c)
                            for n in moved)
    return out
