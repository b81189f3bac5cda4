"""Serving cells: the port's ``CSMServer`` under the traffic file's load.

Set-up makes the weights and the codec on the card from the seed, builds
only the configuration's bundles and warms the server on every prompt bucket
the traffic sends (so every kernel is built and loaded, every slot has its
codec stream).  The window then offers the requests open loop (each due at
its time, whether or not the server keeps up) or closed loop (each client
sends its next request when its last one finished), calling ``submit`` and
``step`` from one thread.  Each call ends in a host read of the frames (and,
with a codec, of their PCM), so a frame's time is its call's return.

After the window: the device's peak memory, then the program's state freed,
then the check: a sample of the finished greedy and sampled requests, drawn
from the seed with the longest of each kind among them, whose every served
token is judged by the reference's logits (a greedy token against the
reference's best, a sampled one against its top k), and their PCM by the
reference's Mimi decode.
"""

from __future__ import annotations

import time
from collections import deque
from contextlib import ExitStack
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import traffic as gen
from benchmark import trace as tr
from benchmark import weights, yardstick
from benchmark.reference import csm as ref_csm
from benchmark.reference import mimi as ref_mimi

BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)


def bucket(n: int, cap: int) -> int:
    return min(next((b for b in BUCKETS if n <= b), n), cap)


def bundles(params, cfg, tier: str) -> dict:
    """The configuration's tier and nothing more: ``int4`` is what
    ``CSMModel.quantize(bits=4)`` serves (the int4 backbone step and the fused
    int8 codebook loop with a bf16 head; no W8A16 bundle, which only batches
    above 32 use), ``exact`` what ``CSMModel.exact()`` serves."""
    from csm_tpu_torch.ops.bb_kernel import prepare_streamed_backbone
    from csm_tpu_torch.ops.fused_decoder import prepare_fused_decoder

    if tier == "int4":
        return dict(qsb=prepare_streamed_backbone(params, cfg, bits=4),
                    qdec=prepare_fused_decoder(params, cfg, head_bits=16), specdec=False)
    if tier == "exact":
        return dict(qsb=prepare_streamed_backbone(params, cfg, bits=16),
                    qdec=prepare_fused_decoder(params, cfg, head_bits=8), specdec=True)
    raise ValueError(f"unknown tier {tier!r}")


def produced(server, rid: int) -> int:
    """Frames the server has emitted for a request so far."""
    if rid in server.results:
        return len(server.results[rid])
    return len(server._frames.get(rid, ()))


def request_flops(cfg, S: int, frames: int) -> float:
    """Model FLOPs of a request's prefill and ``frames`` frames: the prefill
    (whose last position is the first frame's backbone pass), then each
    frame's work, frame ``j`` attending ``S + j`` keys."""
    if frames == 0:
        return 0.0
    bb_pass = 2.0 * yardstick.layer_params(cfg.backbone)
    f = yardstick.prefill_flops(cfg, S) - bb_pass
    return f + sum(yardstick.frame_flops(cfg, S + j) for j in range(frames))


class Window:
    """The measured window's loop and its records."""

    def __init__(self, server, reqs, t: dict, clock: tr.Clock):
        self.server, self.reqs, self.t, self.clock = server, reqs, t, clock
        self.live: dict = {}
        self.records: list = []
        self.on_call = None  # called at each loop boundary (the profiler's switch)

    def _update(self, now: float) -> list:
        finished = []
        for rid, rec in list(self.live.items()):
            n = produced(self.server, rid)
            rec.times.extend([now] * (n - len(rec.times)))
            if rid in self.server.results:
                rec.finished = now
                del self.live[rid]
                finished.append(rec)
        return finished

    def _submit(self, r, due: float):
        with self.clock.span("call.submit"):
            rid = self.server.submit(r.ids[None], r.mask[None], seed=r.seed,
                                     max_new_frames=r.budget, greedy=r.greedy)
        rec = SimpleNamespace(req=r, rid=rid, due=due, times=[], finished=None)
        self.live[rid] = rec
        self.records.append(rec)
        return self._update(time.perf_counter())

    def _step(self):
        with self.clock.span("call.step"):
            self.server.step()
        return self._update(time.perf_counter())

    def run(self, seconds: float):
        t = self.t
        self.t0 = t0 = time.perf_counter()
        end = t0 + seconds
        if t["loop"] == "open":
            pending = deque(self.reqs)
            while True:
                now = time.perf_counter()
                if self.on_call:
                    self.on_call(now - t0)
                if now >= end:
                    break
                while pending and t0 + pending[0].due <= now:
                    r = pending.popleft()
                    self._submit(r, t0 + r.due)
                if self.server.active_slots:
                    self._step()
                elif pending:
                    time.sleep(max(0.0, min(t0 + pending[0].due, end) - time.perf_counter()))
                else:
                    time.sleep(max(0.0, end - time.perf_counter()))
        else:
            queue = deque(self.reqs)
            for _ in range(t["clients"]):
                self._submit(queue.popleft(), time.perf_counter())
            while True:
                now = time.perf_counter()
                if self.on_call:
                    self.on_call(now - t0)
                if now >= end:
                    break
                for _ in self._step():
                    if not queue:
                        queue.extend(self.reqs)
                    self._submit(queue.popleft(), time.perf_counter())
        self.t1 = time.perf_counter()


def setup(cell: dict, seed: int, seconds: float, trace: bool, dev) -> SimpleNamespace:
    """Weights, codec, the tier's bundles, the server, the run's requests, and
    the warm-up on every prompt bucket the requests use."""
    from csm_tpu_torch.codec.mimi import MimiCodec, MimiCodecConfig
    from csm_tpu_torch.config import CSMConfig
    from csm_tpu_torch.serving import CSMServer

    conf, t = cell["config"], cell["traffic"]
    cfg = CSMConfig.from_dict(conf["model"])
    params = weights.csm_params(cfg, seed, torch.bfloat16, dev)
    codec = mcfg = mimi_params = None
    if t["codec"]:
        mcfg = ref_mimi.config(conf["codec"])
        mimi_params = weights.mimi_decoder_params(mcfg, seed, dev)
        codec = MimiCodec(MimiCodecConfig(**{k: tuple(v) if isinstance(v, list) else v
                                             for k, v in conf["codec"].items()}),
                          mimi_params, device=dev)
    tier = bundles(params, cfg, conf["tier"])
    server = CSMServer(params, cfg, n_slots=t["slots"], window=t["window"],
                       temperature=t["temperature"], topk=t["topk"], codec=codec, **tier)
    reqs = gen.requests(t, cfg, seed, seconds)
    sizes = sorted({bucket(len(r.ids), server.window) for r in reqs})
    rng = np.random.default_rng(0)
    for i in range(max(t["slots"], len(sizes))):
        ids, mask = gen.prompt(cfg, sizes[i % len(sizes)], t, rng)
        server.submit(ids[None], mask[None], seed=i, max_new_frames=3, greedy=i % 2 == 0)
    server.run_until_idle()
    if trace:
        from torch.profiler import ProfilerActivity, profile

        # The profiler's first start pays its own set-up: here, not in the window.
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            server.submit(*(x[None] for x in gen.prompt(cfg, sizes[0], t, rng)), max_new_frames=2)
            server.run_until_idle()
    return SimpleNamespace(cfg=cfg, conf=conf, t=t, params=params, codec=codec, mcfg=mcfg,
                           mimi_params=mimi_params, tier=tier, server=server, reqs=reqs)


def run(cell: dict, seed: int, seconds: float, trace: bool, started: float,
        device: str = "cuda", control: bool = False) -> SimpleNamespace:
    """One run of a serving cell; ``device="cpu"`` (tests, tiny configs)
    takes the kernels' plain versions and reads no device memory.
    ``control`` also reads, on the same requests, the numbers of each of
    :func:`controls` (``out.control_checks``)."""
    from csm_tpu_torch.codec import streaming
    from csm_tpu_torch.serving import CSMServer

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    s = setup(cell, seed, seconds, trace, dev)
    t, cfg = s.t, s.cfg
    clock = tr.Clock()
    launches = tr.Launches(cfg)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    win = Window(s.server, s.reqs, t, clock)
    traced = {}
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        lo, hi = t["trace_start_s"], t["trace_start_s"] + t["trace_seconds"]

        def switch(elapsed):
            if "start" not in traced and elapsed >= lo:
                prof.start()
                launches.on = True
                traced["start"] = time.perf_counter()
            elif "start" in traced and "stop" not in traced and elapsed >= hi:
                traced["stop"] = time.perf_counter()
                prof.stop()
                launches.on = False

        win.on_call = switch
    setup_s = time.perf_counter() - started
    if trace:
        with ExitStack() as stack:
            stack.enter_context(tr.timed_method(clock, CSMServer, "_admit_request", "admit"))
            stack.enter_context(tr.timed_method(clock, streaming.StreamingMimiDecoder, "feed",
                                                "feed"))
            stack.enter_context(launches.installed())
            win.run(seconds)
        if "start" in traced and "stop" not in traced:
            traced["stop"] = time.perf_counter()
            prof.stop()
    else:
        win.run(seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    out = record(win, cfg, t, clock, setup_s)
    if "start" in traced:
        summary = tr.summarize(prof)
        calls = clock.durations("call.submit", traced["start"], traced["stop"]) + \
            clock.durations("call.step", traced["start"], traced["stop"])
        out.trace = dict(summary, window_s=traced["stop"] - traced["start"], span_s=sum(calls),
                         bounds_s=launches.bounds_s())
    sample = check_sample(win, t, seed)
    got = [(rec.req, s.server.results[rec.rid], s.server.audio.get(rec.rid)) for rec in sample]
    s.server = s.tier = s.codec = win = None
    if cuda:
        torch.cuda.empty_cache()
    args = (s.params, cfg, s.conf, t, s.mcfg, s.mimi_params, got)
    out.checks = check(*args)
    if control:
        out.control_checks = {c: check(*args, control=c, seed=seed)
                              for c in controls(s.conf["tier"])}
    out.peak = peak
    return out


def record(win: Window, cfg, t: dict, clock: tr.Clock, setup_s: float) -> SimpleNamespace:
    """What the metric readers read: per request its due time, its frames'
    times and whether it finished, all relative to the window's start; the
    window's length; the host spans; the model FLOPs of the frames made."""
    t0, t1 = win.t0, win.t1
    reqs, flops, frames = [], 0.0, 0
    for rec in win.records:
        times = [x - t0 for x in rec.times]
        reqs.append(dict(due=rec.due - t0, times=times, prompt=len(rec.req.ids),
                         finished=rec.finished is not None))
        frames += len(times)
        flops += request_flops(cfg, len(rec.req.ids), len(times))
    spans = {name: clock.durations(name) for name in clock.spans}
    return SimpleNamespace(kind="serve", window_s=t1 - t0, requests=reqs, frames=frames,
                           flops=flops, spans=spans, setup_s=setup_s, trace=None,
                           attempted=len(reqs), failed=0,
                           span_total_s=sum(spans.get("call.submit", []))
                           + sum(spans.get("call.step", [])))


def check_sample(win: Window, t: dict, seed: int) -> list:
    """The finished requests to check: ``t["check_requests"]`` greedy and
    ``t["check_sampled"]`` sampled ones, of each kind the longest, then
    others drawn from the seed."""
    out = []
    for greedy, n in ((True, t["check_requests"]), (False, t["check_sampled"])):
        done = [r for r in win.records if r.finished is not None and r.req.greedy == greedy]
        if not done or n < 1:
            continue
        done.sort(key=lambda r: (-len(r.times), r.req.index))
        rest = done[1:]
        rng = np.random.default_rng([seed, 1 if greedy else 2])
        pick = rng.permutation(len(rest))[:n - 1]
        out += [done[0]] + [rest[i] for i in sorted(pick)]
    return out


def controls(tier: str) -> tuple:
    """What ``check`` can put in the program's place: ``lower``, the
    reference one precision step below what the configuration states (int8
    for the exact tier; Mimi in TF32); for the exact tier also ``fp8`` and
    ``drafts``, its int8 decoder without the verify; ``no_topk``, the
    reference sampling without its top-k filter."""
    return ("lower", "fp8", "drafts", "no_topk") if tier == "exact" else ("lower", "no_topk")


def check(params, cfg, conf, t: dict, mcfg, mimi_params, got: list, control: str = None,
          seed: int = 0) -> list:
    """``[(name, value, limit, op)]`` over the checked requests ``got``
    (``(request, frames, PCM)``): ``checked_requests`` and, where the
    traffic samples, ``checked_sampled`` (at least one each);
    ``logit_gap``, the widest gap by which a greedy token's reference logit
    lies below the reference's best at its position, and where the
    configuration limits it ``logit_gap_mean``, the mean of those gaps over
    every greedy token; ``topk_gap``, the widest gap by which a sampled
    token's reference logit lies below the reference's ``topk``-th best;
    with a codec ``pcm_rel``, the largest relative RMS distance of a
    request's streamed PCM from the reference's decode of its codes.
    ``control`` (one of :func:`controls`) judges, in place of what the
    program served, the tokens that control picks at the same positions
    (greedy: its best; sampled: its own draw, seeded by ``seed``)."""
    lim = conf["limits"]
    greedy = [g for g in got if g[0].greedy]
    out = [("checked_requests", len(greedy), 1, ">=")]
    if t["check_sampled"]:
        out.append(("checked_sampled", len(got) - len(greedy), 1, ">="))
    if not got:
        return out
    dev = params["projection"].device
    w = ref_csm.serve_weights(params, cfg, conf["tier"])
    wc = {None: None, "no_topk": w, "lower": lambda: ref_csm.lower_precision(w, conf["tier"]),
          "fp8": lambda: ref_csm.lower_precision(w, conf["tier"], fn=ref_csm.fp8_dequant),
          "drafts": lambda: ref_csm.lower_precision(w, conf["tier"], parts=("decoder",))}[control]
    wc = wc() if callable(wc) else wc
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % 2 ** 63)
    best, topk, pcm = [], [], []
    for req, frames, audio in got:
        f = torch.as_tensor(frames, device=dev)
        ids, mask = torch.as_tensor(req.ids, device=dev), torch.as_tensor(req.mask, device=dev)
        ref = ref_csm.by_token(*ref_csm.served_logits(params, cfg, w, ids, mask, f))
        tokens = f
        if control:
            pick = ref if wc is w else ref_csm.by_token(
                *ref_csm.served_logits(params, cfg, wc, ids, mask, f))
            tokens = pick.argmax(dim=-1) if req.greedy else ref_csm.draw(
                pick, t["temperature"], None if control == "no_topk" else t["topk"], gen)
        if req.greedy:
            best.append(ref_csm.gaps_below_best(ref, tokens).flatten())
        else:
            topk.append(ref_csm.gaps_below_topk(ref, tokens, t["topk"]).flatten())
        if mcfg is not None and control in (None, "lower"):
            codes = f.T[None, :mcfg.num_quantizers]
            ref_pcm = ref_mimi.decode(mcfg, mimi_params, codes)[0]
            mine = (ref_mimi.decode(mcfg, mimi_params, codes, tf32=True)[0] if control
                    else torch.as_tensor(audio, device=dev))
            pcm.append(float((mine - ref_pcm).norm() / ref_pcm.norm()))
    if best:
        gaps = torch.cat(best)
        out.append(("logit_gap", float(gaps.max()), lim["logit_gap"], "<="))
        if "logit_gap_mean" in lim:
            out.append(("logit_gap_mean", float(gaps.mean()), lim["logit_gap_mean"], "<="))
    if topk:
        out.append(("topk_gap", float(torch.cat(topk).max()), lim["topk_gap"], "<="))
    if pcm:
        out.append(("pcm_rel", max(pcm), lim["pcm_rel"], "<="))
    return out
