"""Serving cells: the port's ``CSMServer`` under the traffic file's load.

Set-up makes the weights and the codec on the card from the seed, builds
only the configuration's bundles (all that depends on the model comes from
its family, ``families/<family>.py``), registers the traffic's shared
prefixes, if it has any (``"prefix_cache": false`` sends the same
conversations whole instead), and warms the server on every prompt bucket the
traffic sends, each from a prefix where the traffic's requests continue one
(so every kernel is built and loaded, every slot has its codec stream).  The
window then offers the requests open loop (each due at its time, whether or
not the server keeps up) or closed loop (each client sends its next request
when its last one finished: a session's next turn, or the next session),
calling ``submit`` and ``step`` from one thread.  Each call ends in a host
read of the frames (and,
with a codec, of their PCM), so a frame's time is its call's return.

After the window: the device's peak memory, then the program's state freed,
then the check: a sample of the finished greedy and sampled requests, drawn
from the seed with the longest of each kind among them, whose every served
token is judged by the reference's logits (a greedy token against the
reference's best, a sampled one against its top k), each teacher-forced
behind its whole context (a prefix and its continuation), and their PCM by
the reference's Mimi decode.  With prefixes, every admission in the window
has to start from one, and the served greedy tokens have to lie nearer the
reference behind their own prefix than behind another.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from contextlib import ExitStack
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import spec
from benchmark import traffic as gen
from benchmark import trace as tr
from benchmark import weights
from benchmark.reference import judge
from benchmark.reference import mimi as ref_mimi

BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)


def bucket(n: int, cap: int) -> int:
    return min(next((b for b in BUCKETS if n <= b), n), cap)


def produced(server, rid: int) -> int:
    """Frames the server has emitted for a request so far."""
    if rid in server.results:
        return len(server.results[rid])
    return len(server._frames.get(rid, ()))


class Window:
    """The measured window's loop and its records."""

    def __init__(self, server, reqs, t: dict, clock: tr.Clock, pids: list,
                 prefix_len: list = ()):
        self.server, self.reqs, self.t, self.clock = server, reqs, t, clock
        self.pids = list(pids)  # the registered prefixes' ids, by the requests' ``prefix``
        self.prefix_len = list(prefix_len)  # and their frames
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
                                     max_new_frames=r.budget, greedy=r.greedy,
                                     prefix_id=None if r.prefix is None else self.pids[r.prefix])
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
        self.stats0 = self.server.stats()
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
            order = gen.chains(self.reqs)
            queue = deque(order)
            rest = {}  # a live request's id -> the turns its session has left

            def send(chain):
                self._submit(chain[0], time.perf_counter())
                rest[self.records[-1].rid] = chain[1:]

            for _ in range(t["clients"]):
                send(queue.popleft())
            while True:
                now = time.perf_counter()
                if self.on_call:
                    self.on_call(now - t0)
                if now >= end:
                    break
                for rec in self._step():
                    chain = rest.pop(rec.rid)
                    if not chain:
                        if not queue:
                            queue.extend(order)
                        chain = queue.popleft()
                    send(chain)
        self.t1 = time.perf_counter()
        self.stats1 = self.server.stats()


def setup(cell: dict, seed: int, seconds: float, trace: bool, dev) -> SimpleNamespace:
    """Weights, codec, the tier's bundles, the server, its registered
    prefixes, the run's requests, and the warm-up on every prompt bucket the
    requests use."""
    from csm_tpu_torch.codec.mimi import MimiCodec, MimiCodecConfig
    from csm_tpu_torch.serving import CSMServer

    conf, t = cell["config"], cell["traffic"]
    fam = spec.family(conf)
    cfg = fam.config(conf["model"])
    params = weights.model_params(fam, cfg, seed, torch.bfloat16, dev)
    codec = mcfg = mimi_params = None
    if t["codec"]:
        mcfg = ref_mimi.config(conf["codec"])
        mimi_params = weights.mimi_decoder_params(mcfg, seed, dev)
        codec = MimiCodec(MimiCodecConfig(**{k: tuple(v) if isinstance(v, list) else v
                                             for k, v in conf["codec"].items()}),
                          mimi_params, device=dev)
    tier = fam.bundles(params, cfg, conf["tier"])
    server = CSMServer(params, cfg, n_slots=t["slots"], window=t["window"],
                       temperature=t["temperature"], topk=t["topk"], codec=codec, **tier)
    prefixes = gen.prefixes(t, cfg, seed)
    reqs = gen.requests(t, cfg, seed, seconds)
    if not t.get("prefix_cache", True):
        # The same conversations sent whole: no prefix is registered.
        reqs = [dataclasses.replace(r, ids=c[0], mask=c[1], prefix=None)
                for r, c in ((r, context(r, prefixes)) for r in reqs)]
        prefixes = []
    pids = [server.register_prefix(ids[None], mask[None]) for ids, mask in prefixes]
    sizes = sorted({bucket(len(r.ids), server.window) for r in reqs})
    rng = np.random.default_rng(0)

    def warm(i: int, size: int, frames: int, **kw):
        ids, mask = gen.segments(cfg, [(size // 8, size - size // 8)], t, rng)
        server.submit(ids[None], mask[None], max_new_frames=frames,
                      prefix_id=pids[i % len(pids)] if pids else None, **kw)

    for i in range(max(t["slots"], len(sizes))):
        warm(i, sizes[i % len(sizes)], 3, seed=i, greedy=i % 2 == 0)
    server.run_until_idle()
    if trace:
        from torch.profiler import ProfilerActivity, profile

        # The profiler's first start pays its own set-up: here, not in the window.
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            warm(0, sizes[0], 2)
            server.run_until_idle()
    return SimpleNamespace(fam=fam, cfg=cfg, conf=conf, t=t, params=params, codec=codec,
                           mcfg=mcfg, mimi_params=mimi_params, tier=tier, server=server,
                           reqs=reqs, prefixes=prefixes, pids=pids,
                           prefix_len=[len(ids) for ids, _ in prefixes])


def run(cell: dict, seed: int, seconds: float, trace: bool, started: float,
        device: str = "cuda", control: bool = False) -> SimpleNamespace:
    """One run of a serving cell; ``device="cpu"`` (tests, tiny configs)
    takes the kernels' plain versions and reads no device memory.
    ``control`` also reads, on the same requests, the numbers of each of
    the family reference's ``controls`` (``out.control_checks``)."""
    from csm_tpu_torch.codec import streaming
    from csm_tpu_torch.serving import CSMServer

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    s = setup(cell, seed, seconds, trace, dev)
    t, cfg = s.t, s.cfg
    clock = tr.Clock()
    launches = tr.Launches(s.fam, cfg)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    win = Window(s.server, s.reqs, t, clock, s.pids, s.prefix_len)
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

    out = record(win, s.fam, cfg, t, clock, setup_s)
    if "start" in traced:
        summary = tr.summarize(prof)
        calls = clock.durations("call.submit", traced["start"], traced["stop"]) + \
            clock.durations("call.step", traced["start"], traced["stop"])
        out.trace = dict(summary, window_s=traced["stop"] - traced["start"], span_s=sum(calls),
                         bounds_s=launches.bounds_s())
    sample = check_sample(win, t, seed)
    got = [(rec.req, *context(rec.req, s.prefixes), s.server.results[rec.rid],
            s.server.audio.get(rec.rid)) for rec in sample]
    admits = prefix_admits(win) if s.pids else []
    s.server = s.tier = s.codec = win = None
    if cuda:
        torch.cuda.empty_cache()
    args = (s.fam, s.params, cfg, s.conf, t, s.mcfg, s.mimi_params, got, s.prefixes)
    out.checks = check(*args) + admits
    if control:
        out.control_checks = {c: check(*args, control=c, seed=seed)
                              for c in s.fam.reference.controls(s.conf["tier"])}
    out.peak = peak
    return out


def context(req, prefixes: list) -> tuple:
    """``(ids, mask)`` of the whole conversation a request's frames follow:
    its prefix, if it continues one, then its own prompt."""
    if req.prefix is None:
        return req.ids, req.mask
    ids, mask = prefixes[req.prefix]
    return np.concatenate([ids, req.ids]), np.concatenate([mask, req.mask])


def prefix_admits(win: Window) -> list:
    """The check that the window's admissions (not the set-up's warm-up)
    all started from a registered prefix: the rise in the server's
    ``prefix_prefills`` over the rise in its ``prefills``."""
    n = win.stats1["prefills"] - win.stats0["prefills"]
    hit = win.stats1["prefix_prefills"] - win.stats0["prefix_prefills"]
    return [("prefix_admits", hit / n if n else 0.0, 1.0, ">=")]


def record(win: Window, fam, cfg, t: dict, clock: tr.Clock, setup_s: float) -> SimpleNamespace:
    """What the metric readers read: per request its due time, its frames'
    times and whether it finished, all relative to the window's start; the
    window's length; the host spans; the model FLOPs of the frames made (a
    continuation's prefill attending its prefix, the prefix's own prefill
    not counted: it ran at set-up)."""
    t0, t1 = win.t0, win.t1
    reqs, flops, frames = [], 0.0, 0
    for rec in win.records:
        times = [x - t0 for x in rec.times]
        reqs.append(dict(due=rec.due - t0, times=times, prompt=len(rec.req.ids),
                         finished=rec.finished is not None))
        frames += len(times)
        prefix = 0 if rec.req.prefix is None else win.prefix_len[rec.req.prefix]
        flops += fam.request_flops(cfg, len(rec.req.ids), len(times), prefix)
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


def check(fam, params, cfg, conf, t: dict, mcfg, mimi_params, got: list, prefixes: list = (),
          control: str = None, seed: int = 0) -> list:
    """``[(name, value, limit, op)]`` over the checked requests ``got``
    (``(request, context ids, context mask, frames, PCM)``, the context
    being the whole conversation before the frames), judged by the
    family's reference ``fam.reference``: ``checked_requests`` and, where the
    traffic samples, ``checked_sampled`` (at least one each);
    ``logit_gap``, the widest gap by which a greedy token's reference logit
    lies below the reference's best at its position, and where the
    configuration limits it ``logit_gap_mean``, the mean of those gaps over
    every greedy token; ``topk_gap``, the widest gap by which a sampled
    token's reference logit lies below the reference's ``topk``-th best;
    with a codec ``pcm_rel``, the largest relative RMS distance of a
    request's streamed PCM from the reference's decode of its codes; with
    more than one registered prefix (``prefixes``, by the requests'
    ``prefix``) ``prefix_gap_share``, over the greedy requests the largest
    share that the mean gap behind the request's own prefix takes of itself
    plus the least mean gap behind another (served from the right prefix,
    its tokens lie nearer the reference behind that prefix than behind any
    other: near 0; from another prefix, near 1; 0.5 where the prefix does
    not tell).
    ``control`` (one of the reference's ``controls``) judges, in place of
    what the program served, the tokens that control picks at the same
    positions (greedy: its best; sampled: its own draw, seeded by
    ``seed``)."""
    lim = limits(conf, t)
    greedy = [g for g in got if g[0].greedy]
    out = [("checked_requests", len(greedy), 1, ">=")]
    if t["check_sampled"]:
        out.append(("checked_sampled", len(got) - len(greedy), 1, ">="))
    if not got:
        return out
    dev = params["projection"].device
    ref_model = fam.reference
    w = ref_model.serve_weights(params, cfg, conf["tier"])
    wc = ref_model.control_weights(w, conf["tier"], control) if control else None
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % 2 ** 63)
    best, topk, pcm, share = [], [], [], []
    for req, ids, mask, frames, audio in got:
        f = torch.as_tensor(frames, device=dev)
        ids, mask = torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev)
        ref = judge.by_token(*ref_model.served_logits(params, cfg, w, ids, mask, f))
        tokens = f
        if control:
            pick = ref if wc is w else judge.by_token(
                *ref_model.served_logits(params, cfg, wc, ids, mask, f))
            tokens = pick.argmax(dim=-1) if req.greedy else judge.draw(
                pick, t["temperature"], None if control == "no_topk" else t["topk"], gen)
        if req.greedy:
            best.append(judge.gaps_below_best(ref, tokens).flatten())
            if req.prefix is not None and len(prefixes) > 1:
                own = float(best[-1].mean())
                other = min(mean_gap_behind(ref_model, params, cfg, w, prefixes[q], req, f, tokens)
                            for q in range(len(prefixes)) if q != req.prefix)
                share.append(own / (own + other) if own + other else 0.5)
        else:
            topk.append(judge.gaps_below_topk(ref, tokens, t["topk"]).flatten())
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
    if share:
        out.append(("prefix_gap_share", max(share), lim["prefix_gap_share"], "<="))
    return out


def mean_gap_behind(ref_model, params, cfg, w, prefix: tuple, req, frames, tokens) -> float:
    """The mean gap below the reference's best of a greedy request's
    ``tokens``, teacher-forced behind ``prefix`` (``(ids, mask)``) and the
    request's own continuation."""
    dev = frames.device
    ids, mask = (torch.as_tensor(np.concatenate([p, r]), device=dev)
                 for p, r in zip(prefix, (req.ids, req.mask)))
    ref = judge.by_token(*ref_model.served_logits(params, cfg, w, ids, mask, frames))
    return float(judge.gaps_below_best(ref, tokens).mean())


def limits(conf: dict, t: dict) -> dict:
    """The configuration's limits and those the traffic adds for numbers
    only it has (a traffic may not restate a configuration's limit)."""
    extra = t.get("limits", {})
    if set(extra) & set(conf["limits"]):
        raise ValueError(f"the traffic restates limits {sorted(set(extra) & set(conf['limits']))}")
    return {**conf["limits"], **extra}
