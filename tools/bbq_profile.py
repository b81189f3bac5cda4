#!/usr/bin/env python3
"""Profile one backbone decode step (K1 exact, K1q-8, K1q-4) on the card.

    python3 tools/bbq_profile.py [--repo DIR] [--label NAME] [--items]
    python3 tools/bbq_profile.py --compare P1,P2:C1,C2

Builds random CSM-1B weights (seed 0) in bf16, the ``bits=16``, ``bits=8``
and ``bits=4`` bundles, and at B = 1, 8 and 32 (W = 256, ~55 % of the
window usable; the exact tier takes B <= 8) times the step with CUDA events
and breaks one step down under ``torch.profiler``: device ms and launches
by kernel name, the step's span from its first kernel's start to its last
kernel's end, and the idle gaps inside that span.  Each reading carries a
digest of the step's outputs.  ``--repo`` imports ``csm_tpu_torch`` from
another checkout (a parent commit unpacked beside this one), so two
versions are read in one call.  ``--items`` also reads the persistent
kernel's per-item trace.  Prints one JSON object per reading; the whole
record goes to ``chiprun_out/bbq_profile_<label>.json``.

``--compare`` reads the records of labels P1, P2 (one version, e.g. the
parent, run first and last) and C1, C2 (the other, run between them) and
prints, for each tier and B, both mean times, their ratio and whether the
outputs are bitwise equal; it exits non-zero if a K1q-8 or K1q-4 reading
differs in its outputs or by more than 3 % in time.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys


def item_breakdown(bb_kernel, cfg, qsb, bits: int, step, B: int) -> dict:
    """µs per stage kind from the per-item trace, relative to the end of the
    previous layer's last down item (layer 0: the last init item), averaged
    over layers 1 .. L-2: first start, median and last end of waits, last
    end; mean wait and mean work of an item."""
    import torch

    import numpy as np

    L = cfg.backbone.num_hidden_layers
    S = bb_kernel.TRACE_SLOTS
    buf = torch.zeros((S * bb_kernel.item_count(qsb, cfg, B),), dtype=torch.int64, device="cuda")
    step(item_ns=buf)
    rows = buf.view(-1, S).cpu().numpy()
    # Slot 0 is the item's stage: 1 + 5 l + k for stage kind k of layer l.
    raw = rows[:, 1:].astype(np.float64) / 1e3
    t = raw[:, [0, 1, S - 2]]
    kinds = ("qkv", "attention", "o_proj", "gate_up", "down")
    idx = {}
    for i, st in enumerate(rows[:, 0].tolist()):
        if 1 <= st <= 5 * L:
            idx.setdefault((kinds[(st - 1) % 5], (st - 1) // 5), []).append(i)
    out = {k: dict(first_start=0.0, median_ready=0.0, last_ready=0.0, last_end=0.0, wait=0.0,
                   work=0.0, max_work=0.0) for k in kinds}
    layers = range(1, L - 1)
    for l in layers:
        t0 = t[idx[("down", l - 1)], 2].max()
        for k in kinds:
            r = t[idx[(k, l)]]
            d = out[k]
            d["first_start"] += (r[:, 0].min() - t0) / len(layers)
            d["median_ready"] += (np.median(r[:, 1]) - t0) / len(layers)
            d["last_ready"] += (r[:, 1].max() - t0) / len(layers)
            d["last_end"] += (r[:, 2].max() - t0) / len(layers)
            d["wait"] += (r[:, 1] - r[:, 0]).mean() / len(layers)
            d["work"] += (r[:, 2] - r[:, 1]).mean() / len(layers)
            d["max_work"] += (r[:, 2] - r[:, 1]).max() / len(layers)
    # Mean µs from the end of the waits to each mark inside the items of
    # each kind and on to the item's end (over the items reaching the mark;
    # a split that is not the last of its tile ends after its sums).
    for k in kinds:
        rows = raw[[i for l in layers for i in idx[(k, l)]]]
        seg = []
        for j in range(2, S - 1):
            m = rows[:, j] > 0
            seg.append(float((rows[m, j] - rows[m, 1]).mean()) if m.any() else 0.0)
        out[k]["segments"] = seg
    for k, d in out.items():
        print(f"  items {bits} B={B} {k:9s} " + " ".join(
            f"{n} {v:7.2f}" for n, v in d.items() if n != "segments")
            + " | " + " ".join(f"{v:6.2f}" for v in d["segments"]), flush=True)
    return out


OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chiprun_out")
# K1q may move this much in time against another build in the same call.
K1Q_TIME_TOL = 0.03


def compare(spec: str) -> int:
    """``--compare P1,P2:C1,C2``: see the module's docstring."""
    sides = [side.split(",") for side in spec.split(":")]

    def load(label):
        with open(os.path.join(OUT, f"bbq_profile_{label}.json")) as f:
            return {(r["bits"], r["B"]): r for r in json.load(f)}

    (p, c) = ([load(x) for x in labels] for labels in sides)
    bad = []
    for key in sorted(set.intersection(*(set(r) for r in p + c))):
        pm = sum(r[key]["ms"] for r in p) / len(p)
        cm = sum(r[key]["ms"] for r in c) / len(c)
        same = len({r[key]["digest"] for r in p + c}) == 1
        bits, B = key
        print(f"bits={bits} B={B}: {sides[0]} {pm:.4f} ms, {sides[1]} {cm:.4f} ms, ratio "
              f"{cm / pm:.4f}, outputs bitwise equal {same}", flush=True)
        if bits != 16 and (not same or abs(cm / pm - 1) > K1Q_TIME_TOL):
            bad.append(key)
    if bad:
        print(f"K1q readings that differ in outputs or by > {K1Q_TIME_TOL:.0%} in time: {bad}")
        return 1
    return 0


def digest(out) -> str:
    """sha256 of a step's outputs' bytes."""
    import torch

    h = hashlib.sha256()
    for t in out:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="this")
    ap.add_argument("--batches", default="1,8,32")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--items", action="store_true",
                    help="also read the kernel's per-item trace (this checkout only)")
    ap.add_argument("--compare", help="P1,P2:C1,C2: compare the records of these labels")
    a = ap.parse_args()
    if a.compare:
        return compare(a.compare)
    import torch

    if not torch.cuda.is_available():
        print("bbq_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(a.repo))
    from torch.profiler import ProfilerActivity, profile

    from csm_tpu_torch import CSMConfig, CSMModel
    from csm_tpu_torch.ops import bb_kernel
    from csm_tpu_torch.ops.rope import compute_rope_table, gather_rope

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    cfg = CSMConfig()
    bc = cfg.backbone
    model = CSMModel(cfg, dtype=torch.bfloat16, seed=0)
    bundles = {b: bb_kernel.prepare_streamed_backbone(model.params, cfg, bits=b)
               for b in (16, 8, 4)}
    del model
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    W, dev = 256, "cuda"
    L, D, nkv, hd = bc.num_hidden_layers, bc.hidden_size, bc.num_key_value_heads, bc.head_dim
    records = []
    for B in (int(x) for x in a.batches.split(",")):
        h0 = (0.11 * torch.randn((B, D), generator=gen, device=dev)).bfloat16().float()
        cos, sin = gather_rope(compute_rope_table(bc, cfg.max_seq_len, torch.device(dev)),
                               torch.arange(B, device=dev) + 200)
        valid = torch.rand((B, W), generator=gen, device=dev) < 0.7
        valid[:, 200:] = False
        bias = torch.where(valid, 0.0, -1e9).float()
        kc = torch.randn((L, B, W, nkv, hd), generator=gen, device=dev).bfloat16()
        vc = torch.randn((L, B, W, nkv, hd), generator=gen, device=dev).bfloat16()
        for bits, qsb in bundles.items():
            if bits == 16 and B > bb_kernel.MAX_VALIDATED_B_EXACT:
                continue
            fn = {16: bb_kernel.bb_decode_step, 8: bb_kernel.bb_decode_step_q,
                  4: bb_kernel.bb_decode_step_q4}[bits]

            def step(**kw):
                return fn(qsb, cfg, h0, cos, sin, bias, kc, vc, **kw)

            out_digest = digest(step())
            for _ in range(3):
                step()
            torch.cuda.synchronize()
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            for _ in range(a.iters):
                step()
            t1.record()
            torch.cuda.synchronize()
            ms = t0.elapsed_time(t1) / a.iters
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
            ev = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
            by = {}
            for e in ev:
                name = e.name.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]
                n, t = by.get(name, (0, 0.0))
                by[name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
            ev.sort(key=lambda e: e.time_range.start)
            span = (max(e.time_range.end for e in ev) - ev[0].time_range.start) / 1e3 if ev else 0.0
            busy = sum(t for _, t in by.values())
            rec = dict(label=a.label, bits=bits, B=B, W=W, ms=ms, digest=out_digest,
                       kernels_per_step=len(ev), span_ms=span, busy_ms=busy,
                       gaps_ms=span - busy,
                       by_kernel={k: dict(launches=n, ms=t) for k, (n, t) in
                                  sorted(by.items(), key=lambda kv: -kv[1][1])},
                       card=smi)
            if a.items:
                rec["items"] = item_breakdown(bb_kernel, cfg, qsb, bits, step, B)
            records.append(rec)
            print(json.dumps(rec), flush=True)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, f"bbq_profile_{a.label}.json"), "w") as f:
        json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
