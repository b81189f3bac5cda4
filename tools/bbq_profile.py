#!/usr/bin/env python3
"""Profile one int8 / int4 backbone decode step (K1q-8 / K1q-4) on the card.

    python3 tools/bbq_profile.py [--repo DIR] [--label NAME] [--items]

Builds random CSM-1B weights (seed 0) in bf16, the ``bits=8`` and ``bits=4``
bundles, and at B = 1, 8 and 32 (W = 256, ~55 % of the window usable)
times the step with CUDA events and breaks one step down under
``torch.profiler``: device ms and launches by kernel name, the step's span
from its first kernel's start to its last kernel's end, and the idle gaps
inside that span.  ``--repo`` imports ``csm_tpu_torch`` from another
checkout (a parent commit unpacked beside this one), so two versions are
read in one call.  ``--items`` also reads the persistent kernel's per-item
trace.  Prints one JSON object per reading; the whole record goes to
``chiprun_out/bbq_profile_<label>.json``.
"""

from __future__ import annotations

import argparse
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

    L = qsb["w"]["wqkv"].shape[0]
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="this")
    ap.add_argument("--batches", default="1,8,32")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--items", action="store_true",
                    help="also read the kernel's per-item trace (this checkout only)")
    a = ap.parse_args()
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
    bundles = {8: bb_kernel.prepare_streamed_backbone(model.params, cfg, bits=8),
               4: bb_kernel.prepare_streamed_backbone(model.params, cfg, bits=4)}
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
            fn = bb_kernel.bb_decode_step_q4 if bits == 4 else bb_kernel.bb_decode_step_q

            def step(**kw):
                return fn(qsb, cfg, h0, cos, sin, bias, kc, vc, **kw)

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
            rec = dict(label=a.label, bits=bits, B=B, W=W, ms=ms,
                       kernels_per_step=len(ev), span_ms=span, busy_ms=busy,
                       gaps_ms=span - busy,
                       by_kernel={k: dict(launches=n, ms=t) for k, (n, t) in
                                  sorted(by.items(), key=lambda kv: -kv[1][1])},
                       card=smi)
            if a.items:
                rec["items"] = item_breakdown(bb_kernel, cfg, qsb, bits, step, B)
            records.append(rec)
            print(json.dumps(rec), flush=True)
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"bbq_profile_{a.label}.json"), "w") as f:
        json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
