#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (csm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --hybrid   # phase 17 alone

Phases, each printed as it runs; any failure exits non-zero:

1. the card's name and power limit, then the kernels built from the six
   sources in ``csm_tpu_torch/csrc`` (one ``nvcc`` per source, started
   together); every instantiation of the bf16 K3, K5a and K5b must hold
   HGMMA (wgmma) instructions (``cuobjdump -sass``), the scalar kernels
   none, and K2, the exact backbone step and both instantiations of the
   int8 / int4 backbone step HMMA (mma.sync);
2. the flash prefill kernel held against its plain version at CSM-1B prefill
   shapes (B = 1 and 8 in bf16 and B = 8 in fp32, S = 256, T = 384, 32/8
   heads, hd 64, left padding);
3. the exact backbone decode-step kernel held against its plain version at
   full CSM-1B width (B = 1 and 8, W = 256, partly valid window): the full
   step, then one layer at a time in three stages, with the plain version
   short of one rounding point as controls that the gates must catch; two
   launches bitwise equal, stream 0 of B = 8 bitwise equal to the same
   stream alone, at most 2 CUDA kernels a step (one persistent launch), and
   the kernel's per-stage trace;
4. the int8 backbone decode-step kernel against its plain version (B = 1, 8
   and 32, W = 256), with the plain version on unrounded f32 operands as the
   control; two launches bitwise equal, stream 0 of the batch bitwise equal
   to the same stream alone, at most 2 CUDA kernels a step (one persistent
   launch), and the kernel's per-stage trace;
10. (run right after phase 4) the int4 backbone decode-step kernel (K1q-4)
   the same way, on the ``bits=4`` bundle, with a second control: the plain
   version without the ``u`` prescale, and the same launch, bitwise and
   trace checks;
5. the fused codebook-loop kernel against its plain version at CSM-1B
   decoder width (B = 1, 8 and 32; bf16 and int8 head; greedy and sampled at
   temperature 0.8, top-k 50), teacher-forced on the plain version's tokens:
   logit gates, every draw bit-equal to the plain sampler on the kernel's own
   logits, and the f32-operand control; K2's grid barriers per frame (its
   own count, at most 652) and its per-stage times from its trace;
6. end to end on a random CSM-1B model in bf16 (seed 0): a
   ``save_pretrained`` -> ``from_pretrained`` round trip, then greedy
   ``generate`` from a 64-frame prompt for 16 frames: plain at B = 1 and 8,
   ``exact()`` at B = 1 and 8, ``quantize()`` at B = 1, 8 and 32 and
   (phase 11) ``quantize(bits=4)`` at B = 1, 8 and 32, with the launch
   counters read around each run (frames/s, time to the first frame, time
   per later frame); the speculative tier's rounds per frame and its fixed
   point (the verify pass returns every frame unchanged); a
   ``torch.profiler`` breakdown of 8-frame ``quantize()`` and
   ``quantize(bits=4)`` runs at B = 1 and 8 and an ``exact()`` run at B = 1;
12. (run after phase 6, on its model) serving: ``CSMServer`` at CSM-1B width
   on the ``quantize(bits=4)`` bundles, 8 slots, window 256, a 32-frame
   prefix, 10 ragged requests (half through the prefix, per-request
   temperature / top-k, one greedy, a late join, a cancel, a
   ``step_many(4)`` chunk), each slot's audio streamed through a Mimi
   decoder at ``MimiCodecConfig()`` width (random weights, seed 0): every
   request's frames and PCM length, two requests' streamed PCM against the
   offline decode, the launch counters read around the run, step / codec /
   admission times and a profiled window of 3 steps; then the same server
   on the ``bits=8`` bundles as a reading; then the committed tiny golden
   fixture on the card, in fp32 through the flash kernel, against its frozen
   reference tokens;
7. the flash forward with log-sum-exp and the two backward kernels against
   their plain versions at CSM-1B training shapes (B = 1, S = 2048 and B = 4,
   S = 512, 32/8 heads, hd 64, left-padded rows, bf16 and fp32): lse on live
   rows, relative RMS of dq / dk / dv, dead rows exactly zero, two runs
   bitwise equal; times beside bounds, plain versions and SDPA;
8. training at full width: 4 steps of a random bf16 CSM-1B (seed 0) on a
   2048-frame synthetic conversation with the flash kernels and remat
   "auto", launches read around each step, the first step also through plain
   attention (gross gate), peak memory, a ``torch.profiler`` breakdown of a
   step; then ``CSMTrainer`` at S = 256 (accum 2, 2 steps, a checkpoint, a
   resume onto other weights, evaluation before and after);
9. sharpened weights: a 300-step pattern overfit of a bf16 CSM-1B, then
   teacher-forced greedy agreement of ``exact()``, ``quantize()`` and
   ``quantize(bits=4)`` with the plain path over 24 frames, the plain path's
   smallest c0 top-2 gap (exact() gated at 100 % and quantize(bits=4) at
   95 % when it exceeds 0.5), the int4 and int8 steps' normed hidden
   against the plain bf16 step's (int4 gated at 0.3 relative RMS, the JAX
   package's 0.15 max-relative budget reported), the speculative rounds
   per frame, and batch invariance: a greedy request in a
   full 8-slot int4 server against the same request alone;
13. sequence parallelism: K3 with LSE, K5a and K5b on query shards at
   ``q_offset = shard * S_local`` (B = 1, S = 2048, 2 and 4 shards, bf16 and
   fp32, left-padded): forward, lse and dq bitwise equal to the unsharded
   launches' rows, dk / dv summed over the shards against the unsharded
   ones, the key blocks after a shard's last row exactly zero (written over
   NaN-poisoned memory), the ``q_offset = 0`` control breaking the gates,
   times per shard beside bounds, plain versions and SDPA; then sharded
   train steps on ranks spawned by ``csm_tpu_torch.parallel.launch``, all on
   ``cuda:0`` over gloo: data=1 x seq=2 at full depth on phase 8's batch
   (3 steps) and data=2 x seq=2 with 4 backbone layers at S = 1024, B = 2
   (2 steps), each against a one-process step on the same batch: losses
   and grad norm, the first step's gradient norm of every parameter (a
   layer at a time), with a lost reduce-scatter of dK / dV as the control
   that must break that gate; parameters bitwise equal across ranks after
   every step, launches, ms and peak memory per rank;
14. (run after phase 8) fine-tuning from files: four clips written as WAV
   (48 kHz stereo 16-bit by the port's ``save_wav``, 44.1 kHz mono 24-bit
   and 16 kHz 8-bit unsigned by Python's ``wave``, 24 kHz mono), a JSONL of
   four two-message conversations with one clip that does not exist, and
   random full-width Mimi weights (seed 0) in the HF layout named by
   ``CSM_TPU_MIMI_PATH``; the native audio library built and available,
   each clip read back at its rate and channels and resampled to 24 kHz at
   the predicted length; then ``csm_tpu_torch.train.cli.main`` in-process at
   CSM-1B width (bf16, 2 epochs, accumulation 2, a char-level stand-in for
   the Llama-3.2 tokenizer): the optimizer steps the arguments imply, finite
   losses, K3 / K5a / K5b launched on every step, Mimi encoding in the
   batch-prefetch thread on the card without autograd, the missing clip
   warned of, every audio span ending in the zero EOS frame with codes in
   [0, 2048), the card's Mimi codes against the CPU encode of the same
   clips (with a one-sample-late control that must break the gate), the
   saved model reloading bitwise equal to the trainer's parameters, and
   greedy generation of 8 frames decoded, written and read back;
15. (run after phase 13) tensor parallelism on a model=2 mesh: K3 at phase
   2's prefill shape and K3 with LSE, K5a and K5b at B = 1, S = 2048, all at
   a rank's CSM-1B backbone head shard (16 query / 4 KV heads), against
   their plain versions with times, bounds and SDPA; model=2 train steps on
   ranks sharing ``cuda:0`` over gloo (data=1 at full depth, 3 steps, on
   phase 8's batch; data=2 and seq=2 with 4 backbone layers at S = 1024,
   B = 2, in one launch of four ranks), each against phase 13's one-process
   step: losses, grad norm, per-parameter gradient norms with a lost
   ``copy_to_model`` backward as the control that must break that gate,
   shards bitwise equal across data / seq replicas and replicated
   parameters on every rank, launches, ms, peak memory and the model
   group's all-reduce time; then greedy generation of 16 frames from phase
   6's prompt on phase 9's sharpened weights on two ranks, against the
   one-process plain bf16 path (tokens gated where the smallest c0 top-2
   gap > 0.5), both ranks' tokens equal, K3 once per layer a rank.

16. (run after phase 12, on phase 6's model and checkpoint) the last
   modules at CSM-1B width: ``csm_tpu_torch.entry.entry()``'s forward (16 K3
   launches, finite logits); the same forward on phase 6's weights under
   ``set_attention_impl("auto" / "flash" / "xla")`` (16 / 16 / 0 K3
   launches, auto bitwise equal to flash, xla within phase 3's gross 5e-2
   relative RMS) and a child interpreter started with
   ``CSM_TPU_ATTENTION=xla`` (no K3; "auto" in the same child the control);
   ``utils.measure`` (prefill ms by CUDA events at S = 128, 512 and 2048
   beside the prefill's model FLOPs, its FLOPs bound, gated, and the
   backbone weights' byte bound; the model-FLOPs share of the data sheet's
   989 TFLOP/s; one profiled prefill at each S: device busy share, kernels,
   the host's waits and copies); ``utils.profiling`` (``trace()`` around an 8-frame
   ``quantize(bits=4)`` generate whose kernel events must name K3, K1q and
   K2; ``FrameTimer`` over three 16-frame calls; ``enable_nan_checks`` on a
   CUDA tensor); ``utils.warmup`` in a fresh child (2 runs launching K3,
   K1q-4 and K2, every library loaded, no nvcc, the first real 16-frame call
   within 2x of the second) beside a cold child without it; the example
   scripts in-process (``examples.generate`` int4 offline and streamed,
   frames equal and PCM within phase 12's gate, int8; ``examples.serve``
   with 4 slots and three texts; WAV lengths, K3 / K1q-8 / K1q-4 / K2
   launched) with random full-width Mimi weights in the HF layout, phase
   14's tokenizer stand-in and a 24 kHz context clip; and
   ``dryrun_multichip(4)`` on four ranks sharing ``cuda:0``.

17. (run after phase 12) the hybrid backbone, CSM on Granite-4.0-H-Micro
   at its published widths: the Mamba-2 mixer step kernel against its plain
   version at B = 1, 8 and 32 (bf16 activations and states; conv state
   bitwise, output and state gates, a zeroed state as the control), its
   times beside its bound; then a random bf16 model with the K2 bundle
   through ``generate`` (B = 1 and 8) and a ``CSMServer`` whose steps
   replay a CUDA graph, the kernel's launch counter set to 0 before each
   (one launch a mixer a step), and three graphed steps under
   ``torch.profiler`` whose device trace must hold the kernel 36 times a
   step.  ``python3 chip_smoke.py --hybrid`` runs this phase alone (after
   building the three kernels it runs), its record in
   ``chiprun_out/chip_smoke_hybrid.json``.

Phases 12 and 14 each also read Mimi once with ``cudnn.allow_tf32`` at
torch's default (True): streamed vs offline PCM, and card vs CPU codes,
against their phase's gate.

Phases 7-10 and 12-17 print their seconds.

The full record of the run goes to ``chiprun_out/chip_smoke.json``.

The line before the device line is ``{"kernels": [...]}`` (times, bounds,
errors, launches on the main path); the last line is the device line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# Peak operations per second by operand type, same source: dense bf16 on the
# tensor cores; fp32 outside them.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
OUT_DIR = os.path.join(REPO, "chiprun_out")
KERNELS = ("flash_fwd", "flash_bwd", "bb_decode", "bb_decode_q", "fused_decoder", "ssm_step")
# What phase 17 alone (``--hybrid``) builds: K3 for the attention layers'
# prefill, K2 and the mixer step.
HYBRID_KERNELS = ("flash_fwd", "fused_decoder", "ssm_step")


FAILURES = []


def check(ok: bool, msg: str) -> None:
    """Record a failed check; the run goes on and exits non-zero at the end.
    The failure goes to standard error too, so that the end of the error
    stream names it."""
    if not ok:
        FAILURES.append(msg)
        print(f"FAIL: {msg}", flush=True)
        print(f"FAIL: {msg}", file=sys.stderr, flush=True)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_flops: float, dtype: str = "bfloat16"):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def rel_rms(a, r) -> float:
    return ((a - r).norm() / r.norm()).item()


def share_differing(a, r) -> float:
    return (a.float() != r.float()).float().mean().item()


# The bf16 kernels that must run on the tensor cores: (source, kernel), one
# instantiation per head dim (16, 32, 64) and group (1, 2, 4).
TENSOR_CORE_KERNELS = (("flash_fwd", "flash_fwd_wgmma_kernel"),
                       ("flash_bwd", "flash_bwd_dq_wgmma_kernel"),
                       ("flash_bwd", "flash_bwd_dkv_wgmma_kernel"))
# K2's and the backbone steps' products run on mma.sync (HMMA): (source,
# kernel, instantiations).
MMA_KERNELS = (("fused_decoder", "fused_decoder_kernel", 1), ("bb_decode", "bb_step_kernel", 1),
               ("bb_decode_q", "bbq_step_kernel", 2))


def tensor_core_check() -> dict:
    """Phase 1: the bf16 K3, K5a and K5b hold HGMMA (wgmma) instructions in
    every instantiation of the built libraries (``cuobjdump -sass``); the
    scalar kernels (fp32 K3 / K5a / K5b) hold none; K2 and the backbone
    steps (exact, int8, int4) hold HMMA (mma.sync).  Returns the HGMMA (HMMA
    for K2 and the backbone steps) count per kernel instantiation."""
    from csm_tpu_torch.ops import _build

    sass = _build.sass_by_function(sorted({src for src, _ in TENSOR_CORE_KERNELS}
                                          | {src for src, _, _ in MMA_KERNELS}))
    counts = {}
    for _, name in TENSOR_CORE_KERNELS:
        fns = {f: s.count("HGMMA") for f, s in sass.items() if name in f}
        counts[name] = sorted(fns.values())
        check(len(fns) == 9 and all(fns.values()),
              f"{name}: HGMMA in {sum(1 for n in fns.values() if n)} of {len(fns)} instantiations")
    for _, name, n in MMA_KERNELS:
        fns = {f: s.count("HMMA") for f, s in sass.items() if name in f}
        counts[name] = sorted(fns.values())
        check(len(fns) == n and all(fns.values()), f"{name}: HMMA counts {counts[name]}")
    scalar = [f for f, s in sass.items() if "wgmma" not in f and "HGMMA" in s]
    check(not scalar, f"scalar kernels hold HGMMA: {scalar}")
    log("tensor cores: HGMMA (HMMA for K2, K1, K1q-8 / K1q-4) per instantiation " +
        ", ".join(f"{k} {v}" for k, v in counts.items()))
    return counts


# ---------------------------------------------------------------------------
# Phase 2: flash prefill kernel
# ---------------------------------------------------------------------------

# bf16: outputs rounded to bf16 (~4e-3 relative) plus bf16 probabilities
# rounded before normalisation (the plain version rounds normalised ones);
# fp32: only the order of the fp32 sums differs.
FLASH_TOL = {"bfloat16": 2e-2, "float32": 5e-5}


def check_flash(B: int, gen, dtype_name: str = "bfloat16", nq: int = 32, nkv: int = 8):
    """K3 against its plain version at a prefill shape (``nq`` / ``nkv``:
    CSM-1B's heads, or a rank's head shard under tensor parallelism); its
    time beside the plain version's, SDPA's and the bound."""
    import torch

    from csm_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference

    S, T, hd = 256, 384, 64
    dev, dtype = "cuda", getattr(torch, dtype_name)
    q = torch.randn((B, S, nq, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, T, nkv, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, T, nkv, hd), generator=gen, device=dev).to(dtype)
    # Row b is left-padded by 5*b frames; slots >= S (the rest of the cache
    # window) are unwritten.
    pad = [5 * b for b in range(B)]
    valid = torch.zeros((B, T), dtype=torch.int32, device=dev)
    for b in range(B):
        valid[b, pad[b]:S] = 1
    out = flash_attention(q, k, v, valid)
    ref = flash_attention_reference(q, k, v, valid)
    torch.cuda.synchronize()
    live = torch.zeros((B, S), dtype=torch.bool, device=dev)
    for b in range(B):
        live[b, pad[b]:] = True
    err = (out.float() - ref.float()).abs()[live].max().item()
    finite = bool(torch.isfinite(out.float()).all())
    tol = FLASH_TOL[dtype_name]
    tag = f"flash {dtype_name} B={B} S={S} T={T} heads {nq}/{nkv}"
    log(f"{tag}: max|kernel-plain| on live rows {err:.3e} (tol {tol}), all rows finite {finite}")
    check(err <= tol and finite, f"{tag}: the flash kernel disagrees with its plain version")

    ms = cuda_ms(lambda: flash_attention(q, k, v, valid), iters=20)
    plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v, valid), iters=5)
    g = nq // nkv
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(g, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(g, dim=1)
    mask = (valid.bool()[:, None, :] & torch.ones((S, T), dtype=torch.bool, device=dev).tril()[None])
    mask = mask[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask), iters=20)
    # Work this data needs: each live (row, valid key <= row) pair, per head;
    # q and out whole, k and v of the valid keys below S (causality never
    # reaches the window's slots at or past S) and their S validity flags.
    pairs = sum(int(valid[b, :S].cumsum(0)[pad[b]:].sum()) for b in range(B))
    n_flops = 4 * hd * nq * pairs
    kv_bytes = 2 * int(valid[:, :S].sum()) * nkv * hd * q.element_size()
    n_bytes = nbytes(q, out) + kv_bytes + B * min(S, T) * valid.element_size()
    b_ms, by = bound_ms(n_bytes, n_flops, dtype_name)
    log(f"{tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms ({by})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                bound_by=by, shape=f"B={B} S={S} T={T} nq={nq} nkv={nkv} hd={hd} {dtype_name}")


# ---------------------------------------------------------------------------
# Phase 3: exact backbone decode-step kernel
# ---------------------------------------------------------------------------

# The exact backbone kernel's gates.  Kernel and plain version round to bf16
# at the same points and differ only in the order of their fp32 sums.  That
# now and then moves a value across a rounding boundary (one ulp), and every
# product after it carries the change on, so the two drift apart with depth.
#
# Full step, 16 layers: relative RMS error of each output.  The plain version
# summed in f64, a second correct evaluation, lies ~2e-2 from the f32 one, so
# this gate catches gross faults only (a wrong mask, head or position gives
# 0.1-1).
BB_STEP_TOL = 5e-2
# One layer at a time, fed the plain version's residual, in three stages: the
# whole layer, its attention block alone (w_down zeroed) and its MLP block
# alone (wo zeroed).  A stage's limit bounds the share of an output's values
# that differ from the plain version at all (max over layers), set from the
# readings in PERF.md.  The plain version with any one of its rounding points
# left out (bb_kernel.ROUNDING_POINTS) must break at least one limit.
BB_OUTPUTS = ("normed_h", "c0_logits", "new_k", "new_v")
BB_STAGES = ("layer", "attention", "mlp")
BB_SHARE_LIMITS = {
    ("layer", "normed_h"): 0.2, ("layer", "c0_logits"): 0.5,
    ("layer", "new_k"): 0.02, ("layer", "new_v"): 0.02,
    ("attention", "normed_h"): 0.05, ("attention", "c0_logits"): 0.25,
    ("attention", "new_k"): 0.02, ("attention", "new_v"): 0.02,
    ("mlp", "normed_h"): 0.05, ("mlp", "c0_logits"): 0.35,
    ("mlp", "new_k"): 0.02, ("mlp", "new_v"): 0.02,
}
BB_LAYER_KEYS = ("wqkv", "wo", "w_gu", "w_down", "attn_nw", "mlp_nw")


def _stage_bundle(qsb: dict, l: int, stage: str) -> dict:
    import torch

    one = {k: (v[l:l + 1] if k in BB_LAYER_KEYS else v) for k, v in qsb.items()}
    zeroed = {"layer": None, "attention": "w_down", "mlp": "wo"}[stage]
    if zeroed:
        one[zeroed] = torch.zeros_like(one[zeroed])
    return one


def check_bb(qsb, config, B: int, gen):
    import torch

    from csm_tpu_torch.ops.bb_kernel import (
        ROUNDING_POINTS, bb_decode_step, bb_decode_step_reference, bb_layer_reference,
    )
    from csm_tpu_torch.ops.rope import compute_rope_table, gather_rope

    bc = config.backbone
    W, dev = 256, "cuda"
    L, D, nkv, hd = bc.num_hidden_layers, bc.hidden_size, bc.num_key_value_heads, bc.head_dim
    nq, Va = bc.num_attention_heads, config.audio_vocab_size
    # Norm weights away from their init of 1, so that the norms' rounding
    # points show; bf16-valued like the checkpoint's.
    qsb = dict(qsb)
    for key in ("attn_nw", "mlp_nw", "final_norm"):
        w = 1 + 0.1 * torch.randn(qsb[key].shape, generator=gen, device=dev)
        qsb[key] = w.bfloat16().float()
    # Embedding sums of 32 N(0, 0.02) rows have std ~0.11; bf16-valued.
    h0 = (0.11 * torch.randn((B, D), generator=gen, device=dev)).bfloat16().float()
    pos = torch.arange(B, device=dev) + 200
    cos, sin = gather_rope(compute_rope_table(bc, config.max_seq_len, torch.device(dev)), pos)
    valid = torch.rand((B, W), generator=gen, device=dev) < 0.7
    valid[:, 200:] = False
    bias = torch.where(valid, 0.0, -1e9).float()
    shape = (L, B, W, nkv, hd)
    kc = torch.randn(shape, generator=gen, device=dev).bfloat16()
    vc = torch.randn(shape, generator=gen, device=dev).bfloat16()
    args = (qsb, config, h0, cos, sin, bias, kc, vc)
    out = bb_decode_step(*args)
    ref = bb_decode_step_reference(*args)
    ref64 = bb_decode_step_reference(*args, acc=torch.float64)
    torch.cuda.synchronize()
    errs, full = {}, {}
    for name, a, r, r64 in zip(BB_OUTPUTS, out, ref, ref64):
        a, r = a.float(), r.float()
        errs[name] = (a - r).abs().max().item()
        rel, spread = rel_rms(a, r), rel_rms(r64.float(), r)
        full[name] = dict(max_abs=errs[name], rel_rms=rel, f64_rel_rms=spread)
        log(f"bb B={B} W={W} {name}: max|kernel-plain| {errs[name]:.3e} (max|plain| "
            f"{r.abs().max().item():.3e}), relative RMS kernel-plain {rel:.3e}, "
            f"plain(f64 sums)-plain {spread:.3e}")
        check(bool(torch.isfinite(a).all()) and rel <= BB_STEP_TOL,
              f"bb B={B} {name}: relative RMS error {rel:.3e} > {BB_STEP_TOL}")
    agree = (out[1].argmax(-1) == ref[1].argmax(-1)).float().mean().item()
    log(f"bb B={B}: c0 argmax agreement kernel vs plain {agree:.3f} (reported, not gated)")

    # One layer at a time: share of values differing from the plain version,
    # max over layers, for the kernel, the f64-summed plain version and each
    # control (the plain version without one rounding point).
    keys = [(st, n) for st in BB_STAGES for n in BB_OUTPUTS]
    kern = {k: 0.0 for k in keys}
    wit = {k: 0.0 for k in keys}
    ctl = {p: {k: 0.0 for k in keys} for p in ROUNDING_POINTS}
    h = h0
    for l in range(L):
        for stage in BB_STAGES:
            a1 = (_stage_bundle(qsb, l, stage), config, h, cos, sin, bias,
                  kc[l:l + 1], vc[l:l + 1])
            r1 = bb_decode_step_reference(*a1)
            sides = [(kern, bb_decode_step(*a1)),
                     (wit, bb_decode_step_reference(*a1, acc=torch.float64))]
            sides += [(ctl[p], bb_decode_step_reference(*a1, unrounded=frozenset({p})))
                      for p in ROUNDING_POINTS]
            for acc_d, got in sides:
                for name, a, r in zip(BB_OUTPUTS, got, r1):
                    acc_d[(stage, name)] = max(acc_d[(stage, name)], share_differing(a, r))
        h, _, _ = bb_layer_reference(qsb, config, l, h, cos, sin, bias, kc[l], vc[l])
    log(f"bb B={B} one layer at a time, share of values differing from the plain version "
        f"(max over {L} layers): kernel / plain summed in f64 / limit")
    for stage in BB_STAGES:
        log(f"  {stage:9s} " + ", ".join(
            f"{n} {kern[(stage, n)]:.2e} / {wit[(stage, n)]:.2e} / {BB_SHARE_LIMITS[(stage, n)]:g}"
            for n in BB_OUTPUTS))
        for n in BB_OUTPUTS:
            check(kern[(stage, n)] <= BB_SHARE_LIMITS[(stage, n)],
                  f"bb B={B} {stage} {n}: one-layer share differing {kern[(stage, n)]:.3e} > "
                  f"{BB_SHARE_LIMITS[(stage, n)]}")
    controls = {}
    for p in ROUNDING_POINTS:
        broken = {f"{k[0]}/{k[1]}": x for k, x in ctl[p].items() if x > BB_SHARE_LIMITS[k]}
        controls[p] = dict(shares={f"{k[0]}/{k[1]}": x for k, x in ctl[p].items()}, broken=broken)
        worst = max(ctl[p], key=lambda k: ctl[p][k] / BB_SHARE_LIMITS[k])
        log(f"  control without the '{p}' rounding: breaks {len(broken)} limit(s); worst "
            f"{worst[0]}/{worst[1]} {ctl[p][worst]:.2e} (limit {BB_SHARE_LIMITS[worst]:g})")
        check(bool(broken), f"bb B={B}: the one-layer limits do not see a missing '{p}' rounding")

    launch = launch_checks("bb", bb_decode_step, args, out)
    ms = cuda_ms(lambda: bb_decode_step(*args), iters=20)
    plain_ms = cuda_ms(lambda: bb_decode_step_reference(*args), iters=3, warmup=1)
    # Bytes this data needs: every weight once (the c0 head at its Va real
    # columns, not the padded ones), the K/V rows of the window slots the bias
    # lets attention read, and the step's other inputs and outputs.
    usable = int((bias >= 0).sum())
    mats = [qsb[k] for k in ("wqkv", "wo", "w_gu", "w_down")]
    head_elems = D * Va
    w_bytes = (nbytes(*mats, *(qsb[k] for k in ("attn_nw", "mlp_nw", "final_norm")))
               + head_elems * qsb["head"].element_size())
    kv_bytes = 2 * L * usable * nkv * hd * kc.element_size()
    io_bytes = nbytes(h0, cos, sin, bias, *out) + kv_bytes
    n_flops = 2 * B * (sum(m.numel() for m in mats) + head_elems) + 4 * hd * nq * L * (usable + B)
    b_ms, by = bound_ms(w_bytes + io_bytes, n_flops)
    log(f"bb B={B}: kernel {ms:.4f} ms ({launch['kernels_per_step']:g} CUDA kernels a step), plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}), weights {w_bytes / 1e9:.4f} GB, K/V of "
        f"usable slots {kv_bytes / 1e6:.2f} MB")
    return dict(err=max(errs.values()), ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=b_ms, bound_by=by, shape=f"B={B} W={W} CSM-1B backbone bf16", **launch,
                full_step=full, one_layer_share=dict(
                    kernel={f"{k[0]}/{k[1]}": x for k, x in kern.items()},
                    f64={f"{k[0]}/{k[1]}": x for k, x in wit.items()},
                    controls=controls))


# ---------------------------------------------------------------------------
# Phase 4: int8 backbone decode-step kernel
# ---------------------------------------------------------------------------

# Kernel and plain version do the same f32 arithmetic in another summation
# order.  That moves a bf16-rounded value (a product's operand, a
# probability, a K/V row, a logit) now and then across a rounding boundary,
# and on random weights every later product carries the flip on: over the 16
# layers of a step two correct evaluations drift apart (the plain version
# summed in f64 shows how far).  So the full step gets a gross gate only
# (relative RMS of the normed hidden and the logits), and the fine gates run
# one layer at a time, fed the plain version's residual: share of bf16 values
# differing at all (new K/V, logits), relative RMS of the f32 normed hidden,
# max over layers, limits set from the readings in PERF.md.  The control,
# the plain version with f32 product operands (``act=float32``), must break
# at least one fine limit.
BBQ_STEP_TOL = 5e-2
BBQ_LAYER_LIMITS = {"normed_h rel RMS": 2e-3, "c0_logits share differing": 0.5,
                    "new_k share differing": 0.02, "new_v share differing": 0.02}


# The persistent kernel: one launch a step (two if its counters were cleared
# by a memset; they re-arm themselves).
BBQ_MAX_KERNELS = 2
BBQ_STAGES = ("qkv", "attention", "o_proj", "gate_up", "down")


def bbq_stage_us(kernel, args, L: int) -> dict:
    """One step with the kernel's trace (block 0's clock at its start and as
    it leaves each stage): µs per stage kind, summed over the layers."""
    import torch

    from csm_tpu_torch.ops.bb_kernel import stage_count

    stamps = torch.zeros((stage_count(L),), dtype=torch.int64, device="cuda")
    kernel(*args, stage_ns=stamps)
    d = stamps.diff().double().cpu() / 1e3  # d[s]: stage s
    out = {"init": d[0].item(), **{k: 0.0 for k in BBQ_STAGES}}
    for l in range(L):
        for j, k in enumerate(BBQ_STAGES):
            out[k] += d[1 + 5 * l + j].item()
    out["head"] = d[1 + 5 * L].item()
    out["final"] = d[2 + 5 * L].item()
    out["step"] = (stamps[-1] - stamps[0]).item() / 1e3
    return out


def _bbq_readings(got, ref) -> dict:
    nh, lg, k, v = got
    return {"normed_h rel RMS": rel_rms(nh.float(), ref[0].float()),
            "c0_logits share differing": share_differing(lg, ref[1]),
            "new_k share differing": share_differing(k, ref[2]),
            "new_v share differing": share_differing(v, ref[3])}


def perturbed_norms(params: dict, gen) -> dict:
    """``params`` with backbone and decoder norm weights away from their init
    of 1 (bf16-valued), so that folding them into the int8 weights shows."""
    import torch

    def jitter(w):
        return (w.float() + 0.1 * torch.randn(w.shape, generator=gen, device=w.device)).to(w.dtype)

    out = dict(params)
    for stack in ("backbone", "decoder"):
        layers = {k: (jitter(v) if k.endswith("_norm") else v)
                  for k, v in params[stack]["layers"].items()}
        out[stack] = {"layers": layers, "final_norm": jitter(params[stack]["final_norm"])}
    return out


def one_layer(bundle: dict, l: int) -> dict:
    """A bundle holding only layer ``l`` of its stacked int8 / int4 weights
    (and int4 prescales)."""
    out = dict(bundle)
    for part in ("w", "s", "u"):
        if part in bundle:
            out[part] = {k: (v if k == "head" else v[l:l + 1]) for k, v in bundle[part].items()}
    return out


def device_kernels(fn) -> int:
    """CUDA kernels one call of ``fn`` launches, counted by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation)


def launch_checks(tag: str, kernel, args, out) -> dict:
    """The persistent backbone steps' launch checks (phases 3, 4 and 10): a
    second launch bitwise equal to ``out``, stream 0 of a batch bitwise
    equal to the same stream alone (the K splits are fixed by the shapes),
    block 0's stage trace, and at most BBQ_MAX_KERNELS CUDA kernels a step."""
    import torch

    qsb, config, h0, cos, sin, bias, kc, vc = args
    B, L = h0.shape[0], kc.shape[0]
    repeat_equal = all(torch.equal(a, b) for a, b in zip(out, kernel(*args)))
    check(repeat_equal, f"{tag} B={B}: two launches differ")
    solo_equal = None
    if B > 1:
        solo = kernel(qsb, config, h0[:1], cos[:1], sin[:1], bias[:1], kc[:, :1], vc[:, :1])
        solo_equal = all(torch.equal(a[:, :1] if i >= 2 else a[:1], b)
                         for i, (a, b) in enumerate(zip(out, solo)))
        check(solo_equal, f"{tag} B={B}: stream 0 differs from the same stream alone")
    log(f"{tag} B={B}: two launches bitwise equal {repeat_equal}; stream 0 batched = alone "
        f"{solo_equal if B > 1 else '(B = 1)'}")
    stages = bbq_stage_us(kernel, args, L)
    log(f"{tag} B={B}: stage us (kernel trace, block 0, summed over {L} layers): "
        + ", ".join(f"{k} {v:.1f}" for k, v in stages.items()))
    # Counted over 4 steps: the profiler has been seen to drop a kernel.
    n_kernels = device_kernels(lambda: [kernel(*args) for _ in range(4)]) / 4
    check(0 < n_kernels <= BBQ_MAX_KERNELS, f"{tag} B={B}: {n_kernels} CUDA kernels a step "
          f"(limit {BBQ_MAX_KERNELS})")
    return dict(kernels_per_step=n_kernels, repeat_bitwise=repeat_equal, solo_bitwise=solo_equal,
                stage_us=stages)


def check_bbq(qsb, config, B: int, gen):
    """Phase 4 (int8 bundle) and phase 10 (int4 bundle, K1q-4): the kernel
    against its plain version, with the f32-operand control and, for int4,
    the plain version without the ``u`` prescale as a second control."""
    import torch

    from csm_tpu_torch.ops.bb_kernel import (
        bb_decode_step_q, bb_decode_step_q4, bb_decode_step_q_reference, bbq_layer_reference,
    )
    from csm_tpu_torch.ops.rope import compute_rope_table, gather_rope

    int4 = "u" in qsb
    tag = "bbq4" if int4 else "bbq"
    kernel = bb_decode_step_q4 if int4 else bb_decode_step_q
    controls = {"f32 operands": dict(act=torch.float32)}
    if int4:
        controls["no prescale"] = dict(prescale=False)
    bc = config.backbone
    W, dev = 256, "cuda"
    L, D, nkv, hd = bc.num_hidden_layers, bc.hidden_size, bc.num_key_value_heads, bc.head_dim
    nq, Va = bc.num_attention_heads, config.audio_vocab_size
    h0 = (0.11 * torch.randn((B, D), generator=gen, device=dev)).bfloat16().float()
    pos = torch.arange(B, device=dev) + 200
    cos, sin = gather_rope(compute_rope_table(bc, config.max_seq_len, torch.device(dev)), pos)
    valid = torch.rand((B, W), generator=gen, device=dev) < 0.7
    valid[:, 200:] = False
    bias = torch.where(valid, 0.0, -1e9).float()
    shape = (L, B, W, nkv, hd)
    kc = torch.randn(shape, generator=gen, device=dev).bfloat16()
    vc = torch.randn(shape, generator=gen, device=dev).bfloat16()
    args = (qsb, config, h0, cos, sin, bias, kc, vc)
    out = kernel(*args)
    ref = bb_decode_step_q_reference(*args)
    wit = bb_decode_step_q_reference(*args, acc=torch.float64)
    ctls = {c: bb_decode_step_q_reference(*args, **kw) for c, kw in controls.items()}
    torch.cuda.synchronize()
    full = {}
    for i, name in ((0, "normed_h"), (1, "c0_logits")):
        full[name] = dict(kernel=rel_rms(out[i].float(), ref[i].float()),
                          f64=rel_rms(wit[i].float(), ref[i].float()),
                          **{f"control {c}": rel_rms(x[i].float(), ref[i].float())
                             for c, x in ctls.items()})
        log(f"{tag} B={B} W={W} full step {name} relative RMS vs plain: " + ", ".join(
            f"{k} {x:.3e}" for k, x in full[name].items()) + f" (gross limit {BBQ_STEP_TOL})")
        check(bool(torch.isfinite(out[i]).all()) and full[name]["kernel"] <= BBQ_STEP_TOL,
              f"{tag} B={B} full step {name}: relative RMS {full[name]['kernel']:.3e}")
    agree = (out[1].argmax(-1) == ref[1].argmax(-1)).float().mean().item()
    log(f"{tag} B={B}: c0 argmax agreement kernel vs plain {agree:.3f} (reported, not gated)")

    kern, f64 = ({k: 0.0 for k in BBQ_LAYER_LIMITS} for _ in range(2))
    ctl1 = {c: {k: 0.0 for k in BBQ_LAYER_LIMITS} for c in controls}
    h = h0
    for l in range(L):
        a1 = (one_layer(qsb, l), config, h, cos, sin, bias, kc[l:l + 1], vc[l:l + 1])
        r1 = bb_decode_step_q_reference(*a1)
        sides = [(kern, kernel(*a1)), (f64, bb_decode_step_q_reference(*a1, acc=torch.float64))]
        sides += [(ctl1[c], bb_decode_step_q_reference(*a1, **kw)) for c, kw in controls.items()]
        for acc_d, got in sides:
            for k, x in _bbq_readings(got, r1).items():
                acc_d[k] = max(acc_d[k], x)
        h, _, _ = bbq_layer_reference(qsb, config, l, h, cos, sin, bias, kc[l], vc[l])
    log(f"{tag} B={B} one layer at a time (max over {L} layers): kernel / plain summed in f64 / "
        + " / ".join(f"control {c}" for c in controls) + " / limit")
    for k, lim in BBQ_LAYER_LIMITS.items():
        log(f"  {k}: {kern[k]:.3e} / {f64[k]:.3e} / "
            + " / ".join(f"{ctl1[c][k]:.3e}" for c in controls) + f" / {lim:g}")
        check(kern[k] <= lim, f"{tag} B={B} one layer {k}: {kern[k]:.3e} > {lim}")
    for c in controls:
        broken = [k for k, lim in BBQ_LAYER_LIMITS.items() if ctl1[c][k] > lim]
        check(bool(broken), f"{tag} B={B}: the one-layer limits do not see the {c} control")

    launch = launch_checks(tag, kernel, args, out)
    ms = cuda_ms(lambda: kernel(*args), iters=20)
    plain_ms = cuda_ms(lambda: bb_decode_step_q_reference(*args), iters=3, warmup=1)
    usable = int((bias >= 0).sum())
    w, sc = qsb["w"], qsb["s"]
    fams = ("wqkv", "wo", "w_gu", "w_down")
    mats = [w[k] for k in fams]
    pre = [qsb["u"][k] for k in fams] if int4 else []
    w_bytes = (nbytes(*mats, *(sc[k] for k in fams), *pre, qsb["final_norm"])
               + D * Va * w["head"].element_size() + Va * sc["head"].element_size())
    kv_bytes = 2 * L * usable * nkv * hd * kc.element_size()
    io_bytes = nbytes(h0, cos, sin, bias, *out) + kv_bytes
    # An int4 byte holds two weights.
    elems = sum(m.numel() for m in mats) * (2 if int4 else 1)
    n_flops = 2 * B * (elems + D * Va) + 4 * hd * nq * L * (usable + B)
    b_ms, by = bound_ms(w_bytes + io_bytes, n_flops)
    log(f"{tag} B={B}: kernel {ms:.4f} ms ({launch['kernels_per_step']:g} CUDA kernels a step), plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}), weights {w_bytes / 1e9:.4f} GB")
    return dict(err=max((a.float() - r.float()).abs().max().item() for a, r in zip(out, ref)),
                ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=by, **launch,
                shape=f"B={B} W={W} CSM-1B backbone {'int4' if int4 else 'int8'}",
                full_step=full, one_layer=dict(kernel=kern, f64=f64, controls=ctl1))


# ---------------------------------------------------------------------------
# Phase 5: fused codebook-loop kernel
# ---------------------------------------------------------------------------

# Teacher-forced on the plain version's tokens, kernel and plain version
# compute each codebook's logits from the same prefix, in another f32
# summation order.  As in phase 4, a bf16 rounding flip is carried on through
# the decoder's layers and, through the K/V scratch, the later passes: at full
# depth two correct evaluations differ in many bf16 logits (the plain version
# summed in f64 shows it), so the full loop gets a gross gate (relative RMS of
# the live logits) and the fine gates run on each decoder layer alone (a
# bundle of that one layer): share of live logits differing at all and their
# relative RMS, max over layers, limits set from the readings in PERF.md.
# The control (plain version with f32 product operands) must break a fine
# limit.  Every draw before forcing must equal the plain sampler on the
# kernel's own logits, bit for bit.
FUSED_FULL_RMS_TOL = 2e-2
FUSED_LAYER_LIMITS = {"share": 0.3, "rel_rms": 3e-3}
FUSED_TEMP, FUSED_TOPK = 0.8, 50


def _fused_run(qdec, config, x0, c0, gum, temp, topk, greedy):
    """Kernel, plain version, f64-summed plain version and control, forced on
    the plain version's own tokens: {side: (samples, logits, draws)}."""
    import torch

    from csm_tpu_torch.ops import fused_decoder as fd

    B, N = x0.shape[0], config.audio_num_codebooks
    args = (qdec, config, x0, c0, gum, temp, topk, greedy)
    forced = fd.decode_codebooks_reference(*args, torch.full((B, N), -1, device=x0.device))[0]
    out = dict(forced=forced,
               kernel=fd.fused_decode_codebooks(*args, forced=forced, return_logits=True),
               plain=fd.decode_codebooks_reference(*args, forced),
               f64=fd.decode_codebooks_reference(*args, forced, acc=torch.float64),
               control=fd.decode_codebooks_reference(*args, forced, act=torch.float32))
    torch.cuda.synchronize()
    return out


def _logit_readings(lg, ref, Va: int):
    a, r = lg[..., :Va].float(), ref[..., :Va].float()
    return dict(share=share_differing(a, r), rel_rms=rel_rms(a, r))


def check_fused(qdecs, params, config, B: int, gen):
    """Kernel vs plain version at both head widths, greedy and sampled."""
    import torch
    import torch.nn.functional as F

    from csm_tpu_torch.ops import fused_decoder as fd

    dev, N, Va = "cuda", config.audio_num_codebooks, config.audio_vocab_size
    D, L = config.backbone.hidden_size, config.decoder.num_hidden_layers
    last_h = torch.randn((B, D), generator=gen, device=dev).bfloat16()
    x0 = (last_h @ params["projection"]).float()
    c0 = (last_h @ params["codebook0_head"]).float()
    gum_s = fd.build_frame_gumbel(config, gen, B, False, dev)
    temp = torch.full((B,), FUSED_TEMP, device=dev)
    topk = torch.full((B,), FUSED_TOPK, dtype=torch.int32, device=dev)
    out = {}
    for head_bits, qdec in qdecs.items():
        for greedy in (True, False):
            gum = gum_s * 0 if greedy else gum_s
            mode = "greedy" if greedy else "sampled"
            tag = f"fused B={B} head{head_bits} {mode}"
            run = _fused_run(qdec, config, x0, c0, gum, temp, topk, greedy)
            counts = fd.last_sync_counts()
            check(counts["grid_barriers"] == 0 and counts["items"] == fd.item_count(qdec, config, B)
                  and counts["closed_waits"] <= counts["items"],
                  f"{tag}: the kernel's counters {counts}")
            samples, lg, draws = run["kernel"]
            ref = run["plain"]
            full = {side: _logit_readings(run[side][1], ref[1], Va)
                    for side in ("kernel", "f64", "control")}
            gp = F.pad(gum, (0, lg.shape[-1] - Va))
            mine = torch.stack([fd.sample_row(lg[i], gp[i], temp[:, None], topk[:, None], greedy)
                                for i in range(N)], dim=1)
            draws_equal = torch.equal(mine, draws)
            vs_plain = (draws == ref[2]).float().mean().item()
            check(bool(torch.isfinite(lg).all()) and full["kernel"]["rel_rms"] <= FUSED_FULL_RMS_TOL,
                  f"{tag}: full-depth logits relative RMS {full['kernel']['rel_rms']:.3e}")
            check(torch.equal(samples, run["forced"]), f"{tag}: forced tokens did not pass through")
            check(draws_equal, f"{tag}: a draw differs from the sampler on the kernel's logits")
            layer = {side: {k: 0.0 for k in FUSED_LAYER_LIMITS} for side in ("kernel", "f64", "control")}
            for l in range(L):
                r1 = _fused_run(one_layer(qdec, l), config, x0, c0, gum, temp, topk, greedy)
                for side in layer:
                    for k, x in _logit_readings(r1[side][1], r1["plain"][1], Va).items():
                        layer[side][k] = max(layer[side][k], x)
            log(f"{tag}: full depth logits differing / rel RMS: kernel {full['kernel']['share']:.3e}"
                f" / {full['kernel']['rel_rms']:.3e}, f64 {full['f64']['share']:.3e} / "
                f"{full['f64']['rel_rms']:.3e}, control {full['control']['share']:.3e} / "
                f"{full['control']['rel_rms']:.3e}; one layer (max over {L}): kernel "
                f"{layer['kernel']['share']:.3e} / {layer['kernel']['rel_rms']:.3e}, f64 "
                f"{layer['f64']['share']:.3e} / {layer['f64']['rel_rms']:.3e}, control "
                f"{layer['control']['share']:.3e} / {layer['control']['rel_rms']:.3e}, limits "
                f"{FUSED_LAYER_LIMITS['share']} / {FUSED_LAYER_LIMITS['rel_rms']}; draws == "
                f"sampler on own logits {draws_equal}; draws == plain draws {vs_plain:.4f}; "
                f"counters {counts}")
            for k, lim in FUSED_LAYER_LIMITS.items():
                check(layer["kernel"][k] <= lim, f"{tag}: one-layer logits {k} {layer['kernel'][k]:.3e} > {lim}")
            check(any(layer["control"][k] > lim for k, lim in FUSED_LAYER_LIMITS.items()),
                  f"{tag}: the one-layer limits do not see the f32-operand control")
            out[f"head{head_bits}_{mode}"] = dict(
                full=full, one_layer=layer, draws_equal=draws_equal, draws_vs_plain=vs_plain,
                sync_counts=counts,
                max_abs=(lg[..., :Va] - ref[1][..., :Va]).abs().max().item())
    timing = {}
    for head_bits, qdec in qdecs.items():
        args = (qdec, config, x0, c0, gum_s, temp, topk, False)
        ms = cuda_ms(lambda: fd.fused_decode_codebooks(*args), iters=10)
        timing[head_bits] = dict(ms=ms, bound=fused_bound(qdec, config, B))
        log(f"fused B={B} head{head_bits}: kernel {ms:.4f} ms per frame, bound "
            f"{timing[head_bits]['bound'][0]:.4f} ms ({timing[head_bits]['bound'][1]})")
    stages = fused_stage_us(qdecs[16], config, (x0, c0, gum_s, temp, topk, False))
    log(f"fused B={B} head16: stage us per pass (kernel trace, block 0 leaving each stage, mean "
        f"over positions 2..{N - 2}): " + ", ".join(f"{k} {v:.1f}" for k, v in stages.items()))
    log(f"fused B={B}: K2 {timing[16]['ms']:.4f} ms a frame (bf16 head) against its bound "
        f"{timing[16]['bound'][0]:.4f} ms: {timing[16]['ms'] / timing[16]['bound'][0]:.1f}x")
    args = (qdecs[16], config, x0, c0, gum_s, temp, topk, False, torch.full((B, N), -1, device=dev))
    plain_ms = cuda_ms(lambda: fd.decode_codebooks_reference(*args), iters=2, warmup=1)
    log(f"fused B={B}: plain version {plain_ms:.2f} ms per frame (bf16 head, sampled)")
    t16 = timing[16]
    return dict(err=max(v["max_abs"] for v in out.values()), ms=t16["ms"], plain_ms=plain_ms,
                library_ms=None, bound_ms=t16["bound"][0], bound_by=t16["bound"][1],
                ms_head8=timing[8]["ms"], bound_ms_head8=timing[8]["bound"][0],
                stage_us_per_pass=stages,
                shape=f"B={B} CSM-1B decoder, bf16 head, sampled", gates=out)


FUSED_STAGES = ("input", "qkv", "attention", "o_proj", "gate_up", "down", "final", "head", "draw")


def fused_stage_us(qdec, config, args) -> dict:
    """One frame with the kernel's trace (block 0's clock as it leaves each
    stage of the frame's list): µs per position of each stage kind, the
    layers' summed, averaged over positions 2 .. N-2 (position 0 has no head,
    position 1 follows the c0 draws, the last is the frame's tail); the c0
    draws and the whole frame besides.  With no grid barrier the stages of
    other blocks overlap block 0's, so these are block 0's times."""
    import torch

    from csm_tpu_torch.ops import fused_decoder as fd

    N, L = config.audio_num_codebooks, config.decoder.num_hidden_layers
    per = 5 * L + fd.PASS_EXTRA
    stamps = torch.zeros((fd.stage_count(N, L),), dtype=torch.int64, device="cuda")
    fd.fused_decode_codebooks(qdec, config, *args, stage_ns=stamps)
    d = stamps.diff().double().cpu() / 1e3  # d[s]: stage s (0: the c0 draws)
    out = {k: 0.0 for k in FUSED_STAGES}
    passes = range(2, N - 1)
    for p in passes:
        base = 1 + p * per
        for j in range(per):
            key = ("input" if j == 0 else FUSED_STAGES[1 + (j - 1) % 5] if j <= 5 * L
                   else FUSED_STAGES[6 + j - 5 * L - 1])
            out[key] += d[base + j].item() / len(passes)
    out["pass_total"] = sum(out.values())
    out["c0_draw"] = d[0].item()
    out["frame"] = (stamps[-1] - stamps[0]).item() / 1e3
    return out


def fused_bound(qdec, config, B: int):
    """The least time of one frame: 31 passes over the int8 decoder weights
    and their scales, 31 head slices at their Va real columns, the embedding
    rows the draws fetch, the noise and the other inputs and outputs once;
    operations at the bf16 rate."""
    N, Va = config.audio_num_codebooks, config.audio_vocab_size
    Dd = config.decoder.hidden_size
    passes = N - 1
    mats = [qdec["w"][k] for k in ("wqkv", "wo", "w_gu", "w_down")]
    w_bytes = passes * (nbytes(*mats) + nbytes(*qdec["s"].values()))
    head = qdec["audio_head"]
    h_bytes = passes * Dd * Va * head.element_size() + (passes * Va * 4 if "head_scale" in qdec else 0)
    emb_bytes = passes * B * Dd * qdec["proj_emb"].element_size()
    io_bytes = 4 * (N * B * Va + B * Va + B * Dd + 2 * B) + 8 * B * N
    n_flops = 2 * B * passes * (sum(m.numel() for m in mats) + Dd * Va)
    return bound_ms(w_bytes + h_bytes + emb_bytes + io_bytes, n_flops)


# ---------------------------------------------------------------------------
# Phase 6: end to end
# ---------------------------------------------------------------------------


def prompt(config, B: int, S: int, seed: int):
    """``[B, S, 33]`` prompts: 8 text frames then audio frames, row b
    left-padded by 3 * (b % 8) frames."""
    import numpy as np

    rng = np.random.default_rng(seed)
    N, Wd = config.audio_num_codebooks, config.frame_width
    ids = np.zeros((B, S, Wd), np.int64)
    mask = np.zeros((B, S, Wd), np.float32)
    for b in range(B):
        p = 3 * (b % 8)
        ids[b, p:p + 8, N] = rng.integers(1, config.text_vocab_size, 8)
        mask[b, p:p + 8, N] = 1
        ids[b, p + 8:, :N] = rng.integers(1, config.audio_vocab_size, (S - p - 8, N))
        mask[b, p + 8:, :N] = 1
    return ids, mask


def launch_counters():
    """The wrappers whose ``launches`` count each port kernel's launches."""
    from csm_tpu_torch.ops.bb_kernel import bb_decode_step, bb_decode_step_q, bb_decode_step_q4
    from csm_tpu_torch.ops.flash_attention import flash_fwd
    from csm_tpu_torch.ops.fused_decoder import fused_decode_codebooks

    return {"flash_fwd": flash_fwd, "bb_decode": bb_decode_step,
            "bb_decode_q": bb_decode_step_q, "bb_decode_q4": bb_decode_step_q4,
            "fused_decoder": fused_decode_codebooks}


def run_generate(model, ids, mask, n_frames: int, counters):
    import torch

    wrappers = launch_counters()
    model.generate(ids, mask, max_new_frames=2, greedy=True, stop_on_all_zeros=False)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.generate(ids, mask, max_new_frames=1, greedy=True, stop_on_all_zeros=False)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = model.generate(ids, mask, max_new_frames=n_frames, greedy=True,
                            stop_on_all_zeros=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    for k, v in launches.items():
        counters[k] += v
    return frames, dt, first, launches


# Kernel launches each tier must show over an F-frame call at batch B: the
# prefill's 16 flash launches, one backbone step for each frame after the
# first, one fused-decoder call per frame (speculative tier: one per round).
def expected_launches(tier: str, B: int, F: int) -> dict:
    return {
        "plain": {"bb_decode": 0, "bb_decode_q": 0, "bb_decode_q4": 0, "fused_decoder": 0},
        "exact": {"bb_decode": F - 1, "bb_decode_q": 0, "bb_decode_q4": 0},
        "quantize": {"bb_decode": 0, "bb_decode_q": F - 1, "bb_decode_q4": 0, "fused_decoder": F},
        "quantize4": {"bb_decode": 0, "bb_decode_q": 0, "bb_decode_q4": F - 1, "fused_decoder": F},
    }[tier]


def specdec_rounds(model, ids, mask, n_frames: int) -> dict:
    """The speculative tier over ``n_frames`` greedy frames, each frame's
    rounds recorded and its output held to the fixed point of the verify
    pass."""
    from csm_tpu_torch import generation
    from csm_tpu_torch.ops import fused_decoder as fd
    from csm_tpu_torch.ops import specdec

    rounds, fixed = [], []
    orig = generation.decode_frame_specdec

    def traced(params, qdec, config, last_h, c0_logits, gumbel, temperature, topk, greedy, **kw):
        tokens, r = orig(params, qdec, config, last_h, c0_logits, gumbel, temperature, topk,
                         greedy, return_rounds=True, **kw)
        t, k, _ = fd.row_params(last_h.shape[0], config.audio_vocab_size, temperature, topk,
                                gumbel)
        again = specdec.verify_codebooks(params, config, last_h, tokens, gumbel, t[:, None],
                                         k[:, None], greedy)
        rounds.append(r)
        fixed.append(bool((again == tokens).all()))
        return tokens

    generation.decode_frame_specdec = traced
    try:
        model.generate(ids, mask, max_new_frames=n_frames, greedy=True, stop_on_all_zeros=False)
    finally:
        generation.decode_frame_specdec = orig
    return dict(rounds=rounds, fixed_point=fixed)


E2E_FRAMES = 16
E2E_CKPT = os.path.join(REPO, "csm_tpu_torch", "_build", "smoke_ckpt")
E2E_RUNS = (("plain", 1), ("plain", 8), ("exact", 1), ("exact", 8),
            ("quantize", 1), ("quantize", 8), ("quantize", 32),
            ("quantize4", 1), ("quantize4", 8), ("quantize4", 32))


def end_to_end(model, results):
    import torch

    from csm_tpu_torch import CSMModel

    cfg = model.config
    # Kept for phase 16, which removes it.
    t0 = time.perf_counter()
    model.save_pretrained(E2E_CKPT)
    t1 = time.perf_counter()
    loaded = CSMModel.from_pretrained(E2E_CKPT, dtype=torch.bfloat16)
    t2 = time.perf_counter()
    flat_a = _leaves(model.params)
    flat_b = _leaves(loaded.params)
    same = flat_a.keys() == flat_b.keys() and all(torch.equal(flat_a[k], flat_b[k]) for k in flat_a)
    log(f"save_pretrained {t1 - t0:.1f} s, from_pretrained {t2 - t1:.1f} s, params equal: {same}")
    check(same, "save_pretrained -> from_pretrained changed the parameters")
    del model
    torch.cuda.empty_cache()

    S, F = 64, E2E_FRAMES
    counters = {k: 0 for k in launch_counters()}
    ids, mask = prompt(cfg, 32, S, seed=1)
    e2e = results["e2e"]
    tier = None
    for name, B in E2E_RUNS:
        if name != tier:
            tier = name
            if name == "exact":
                loaded.exact()
            elif name == "quantize":
                loaded.quantize()
            elif name == "quantize4":
                loaded.quantize(bits=4)
        frames, dt, first, launches = run_generate(loaded, ids[:B], mask[:B], F, counters)
        fps = B * F / dt
        step_ms = (dt - first) / (F - 1) * 1e3
        log(f"generate {name} B={B}: {tuple(frames.shape)} in {dt:.3f} s = {fps:.2f} frames/s "
            f"(prefill included); first frame {first * 1e3:.1f} ms, then {step_ms:.1f} ms "
            f"per frame step; launches {launches}")
        if frames.shape != (B, F, cfg.audio_num_codebooks):
            check(False, f"{name} B={B}: frames shape {frames.shape}")
            continue
        check(0 <= frames.min() and frames.max() < cfg.audio_vocab_size,
              f"{name} B={B}: token out of range")
        check(launches["flash_fwd"] > 0, f"{name} B={B}: the prefill did not run the flash kernel")
        for k, want in expected_launches(name, B, F).items():
            check(launches[k] == want, f"{name} B={B}: {launches[k]} {k} launches, want {want}")
        if name == "exact":
            check(launches["fused_decoder"] >= F, f"exact B={B}: the draft kernel ran "
                  f"{launches['fused_decoder']} times over {F} frames")
        e2e[f"{name}_B{B}"] = dict(frames_per_s=fps, first_frame_ms=first * 1e3,
                                   frame_step_ms=step_ms, launches=launches)
        if name == "exact":
            rec = specdec_rounds(loaded, ids[:B], mask[:B], 8)
            log(f"exact B={B}: speculative rounds per frame {rec['rounds']}; every frame a fixed "
                f"point of the verify pass: {all(rec['fixed_point'])}")
            check(all(rec["fixed_point"]), f"exact B={B}: a frame is not a fixed point of verify")
            e2e[f"exact_B{B}"]["specdec"] = rec
            if B == 1:
                results["profile_exact_B1"] = profile_generate(loaded, ids[:1], mask[:1], 8, "exact")
        if name in ("quantize", "quantize4") and B <= 8:
            results[f"profile_{name}_B{B}"] = profile_generate(loaded, ids[:B], mask[:B], 8, name)
    return counters, loaded


# The port's CUDA kernels by their exact names.  They sit in an anonymous
# namespace at file scope, so the profiler names them
# "[void ](anonymous namespace)::<name><...>(...)"; PyTorch's kernels (its
# reduce_kernel among them) are named inside at::.
# K3, K5a and K5b are two kernels each, by operand type: the bf16 ones on
# the tensor cores (every profiled path runs bf16), the fp32 ones on the CUDA
# cores (the fp32 golden fixture and the fp32 checks of phases 2, 7 and 13).
PORT_KERNELS = {
    "flash_fwd": ("flash_fwd_wgmma_kernel",),
    "flash_fwd_f32": ("flash_fwd_kernel",),
    "flash_bwd_dq": ("flash_bwd_dq_wgmma_kernel",),
    "flash_bwd_dq_f32": ("flash_bwd_dq_kernel",),
    "flash_bwd_dkv": ("flash_bwd_dkv_wgmma_kernel",),
    "flash_bwd_dkv_f32": ("flash_bwd_dkv_kernel",),
    "bb_decode": ("bb_step_kernel",),
    "bb_decode_q": ("bbq_step_kernel",),
    "fused_decoder": ("fused_decoder_kernel",),
}
# The groups each tier's profile must show.  The int8 and int4 steps share
# their source and kernel names, so K1q-4's kernels count under
# "bb_decode_q" in a profile (the launch counters tell the tiers apart).
PROFILED = {"exact": ("flash_fwd", "bb_decode", "fused_decoder"),
            "quantize": ("flash_fwd", "bb_decode_q", "fused_decoder"),
            "quantize4": ("flash_fwd", "bb_decode_q", "fused_decoder"),
            "serve": ("bb_decode_q", "fused_decoder"),
            "train": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
_PORT_NAME = re.compile(r"^(?:void )?\(anonymous namespace\)::(\w+)[<(]")


def port_kernel(name: str):
    """``(group, kernel)`` of one of the port's kernels, else None."""
    m = _PORT_NAME.match(name)
    for group, kernels in PORT_KERNELS.items():
        if m and m.group(1) in kernels:
            return group, m.group(1)
    return None


def device_breakdown(prof, required, label: str, wall_ms: float, units: int, unit: str) -> dict:
    """Device time by kernel from a torch.profiler run, split into the port's
    kernel groups and everything else; fails if a kernel of the ``required``
    groups shows no device time under its exact name."""
    import torch

    by_name = {}
    for e in prof.events():
        # Annotations (such as the optimizer's step range) span kernels that
        # are counted on their own.
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
            n, ms = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    busy = sum(ms for _, ms in by_name.values())
    groups = {k: [0, 0.0] for k in (*PORT_KERNELS, "other")}
    seen = set()
    for name, (n, ms) in by_name.items():
        hit = port_kernel(name)
        g = hit[0] if hit else "other"
        if hit:
            seen.add(hit[1])
        groups[g][0] += n
        groups[g][1] += ms
    missing = {k for g in required for k in PORT_KERNELS[g]} - seen
    check(not missing, f"profile {label}: no device time under the port's kernel names {sorted(missing)}")
    n_kernels = sum(n for n, _ in by_name.values())
    log(f"profile {label}: wall {wall_ms:.1f} ms under the profiler, device busy {busy:.1f} ms "
        f"({busy / wall_ms:.1%}), {n_kernels / units:.0f} kernels per {unit}; device ms "
        "(launches) by group " + ", ".join(f"{k} {ms:.2f} ({n})" for k, (n, ms) in groups.items()))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (n, ms) in top:
        log(f"  {ms:8.2f} ms {n:6d}x  {name[:110]}")
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                device_ms_by_group={k: ms for k, (_, ms) in groups.items()},
                launches_by_group={k: n for k, (n, _) in groups.items()}, n_kernels=n_kernels,
                top=[dict(name=k[:160], count=n, ms=ms) for k, (n, ms) in top])


def profile_generate(model, ids, mask, n_frames: int, tier: str) -> dict:
    """Where a generate call's time goes: device time by kernel under
    torch.profiler, split into the port's kernels and everything else, beside
    the host's wall time for the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    kw = dict(greedy=True, stop_on_all_zeros=False)
    model.generate(ids, mask, max_new_frames=2, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.generate(ids, mask, max_new_frames=n_frames, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    B = ids.shape[0]
    rec = device_breakdown(prof, PROFILED[tier], f"{tier} B={B}, {n_frames} frames", wall_ms,
                           n_frames, "frame")
    return dict(tier=tier, frames=n_frames, B=B, kernels_per_frame=rec["n_kernels"] / n_frames,
                **rec)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def golden_on_card():
    """The committed tiny checkpoint on the card in fp32 against the frozen
    outputs of the original torch reference."""
    import numpy as np

    from csm_tpu_torch import CSMModel
    from csm_tpu_torch.ops.flash_attention import flash_fwd

    fix = os.path.join(REPO, "tests", "fixtures", "tiny_golden")
    model = CSMModel.from_pretrained(fix)
    data = np.load(os.path.join(fix, "golden.npz"))
    flash_fwd.launches = 0
    out = model.forward(data["input_ids"], data["attention_mask"].astype(np.float32),
                        labels=data["labels"])
    np.testing.assert_allclose(out.logits.cpu().numpy(), data["c0_logits_last"],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(out.loss), float(data["loss"]), rtol=2e-4)
    frames = model.generate(data["input_ids"], data["attention_mask"].astype(np.float32),
                            max_new_frames=int(data["greedy_frames"].shape[1]),
                            stop_on_all_zeros=False, greedy=True)
    same = np.array_equal(frames, data["greedy_frames"])
    check(same, "tiny golden greedy frames differ on the card")
    launches = flash_fwd.launches
    check(launches > 0, "the fp32 tiny golden forward and prefill did not run the flash kernel")
    log(f"tiny golden fixture on the card (fp32, flash kernel launched {launches} times): "
        f"logits and loss match, greedy frames match: {same}")


# ---------------------------------------------------------------------------
# Phase 12: serving at full width
# ---------------------------------------------------------------------------

SERVE_SLOTS, SERVE_WINDOW, SERVE_BUDGET, SERVE_REQUESTS, SERVE_PREFIX = 8, 256, 12, 10, 32
# Streamed against offline decode of the same frames: the CPU test's
# tolerance (tests/test_torch_codec.py), fp32 convolutions (TF32 off).
WAVE_RTOL, WAVE_ATOL = 1e-4, 1e-5
SERVE_PARAMS = {2: dict(greedy=True), 4: dict(temperature=0.7, topk=10),
                6: dict(temperature=1.0, topk=30)}


def serve_prompt(cfg, S: int, seed: int):
    """A ``[1, S, 33]`` request: 8 text frames, then audio (numpy)."""
    return prompt(cfg, 1, S, seed)


class CodecClock:
    """Host time and count of every streaming decoder feed (each ends in a
    host read of its PCM, so the clock sees the device work)."""

    def __init__(self):
        from csm_tpu_torch.codec import streaming

        self.mod, self.orig = streaming.StreamingMimiDecoder, streaming.StreamingMimiDecoder.feed
        self.seconds, self.frames = 0.0, 0
        clock = self

        def feed(dec, codes):
            t0 = time.perf_counter()
            out = clock.orig(dec, codes)
            clock.seconds += time.perf_counter() - t0
            clock.frames += out.shape[0] * out.shape[-1] // 1920
            return out

        self.mod.feed = feed

    def close(self):
        self.mod.feed = self.orig


def serving_full_width(model, cfg, codec, bits: int) -> dict:
    """``CSMServer`` at CSM-1B width on ``quantize(bits)``'s bundles with a
    per-slot streamed Mimi decoder: a 32-frame prefix registered, 10
    requests of 16 + 8 (i mod 24) frames (the odd ones continue the prefix;
    one greedy, two with their own temperature / top-k), 9 submitted at
    once into 8 slots, two steps, a late join, a cancel, one step_many(4)
    chunk, then single steps until idle; a profiled window of 3 steps."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from csm_tpu_torch.serving import CSMServer

    model.quantize(bits=bits)
    server = CSMServer(model.params, cfg, n_slots=SERVE_SLOTS, window=SERVE_WINDOW,
                       temperature=0.8, topk=50, max_new_frames=SERVE_BUDGET, qdec=model._qdec,
                       qbb=model._qbb, qsb=model._qsb, codec=codec)
    tag = f"serve int{bits}"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pid = server.register_prefix(*serve_prompt(cfg, SERVE_PREFIX, seed=300))
    torch.cuda.synchronize()
    prefix_ms = (time.perf_counter() - t0) * 1e3
    wrappers = launch_counters()
    for w in wrappers.values():
        w.launches = 0
    clock = CodecClock()
    admit = {"fresh": [], "prefix": []}
    step_ms, codec_step_ms = [], []
    rids = []
    prof_rec, profiler_s = None, 0.0
    try:
        t_start = time.perf_counter()

        def submit(i):
            kw = dict(SERVE_PARAMS.get(i, {}), seed=500 + i)
            if i % 2:
                kw["prefix_id"] = pid
            free = len(server.active_slots) < SERVE_SLOTS
            torch.cuda.synchronize()
            t = time.perf_counter()
            rids.append(server.submit(*serve_prompt(cfg, 16 + 8 * (i % 24), seed=400 + i), **kw))
            torch.cuda.synchronize()
            if free:
                admit["prefix" if i % 2 else "fresh"].append((time.perf_counter() - t) * 1e3)

        def step():
            t, c = time.perf_counter(), clock.seconds
            alive = server.step()
            step_ms.append((time.perf_counter() - t) * 1e3)
            codec_step_ms.append((clock.seconds - c) * 1e3)
            return alive

        for i in range(SERVE_REQUESTS - 1):
            submit(i)
        queued_at_start = server.stats()["queued"]
        step()
        step()
        submit(SERVE_REQUESTS - 1)  # the late join, queued behind the full slots
        cancelled = rids[5]
        server.cancel(cancelled)  # frees a slot: the queue's head is admitted
        t = time.perf_counter()
        server.step_many(4)
        chunk_ms = (time.perf_counter() - t) * 1e3
        n_steady = 0
        while server.active_slots or server.stats()["queued"]:
            if n_steady == 3:
                torch.cuda.synchronize()
                t_prof = time.perf_counter()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t = time.perf_counter()
                    for _ in range(3):
                        step()
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t) * 1e3
                prof_rec = device_breakdown(prof, PROFILED["serve"], f"{tag}, 3 server steps",
                                            wall_ms, 3, "step")
                # The profiler's start, stop and event processing are not serving time.
                profiler_s = time.perf_counter() - t_prof - wall_ms / 1e3
            else:
                step()
            n_steady += 1
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t_start - profiler_s
    finally:
        clock.close()
    launches = {k: w.launches for k, w in wrappers.items()}
    hop = 2 * codec.config.total_stride
    frames_total = sum(server.results[r].shape[0] for r in rids)
    for r in rids:
        fr, pcm = server.results.get(r), server.audio.get(r)
        done = fr is not None and pcm is not None
        want = (fr.shape[0] < SERVE_BUDGET) if r == cancelled else (fr.shape[0] == SERVE_BUDGET)
        check(done and want and pcm.shape == (fr.shape[0] * hop,),
              f"{tag}: request {r} frames {None if fr is None else fr.shape}, PCM "
              f"{None if pcm is None else pcm.shape}")
        check(done and 0 <= fr.min() and fr.max() < cfg.audio_vocab_size,
              f"{tag}: request {r} token out of range")
    wave = {}
    for r in (rids[0], rids[1]):
        off = codec.decode(server.results[r].T)
        err = float(np.abs(server.audio[r] - off).max())
        ok = bool(np.allclose(server.audio[r], off, rtol=WAVE_RTOL, atol=WAVE_ATOL))
        wave[r] = dict(max_abs=err, max_offline=float(np.abs(off).max()), ok=ok)
        check(ok, f"{tag}: request {r} streamed PCM differs from the offline decode by {err:.3e}")
    for k in (f"bb_decode_q{'4' if bits == 4 else ''}", "fused_decoder", "flash_fwd"):
        check(launches[k] > 0, f"{tag}: {k} never launched ({launches})")
    check(prof_rec is not None, f"{tag}: the server went idle before its profiled window")
    codec_ms = clock.seconds * 1e3 / max(clock.frames, 1)

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    med = median(step_ms)
    bare = median([a - c for a, c in zip(step_ms, codec_step_ms)])
    rec = dict(
        bits=bits, requests=len(rids), cancelled=cancelled, queued_at_start=queued_at_start,
        frames=frames_total, wall_s=wall_s, frames_per_s=frames_total / wall_s,
        step_ms_median=med, step_ms=step_ms, step_many_4_ms=chunk_ms,
        codec_ms_per_frame_per_slot=codec_ms, codec_realtime_factor=80.0 / codec_ms,
        codec_frames=clock.frames, codec_s=clock.seconds,
        codec_step_ms=codec_step_ms, step_ms_without_codec=bare,
        admission_ms=admit, prefix_register_ms=prefix_ms, launches=launches, wave=wave,
        stats=server.stats(), profile=prof_rec)
    log(f"{tag}: {len(rids)} requests ({queued_at_start} queued at start, request {cancelled} "
        f"cancelled), {frames_total} frames in {wall_s:.2f} s = {rec['frames_per_s']:.1f} "
        f"frames/s; server step median {med:.1f} ms (step_many(4) {chunk_ms:.1f} ms); Mimi "
        f"{codec_ms:.2f} ms per frame per slot ({rec['codec_realtime_factor']:.1f}x real time), "
        f"median step less its Mimi time {bare:.1f} ms; admission fresh "
        + ", ".join(f"{x:.1f}" for x in admit["fresh"]) + " ms, through the prefix "
        + ", ".join(f"{x:.1f}" for x in admit["prefix"]) + f" ms (prefix registered in "
        f"{prefix_ms:.1f} ms); launches {launches}; streamed vs offline PCM "
        + ", ".join(f"{k}: {v['max_abs']:.2e} of {v['max_offline']:.2e}" for k, v in wave.items()))
    del server
    torch.cuda.empty_cache()
    return rec


def tf32_pcm_reading(codec, cfg) -> dict:
    """Phase 12's streamed-vs-offline PCM gate with ``cudnn.allow_tf32`` at
    torch's default (True), as ``CSMServer`` runs Mimi when its caller sets
    nothing: 12 frames of random codes (seed 0) fed one at a time to a
    batch-1 streaming decoder against one offline decode.  The setting is
    restored afterwards."""
    import numpy as np
    import torch

    from csm_tpu_torch.codec.streaming import StreamingMimiDecoder

    codes = np.random.default_rng(0).integers(0, codec.config.codebook_size,
                                              (SERVE_BUDGET, cfg.audio_num_codebooks))
    K = codec.num_codebooks
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        dec = StreamingMimiDecoder(codec, batch=1)
        streamed = np.concatenate([np.asarray(dec.feed(c[None, :K, None])).reshape(-1)
                                   for c in codes])
        off = np.asarray(codec.decode(codes.T)).reshape(-1)
    finally:
        torch.backends.cudnn.allow_tf32 = before
    err = float(np.abs(streamed - off).max()) if streamed.shape == off.shape else float("inf")
    ok = streamed.shape == off.shape and bool(np.allclose(streamed, off, rtol=WAVE_RTOL,
                                                           atol=WAVE_ATOL))
    log(f"Mimi with cudnn.allow_tf32 at torch's default (True): streamed vs offline PCM of "
        f"{SERVE_BUDGET} frames, max |diff| {err:.3e} of {float(np.abs(off).max()):.3e} (rtol "
        f"{WAVE_RTOL}, atol {WAVE_ATOL}): {'within' if ok else 'outside'} phase 12's gate")
    check(ok, f"Mimi under default TF32: streamed PCM differs from the offline decode by {err:.3e}")
    return dict(max_abs=err, max_offline=float(np.abs(off).max()), ok=ok)


# ---------------------------------------------------------------------------
# Phase 7: flash backward kernels
# ---------------------------------------------------------------------------

# Limits of the backward kernels against the plain backward run on the
# kernel's own forward output and log-sum-exp, per operand type: relative RMS
# of dq / dk / dv.  Both round dS and P to the operand type at the same
# points and sum in fp32; the fp32 kernels sum each product in key (or
# query) order with FMAs, as cuBLAS does along K, while the bf16 K5a and K5b
# sum on the tensor cores in their own order.  The limits leave room for another summation order (a flipped bf16
# rounding is one step of a value); a wrong mask or head gives 0.1-1.
FLASH_BWD_TOL = {"bfloat16": 2e-3, "float32": 1e-5}
# max |lse - plain lse| on live rows: fp32 sums of bf16-exact products.
FLASH_LSE_TOL = 1e-4
# (B, S) at CSM-1B training shapes; row b left-padded by 16 + 100 b frames.
FLASH_BWD_SHAPES = ((1, 2048), (4, 512))


def check_flash_bwd(B: int, S: int, gen, dtype_name: str, nq: int = 32, nkv: int = 8) -> dict:
    """K3 with LSE, K5a and K5b against their plain versions: lse on live
    rows, relative RMS of the gradients, dead rows exactly zero, two runs
    bitwise equal; then times, bounds and the SDPA yardsticks.  ``nq`` /
    ``nkv``: CSM-1B's heads, or a rank's head shard."""
    import torch

    from csm_tpu_torch.ops import flash_attention as fa

    hd = 64
    g = nq // nkv
    dev, dtype = "cuda", getattr(torch, dtype_name)
    tag = f"flash bwd {dtype_name} B={B} S={S} heads {nq}/{nkv}"
    q, do = (torch.randn((B, S, nq, hd), generator=gen, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn((B, S, nkv, hd), generator=gen, device=dev).to(dtype) for _ in range(2))
    valid = torch.ones((B, S), dtype=torch.int32, device=dev)
    for b in range(B):
        valid[b, :16 + 100 * b] = 0
    live = valid.cumsum(1) > 0  # rows that see a valid key

    out, lse = fa.flash_fwd(q, k, v, valid, True, with_lse=True)
    ref_out, ref_lse = fa.flash_attention_reference(q, k, v, valid, True, return_lse=True)
    lse_err = (lse - ref_lse).abs().transpose(1, 2)[live].max().item()
    dead_lse = bool((lse.transpose(1, 2)[~live] == fa.NEG_INF).all())
    out_err = (out.float() - ref_out.float()).abs()[live].max().item()
    check(lse_err <= FLASH_LSE_TOL and dead_lse, f"{tag}: lse error {lse_err:.3e}, dead rows "
          f"exactly NEG_INF {dead_lse}")
    check(out_err <= FLASH_TOL[dtype_name], f"{tag}: forward output error {out_err:.3e}")

    got = fa.flash_bwd(q, k, v, valid, out, lse, do)
    again = fa.flash_bwd(q, k, v, valid, out, lse, do)
    want = fa.flash_attention_bwd_reference(q, k, v, valid, out, lse, do)
    masked = fa.flash_bwd(q, k, v, valid, out, lse, do * live[:, :, None, None].to(dtype))
    torch.cuda.synchronize()
    rel = {n: rel_rms(a.float(), w.float()) for n, a, w in zip(("dq", "dk", "dv"), got, want)}
    max_abs = max((a.float() - w.float()).abs().max().item() for a, w in zip(got, want))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    dead_zero = bool((got[0][~live] == 0).all()) and all(
        torch.equal(a, b) for a, b in zip(got[1:], masked[1:]))
    finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
    tol = FLASH_BWD_TOL[dtype_name]
    log(f"{tag}: lse max err (live) {lse_err:.3e}, dead rows NEG_INF {dead_lse}; relative RMS vs "
        f"plain " + ", ".join(f"{n} {x:.3e}" for n, x in rel.items()) + f" (limit {tol}); "
        f"dead rows exactly zero {dead_zero}; two runs bitwise equal {same}")
    for n, x in rel.items():
        check(finite and x <= tol, f"{tag}: {n} relative RMS {x:.3e} > {tol}")
    check(dead_zero, f"{tag}: dead rows do not contribute exactly zero")
    check(same, f"{tag}: two runs of the backward kernels differ")

    delta = fa._delta(out, do)
    ms = dict(
        fwd=cuda_ms(lambda: fa.flash_fwd(q, k, v, valid, True, with_lse=True), iters=5),
        dq=cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, valid, do, lse, delta), iters=5),
        dkv=cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, valid, do, lse, delta), iters=5),
    )
    plain = dict(
        fwd=cuda_ms(lambda: fa.flash_attention_reference(q, k, v, valid, True, return_lse=True),
                    iters=2, warmup=1),
        bwd=cuda_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, valid, out, lse, do),
                    iters=2, warmup=1),
    )
    # SDPA on the same inputs: K/V expanded over the group, the same mask as
    # an additive NEG_INF bias (finite, so dead rows stay finite).
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ok = valid.bool()[:, None, None, :] & torch.ones((S, S), dtype=torch.bool, device=dev).tril()
    bias = torch.where(ok, 0.0, fa.NEG_INF).to(dtype)
    qh = q.transpose(1, 2).detach().requires_grad_(True)
    kh = k.transpose(1, 2).repeat_interleave(g, dim=1).detach().requires_grad_(True)
    vh = v.transpose(1, 2).repeat_interleave(g, dim=1).detach().requires_grad_(True)
    with torch.no_grad():
        lib_fwd = cuda_ms(lambda: sdpa(qh, kh, vh, attn_mask=bias), iters=5)
    o = sdpa(qh, kh, vh, attn_mask=bias)
    go = do.transpose(1, 2)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(o, (qh, kh, vh), go, retain_graph=True),
                      iters=5)
    del o, qh, kh, vh, bias

    # What this data needs: each live (row, valid key <= row) pair per head;
    # q, dO and out of live rows, k and v of valid keys, lse and delta of
    # live rows, the validity flags, the outputs whole.
    pairs = int(valid.cumsum(1).sum())
    n_live, n_keys = int(live.sum()), int(valid.sum())
    esz = q.element_size()
    q_rows = n_live * nq * hd * esz
    kv_rows = n_keys * nkv * hd * esz
    stats = n_live * nq * 4
    flags = B * S * valid.element_size()
    bounds = dict(
        fwd=bound_ms(q_rows + 2 * kv_rows + flags + nbytes(out, lse), 4 * hd * nq * pairs,
                     dtype_name),
        dq=bound_ms(2 * q_rows + 2 * kv_rows + 2 * stats + flags + nbytes(got[0]),
                    6 * hd * nq * pairs, dtype_name),
        dkv=bound_ms(2 * q_rows + 2 * kv_rows + 2 * stats + flags + nbytes(*got[1:]),
                     8 * hd * nq * pairs, dtype_name),
    )
    log(f"{tag}: K3+lse {ms['fwd']:.4f} ms (bound {bounds['fwd'][0]:.5f}, {bounds['fwd'][1]}), "
        f"K5a {ms['dq']:.4f} ms (bound {bounds['dq'][0]:.5f}), K5b {ms['dkv']:.4f} ms (bound "
        f"{bounds['dkv'][0]:.5f}); plain forward {plain['fwd']:.3f} ms, backward "
        f"{plain['bwd']:.3f} ms; SDPA forward {lib_fwd:.4f} ms, backward {lib_bwd:.4f} ms; "
        f"{pairs} causal pairs per head")
    shape = f"B={B} S={S} nq={nq} nkv={nkv} hd={hd} {dtype_name}, causal, left-padded"
    return dict(
        lse_err=lse_err, out_err=out_err, rel_rms=rel, max_abs=max_abs, bitwise_equal=same,
        dead_rows_zero=dead_zero, pairs=pairs, shape=shape,
        fwd=dict(err=out_err, ms=ms["fwd"], plain_ms=plain["fwd"], library_ms=lib_fwd,
                 bound_ms=bounds["fwd"][0], bound_by=bounds["fwd"][1]),
        dq=dict(err=max_abs, ms=ms["dq"], plain_ms=plain["bwd"], library_ms=lib_bwd,
                bound_ms=bounds["dq"][0], bound_by=bounds["dq"][1]),
        dkv=dict(err=max_abs, ms=ms["dkv"], plain_ms=plain["bwd"], library_ms=lib_bwd,
                 bound_ms=bounds["dkv"][0], bound_by=bounds["dkv"][1]),
    )


# ---------------------------------------------------------------------------
# Phase 8: training at full width
# ---------------------------------------------------------------------------

TRAIN_S = 2048
TRAIN_STEPS = 4
# Gross limits on the first step's loss and grad norm, flash kernels against
# plain attention, bf16 weights: two correct bf16 evaluations of 16 layers
# drift apart (phase 3), so this catches gross faults only.
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GNORM_RTOL = 5e-2
TRAINER_S = 256


def train_counters() -> dict:
    from csm_tpu_torch.ops import flash_attention as fa

    return {"flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
            "flash_bwd_dkv": fa.flash_bwd_dkv}


def _timed_step(step, state, batch):
    import torch

    wrappers = train_counters()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, None, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return state, {k: float(v) for k, v in m.items()}, dt, {k: w.launches for k, w in wrappers.items()}


def train_full_width(cfg) -> dict:
    """4 steps of a random bf16 CSM-1B on a 2048-frame synthetic
    conversation (``max_dec = S // 16 + 1``, remat ``"auto"``), with the
    first step also run through plain attention; then a ``torch.profiler``
    breakdown of one step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from csm_tpu_torch.models import csm
    from csm_tpu_torch.train import make_optimizer, make_train_step
    from csm_tpu_torch.train.loop import map_tree
    from csm_tpu_torch.utils.synthetic import synthetic_conversation_batch

    L = cfg.backbone.num_hidden_layers
    params = csm.init_params(cfg, 0, torch.bfloat16, "cuda")
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in synthetic_conversation_batch(cfg, TRAIN_S, seed=0).items()}
    max_dec = TRAIN_S // 16 + 1
    opt = make_optimizer(5e-6, total_steps=100)

    plain_state = opt.init(map_tree(torch.clone, params))
    plain_step = make_train_step(cfg, opt, max_dec, remat=True, remat_policy="auto",
                                 use_flash=False)
    plain_state, plain_m, _, plain_launches = _timed_step(plain_step, plain_state, batch)
    plain_state, _, plain_dt, _ = _timed_step(plain_step, plain_state, batch)  # timed, warm
    del plain_state
    torch.cuda.empty_cache()
    check(not any(plain_launches.values()), f"use_flash=False launched {plain_launches}")

    state = opt.init(params)
    step = make_train_step(cfg, opt, max_dec, remat=True, remat_policy="auto")
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for i in range(TRAIN_STEPS):
        state, m, dt, launches = _timed_step(step, state, batch)
        runs.append(dict(ms=dt * 1e3, launches=launches, **m))
        log(f"train S={TRAIN_S} step {i}: {dt * 1e3:.1f} ms, loss {m['loss']:.4f} (backbone "
            f"{m['backbone_loss']:.4f}, decoder {m['decoder_loss']:.4f}), grad norm "
            f"{m['grad_norm']:.4f}, launches {launches}")
        check(all(math.isfinite(m[k]) for k in m), f"train step {i}: non-finite metrics {m}")
        want = {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L}  # "auto" -> "dots"
        check(launches == want, f"train step {i}: launches {launches}, want {want}")
    peak = torch.cuda.max_memory_allocated()
    step_ms = sorted(r["ms"] for r in runs[1:])[len(runs[1:]) // 2]
    first = runs[0]
    d_loss = abs(first["loss"] - plain_m["loss"]) / abs(plain_m["loss"])
    d_gn = abs(first["grad_norm"] - plain_m["grad_norm"]) / abs(plain_m["grad_norm"])
    log(f"train S={TRAIN_S}: median step {step_ms:.1f} ms (last {TRAIN_STEPS - 1}), peak memory "
        f"{peak / 2**30:.2f} GiB; plain attention {plain_dt * 1e3:.1f} ms a step (its second), "
        f"first step loss {plain_m['loss']:.4f}, grad norm {plain_m['grad_norm']:.4f}: relative "
        "difference "
        f"loss {d_loss:.2e} (limit {TRAIN_LOSS_RTOL}), grad norm {d_gn:.2e} (limit "
        f"{TRAIN_GNORM_RTOL})")
    check(d_loss <= TRAIN_LOSS_RTOL and d_gn <= TRAIN_GNORM_RTOL,
          f"train: flash vs plain attention first step loss {d_loss:.2e}, grad norm {d_gn:.2e}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, None, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof_rec = device_breakdown(prof, PROFILED["train"], f"train step S={TRAIN_S}", wall_ms, 1,
                                "step")
    del state, prof
    torch.cuda.empty_cache()
    launches = {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]}
    return dict(params=params, launches=launches, record=dict(
        steps=runs, median_step_ms=step_ms, peak_memory_bytes=peak,
        plain_attention=dict(second_step_ms=plain_dt * 1e3, first_step=plain_m),
        loss_rel_diff=d_loss, grad_norm_rel_diff=d_gn, profile=prof_rec))


class SyntheticItems:
    """``n`` synthetic conversations of ``S`` frames as dataset items."""

    amortization_ratio = 16

    def __init__(self, cfg, n: int, S: int, seed: int):
        from csm_tpu_torch.utils.synthetic import synthetic_conversation_batch

        self.data = synthetic_conversation_batch(cfg, S, batch=n, seed=seed)

    def __len__(self):
        return self.data["input_ids"].shape[1]

    def __getitem__(self, i):
        return {k: v[0, i] for k, v in self.data.items()}


def trainer_full_width(cfg, params) -> dict:
    """``CSMTrainer`` at full width, S = 256: accum 2 for 2 steps,
    ``save_checkpoint``, a resume onto other weights, ``evaluate`` before and
    after."""
    import torch

    from csm_tpu_torch.data import CSMDataCollator
    from csm_tpu_torch.models import csm
    from csm_tpu_torch.train import CSMTrainer, TrainingArguments

    out_dir = os.path.join(REPO, "csm_tpu_torch", "_build", "train_smoke")
    shutil.rmtree(out_dir, ignore_errors=True)
    args = TrainingArguments(
        output_dir=out_dir, learning_rate=1e-5, per_device_train_batch_size=1,
        gradient_accumulation_steps=2, max_seq_length=TRAINER_S, save_strategy="no",
        report_to="none")
    data = dict(train_dataset=SyntheticItems(cfg, 4, TRAINER_S, 1),
                eval_dataset=SyntheticItems(cfg, 3, TRAINER_S, 2),
                data_collator=CSMDataCollator(text_pad_token_id=0))
    try:
        trainer = CSMTrainer(cfg, params, args, device="cuda", **data)
        for w in train_counters().values():
            w.launches = 0
        t0 = time.perf_counter()
        last = trainer.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = {k: w.launches for k, w in train_counters().items()}
        eval_a = trainer.evaluate()
        t0 = time.perf_counter()
        trainer.save_checkpoint(trainer.state.step)
        save_s = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, fs in os.walk(out_dir) for f in fs)
        keep = {k: trainer.state.params[k].detach().clone() for k in ("projection", "audio_head")}
        steps = trainer.state.step
        del trainer
        torch.cuda.empty_cache()

        other = csm.init_params(cfg, 1, torch.bfloat16, "cuda")
        resumed = CSMTrainer(cfg, other, dataclasses.replace(args, resume_from_checkpoint=True),
                             device="cuda", **data)
        t0 = time.perf_counter()
        at = resumed._maybe_resume()
        load_s = time.perf_counter() - t0
        same = all(torch.equal(resumed.state.params[k].detach(), v) for k, v in keep.items())
        eval_b = resumed.evaluate()
        del resumed, other
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        torch.cuda.empty_cache()
    log(f"CSMTrainer S={TRAINER_S}: {steps} steps of accum 2 in {train_s:.1f} s (loss "
        f"{last.get('loss', float('nan')):.4f}), launches {launches}; checkpoint "
        f"{ckpt_bytes / 1e9:.2f} GB saved in {save_s:.1f} s, resumed at step {at} in "
        f"{load_s:.1f} s, params restored {same}; eval loss {eval_a:.4f} before, {eval_b:.4f} "
        "after the resume")
    check(steps == 2 and math.isfinite(last.get("loss", float("nan"))),
          f"trainer: {steps} steps, {last}")
    check(all(launches.values()), f"trainer: a flash kernel did not run: {launches}")
    check(at == 2 and same, f"trainer: resumed at {at}, params restored {same}")
    check(math.isfinite(eval_a) and abs(eval_a - eval_b) <= 1e-5 * abs(eval_a),
          f"trainer: eval loss {eval_a} before, {eval_b} after the resume")
    return dict(steps=steps, train_s=train_s, last=last, launches=launches, eval_loss=eval_a,
                eval_loss_resumed=eval_b, checkpoint_bytes=ckpt_bytes, save_s=save_s,
                load_s=load_s)


# ---------------------------------------------------------------------------
# Phase 9: sharpened weights
# ---------------------------------------------------------------------------

OVERFIT_STEPS = 300
AGREE_FRAMES = 24
AGREE_PROMPT = 16
# The exact tier must agree on every token when the plain path's smallest c0
# top-2 gap exceeds this (the JAX package's trained-agreement gate).
SHARP_GAP = 0.5
SHARP_DIR = os.path.join(REPO, "csm_tpu_torch", "_build", "sharpened")
# The int4 step's normed hidden against the plain bf16 step's.  The JAX
# package's int4 budget, 0.15 max |diff| / max |plain| (tests/test_bb_kernel.py,
# tiny random weights), is the scheme's per-product error (0.148 measured in
# csm_tpu/ops/bb_kernel.py::quantize_int4_equilibrated; int8: 0.008); over 16
# layers at full width on sharpened weights the step reads 0.10-0.17
# max-relative and 0.18 relative RMS (int8: 0.013), with every token equal
# (PERF.md, Findings).  So that budget is reported, and the gate is a
# gross one on the relative RMS: a step without the u prescale reads ~1.4
# (phase 10).  The tier's own contract on these weights is its tokens.
INT4_BUDGET = 0.15
INT4_HIDDEN_TOL = 0.3
INT4_AGREEMENT = 0.95


def _teacher_forced(model, tier: str, ids0, mask0, forced, rounds=None, gaps=None):
    """Frames 1.. of a greedy run fed the forced previous frame each step
    (``forced`` None: fed its own, a free run from the prefill's frame);
    returns ``(frames [F-1, 32], min c0 top-2 gap, frame 0)``.  ``gaps``:
    collects, each step, the tier's normed hidden against the plain bf16
    step's on a copy of the same cache: ``(max |diff| / max |plain|,
    relative RMS)``."""
    import torch

    from csm_tpu_torch import generation
    from csm_tpu_torch.models import csm
    from csm_tpu_torch.models.llama import KVCache

    cfg = model.config
    qsb = qdec = None
    if tier != "plain":
        qsb, qdec = model._qsb, model._qdec
    cache_len = ((AGREE_PROMPT + AGREE_FRAMES + 127) // 128) * 128
    cache = KVCache.create(cfg.backbone, 1, cache_len, dtype=torch.bfloat16, device="cuda")
    kw = dict(greedy=True, qdec=qdec, specdec=tier == "exact")
    orig = generation.decode_frame_specdec
    if rounds is not None:
        def traced(*a, **k):
            tokens, r = orig(*a, return_rounds=True, **k)
            rounds.append(r)
            return tokens
        generation.decode_frame_specdec = traced
    try:
        with torch.no_grad():
            out = csm.forward(model.params, cfg, ids0, mask0, cache=cache, flash_prefill=True)
            frame0 = generation.decode_frame(model.params, cfg, out.last_hidden_state, out.logits,
                                             greedy=True)
            cache, prev, frames, gap = out.cache, frame0, [], float("inf")
            for t in range(1, AGREE_FRAMES):
                ids, mask = generation._next_frame_inputs(cfg, prev)
                if gaps is not None:
                    copy = KVCache(cache.k.clone(), cache.v.clone(), cache.valid.clone(),
                                   cache.index)
                    ref_h = csm.forward(model.params, cfg, ids, mask,
                                        cache=copy).last_hidden_state.double()
                    del copy
                out = csm.forward(model.params, cfg, ids, mask, cache=cache, qsb=qsb)
                if gaps is not None:
                    d = out.last_hidden_state.double() - ref_h
                    gaps.append(((d.abs().max() / ref_h.abs().max()).item(),
                                 (d.norm() / ref_h.norm()).item()))
                cache = out.cache
                frame = generation.decode_frame(model.params, cfg, out.last_hidden_state,
                                                out.logits, **kw)
                top2 = out.logits.float().topk(2, dim=-1).values
                gap = min(gap, (top2[:, 0] - top2[:, 1]).min().item())
                frames.append(frame[0])
                prev = frame if forced is None else forced[t][None]
    finally:
        generation.decode_frame_specdec = orig
    return torch.stack(frames), gap, frame0[0]


INVARIANCE_FRAMES = 8


def batch_invariance(model, cfg, ids0, mask0) -> dict:
    """The greedy pattern-prompt request inside a full 8-slot int4 server
    (7 sampled requests beside it) against the same request alone through
    ``quantize(bits=4).generate``.  Its tokens are gated equal where the
    request's smallest c0 top-2 gap (over its own frames, from the tier's
    logits) exceeds SHARP_GAP; equality is reported either way."""
    import numpy as np
    import torch

    from csm_tpu_torch import generation
    from csm_tpu_torch.serving import CSMServer

    model.quantize(bits=4)
    server = CSMServer(model.params, cfg, n_slots=SERVE_SLOTS, window=128, temperature=0.8,
                       topk=50, max_new_frames=INVARIANCE_FRAMES, qdec=model._qdec,
                       qbb=model._qbb, qsb=model._qsb)
    ids, mask = ids0.cpu().numpy(), mask0.cpu().numpy()
    rids = []
    for i in range(SERVE_SLOTS):
        if i == 3:
            rids.append(server.submit(ids, mask, greedy=True))
        else:
            rids.append(server.submit(*serve_prompt(cfg, 16 + 8 * i, seed=600 + i), seed=700 + i))
    server.run_until_idle()
    batched = server.results[rids[3]]
    gaps = []
    orig = generation.decode_frame

    def traced(params, config, last_h, c0_logits, **kw):
        top2 = c0_logits.float().topk(2, dim=-1).values
        gaps.append((top2[:, 0] - top2[:, 1]).min().item())
        return orig(params, config, last_h, c0_logits, **kw)

    generation.decode_frame = traced
    try:
        solo = model.generate(ids, mask, max_new_frames=INVARIANCE_FRAMES, greedy=True)[0]
    finally:
        generation.decode_frame = orig
    same = batched.shape == solo.shape and bool(np.array_equal(batched, solo))
    share = float((batched == solo).mean()) if batched.shape == solo.shape else 0.0
    gated = min(gaps) > SHARP_GAP
    log(f"batch invariance (int4 server, 8 slots, sharpened weights): greedy request batched "
        f"vs solo bitwise equal {same}, token share equal {share:.4f}; its min c0 top-2 gap "
        f"{min(gaps):.3f} ({'gated' if gated else 'not gated'} at {SHARP_GAP})")
    if gated:
        check(same, f"batch invariance: batched tokens differ from solo ({share:.4f} equal) "
              f"with a min top-2 gap of {min(gaps):.3f}")
    del server
    torch.cuda.empty_cache()
    return dict(bitwise_equal=same, token_share_equal=share, min_c0_top2_gap=min(gaps),
                gated=gated, frames=int(solo.shape[0]))


def sharpened_agreement(cfg) -> dict:
    """Overfit a bf16 CSM-1B (seed 0) on a pattern batch for 300 steps (lr
    3e-4, S 64, B 4), then teacher-forced greedy agreement of ``exact()`` and
    ``quantize()`` against the plain bf16 path over 24 frames from a phase-3
    pattern prompt, the plain path's smallest c0 top-2 gap, and the
    speculative tier's rounds per frame."""
    import torch

    from csm_tpu_torch import CSMModel
    from csm_tpu_torch.models import csm
    from csm_tpu_torch.utils.overfit import overfit, pattern_batch

    params = csm.init_params(cfg, 0, torch.bfloat16, "cuda")
    t0 = time.perf_counter()
    params, loss = overfit(params, cfg, steps=OVERFIT_STEPS, verbose=False)
    torch.cuda.synchronize()
    overfit_s = time.perf_counter() - t0
    model = CSMModel(cfg, params=params, dtype=torch.bfloat16, device="cuda")
    ev = pattern_batch(cfg, AGREE_PROMPT + 1, batch=1, n_text=8, phase=3)
    ids0 = torch.as_tensor(ev["input_ids"][0, :, :AGREE_PROMPT], device="cuda")
    mask0 = torch.as_tensor(ev["attention_mask"][0, :, :AGREE_PROMPT], device="cuda")

    free, _, frame0 = _teacher_forced(model, "plain", ids0, mask0, None)
    forced = torch.cat([frame0[None], free])
    ref, gap, _ = _teacher_forced(model, "plain", ids0, mask0, forced)
    rounds = []
    model.exact()
    exact, gap_exact, _ = _teacher_forced(model, "exact", ids0, mask0, forced, rounds)
    model.quantize()
    hidden8, hidden4 = [], []
    quant, gap_quant, _ = _teacher_forced(model, "quantize", ids0, mask0, forced, gaps=hidden8)
    model.quantize(bits=4)
    quant4, gap_quant4, _ = _teacher_forced(model, "quantize4", ids0, mask0, forced, gaps=hidden4)
    h8, h4 = ([max(g[i] for g in hs) for i in (0, 1)] for hs in (hidden8, hidden4))
    rec = dict(overfit_loss=loss, overfit_steps=OVERFIT_STEPS, overfit_s=overfit_s,
               frames=AGREE_FRAMES - 1, plain_min_c0_top2_gap=gap,
               plain_teacher_forced_equals_free_run=bool(torch.equal(ref, free)),
               specdec_rounds=rounds, quantize_hidden=hidden8, quantize4_hidden=hidden4)
    for name, fr in (("exact", exact), ("quantize", quant), ("quantize4", quant4)):
        rec[f"{name}_token_agreement"] = (fr == ref).float().mean().item()
        rec[f"{name}_c0_agreement"] = (fr[:, 0] == ref[:, 0]).float().mean().item()
    rec["gated"] = gap > SHARP_GAP
    log(f"sharpened weights: overfit {OVERFIT_STEPS} steps in {overfit_s:.1f} s to loss "
        f"{loss:.4f}; plain min c0 top-2 gap {gap:.3f} (exact {gap_exact:.3f}, quantize "
        f"{gap_quant:.3f}); teacher-forced token agreement with plain over {AGREE_FRAMES - 1} "
        f"frames: exact {rec['exact_token_agreement']:.4f} (c0 {rec['exact_c0_agreement']:.4f}), "
        f"quantize {rec['quantize_token_agreement']:.4f} (c0 "
        f"{rec['quantize_c0_agreement']:.4f}), quantize(bits=4) "
        f"{rec['quantize4_token_agreement']:.4f} (c0 {rec['quantize4_c0_agreement']:.4f}, min "
        f"gap {gap_quant4:.3f}); normed hidden vs the plain bf16 step, worst frame, max-relative "
        f"/ relative RMS: int4 {h4[0]:.4f} / {h4[1]:.4f} (JAX budget {INT4_BUDGET} max-relative, "
        f"{sum(g[0] > INT4_BUDGET for g in hidden4)} of {len(hidden4)} frames above it; gate "
        f"{INT4_HIDDEN_TOL} relative RMS), int8 {h8[0]:.4f} / {h8[1]:.4f}; speculative rounds "
        f"per frame {rounds}")
    check(h4[1] <= INT4_HIDDEN_TOL,
          f"sharpened: the int4 step's normed hidden is {h4[1]:.4f} (relative RMS) from the plain "
          f"bf16 step's (> {INT4_HIDDEN_TOL})")
    check(rec["plain_teacher_forced_equals_free_run"],
          "sharpened: the plain teacher-forced pass differs from its own free run")
    if rec["gated"]:
        check(rec["exact_token_agreement"] == 1.0,
              f"sharpened: exact() agrees on {rec['exact_token_agreement']:.4f} of tokens "
              f"with a min top-2 gap of {gap:.3f} > {SHARP_GAP}")
        check(rec["quantize4_token_agreement"] >= INT4_AGREEMENT,
              f"sharpened: quantize(bits=4) agrees on {rec['quantize4_token_agreement']:.4f} of "
              f"tokens (< {INT4_AGREEMENT}) with a min top-2 gap of {gap:.3f} > {SHARP_GAP}")
    rec["batch_invariance"] = batch_invariance(model, cfg, ids0, mask0)
    # The sharpened weights for phase 15b's ranks.
    model.save_pretrained(SHARP_DIR)
    del model, params
    torch.cuda.empty_cache()
    return rec



# ---------------------------------------------------------------------------
# Phase 14: fine-tuning from files
# ---------------------------------------------------------------------------

# The clips: (file, sample rate, channels, writer, seconds); "save_wav" is
# the port's 16-bit writer, an int the sample width written by Python's wave.
FT_CLIPS = (("clip_48k_stereo.wav", 48000, 2, "save_wav", 2.3),
            ("clip_44k_24bit.wav", 44100, 1, 3, 3.1),
            ("clip_24k.wav", 24000, 1, "save_wav", 4.7),
            ("clip_16k_u8.wav", 16000, 1, 1, 5.9))
FT_TEXTS = (("Did the parcel come this morning?", "It did, just before nine."),
            ("Shall we take the early train?", "Only if you bring the coffee."),
            ("How was the concert last night?", "Loud, and far too short."),
            ("What are you reading these days?", "An old book about lighthouses."))
FT_EPOCHS, FT_ACCUM = 2, 2
FT_ARGS = ("--bf16", "--num_train_epochs", str(FT_EPOCHS), "--per_device_train_batch_size", "1",
           "--gradient_accumulation_steps", str(FT_ACCUM), "--save_strategy", "no",
           "--logging_steps", "1", "--seed", "0")
FT_GEN_FRAMES = 8
# Mimi codes of the card's encode against the port's CPU encode of the same
# clips and weights: the least share of equal codes over the 32 codebooks,
# pooled over the four clips' 201 frames.  Read 1.0 in every codebook of
# every clip on an H100 (fp32, TF32 off); the limit leaves room for ~6
# frames flipped by near ties in one codebook.  The control (the CPU encode
# of each clip one sample later) read 0.41-0.97 per codebook and clip, so it
# must fall below.
FT_CODE_SHARE = 0.97


class CharTokenizer:
    """A char-level stand-in for the Llama-3.2 tokenizer, whose files are not
    in the repository (and the card host may lack ``transformers``): BOS, an
    id a character, EOS, at the published BOS / EOS ids."""

    bos_token_id, eos_token_id = 128000, 128001

    def encode(self, text, add_special_tokens=True):
        core = [10 + (ord(c) % 80) for c in text]
        return [self.bos_token_id, *core, self.eos_token_id] if add_special_tokens else core


def mimi_hf_state_dict(cfg, seed: int) -> dict:
    """Random Mimi weights as numpy arrays in the HF ``MimiModel`` key layout
    (N(0, 0.02), codebook usage uniform in [0, 3) with two dead entries)."""
    import numpy as np

    from csm_tpu_torch.codec import mimi

    rng = np.random.default_rng(seed)
    sd = {}

    def r(*shape):
        return 0.02 * rng.standard_normal(shape, dtype=np.float32)

    for prefix, plan in (("encoder", mimi.encoder_plan(cfg)), ("decoder", mimi.decoder_plan(cfg))):
        for i, item in enumerate(plan):
            if item[0] == "conv":
                s = item[1]
                shape = ((s.in_ch, s.out_ch // s.groups, s.kernel) if s.transposed
                         else (s.out_ch, s.in_ch // s.groups, s.kernel))
                sd[f"{prefix}.layers.{i}.conv.weight"] = r(*shape)
                sd[f"{prefix}.layers.{i}.conv.bias"] = r(s.out_ch)
            elif item[0] == "resnet":
                for bi, s in zip((1, 3), item[1]):
                    sd[f"{prefix}.layers.{i}.block.{bi}.conv.weight"] = r(s.out_ch, s.in_ch,
                                                                          s.kernel)
                    sd[f"{prefix}.layers.{i}.block.{bi}.conv.bias"] = r(s.out_ch)
    H, I, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    for prefix in ("encoder_transformer", "decoder_transformer"):
        for i in range(cfg.num_hidden_layers):
            base = f"{prefix}.layers.{i}"
            for n, shape in (("self_attn.q_proj", (cfg.num_attention_heads * hd, H)),
                             ("self_attn.k_proj", (cfg.num_key_value_heads * hd, H)),
                             ("self_attn.v_proj", (cfg.num_key_value_heads * hd, H)),
                             ("self_attn.o_proj", (H, cfg.num_attention_heads * hd)),
                             ("mlp.fc1", (I, H)), ("mlp.fc2", (H, I))):
                sd[f"{base}.{n}.weight"] = r(*shape)
            for n in ("input_layernorm.weight", "input_layernorm.bias",
                      "post_attention_layernorm.weight", "post_attention_layernorm.bias",
                      "self_attn_layer_scale.scale", "mlp_layer_scale.scale"):
                sd[f"{base}.{n}"] = r(H)
    sd["downsample.conv.weight"] = r(H, H, mimi.downsample_spec(cfg).kernel)
    up = mimi.upsample_spec(cfg)
    sd["upsample.conv.weight"] = r(H, H // up.groups, up.kernel)
    for name, n in (("semantic", cfg.num_semantic_quantizers),
                    ("acoustic", cfg.num_quantizers - cfg.num_semantic_quantizers)):
        base = f"quantizer.{name}_residual_vector_quantizer"
        sd[f"{base}.input_proj.weight"] = r(cfg.codebook_dim, H, 1)
        sd[f"{base}.output_proj.weight"] = r(H, cfg.codebook_dim, 1)
        for i in range(n):
            sd[f"{base}.layers.{i}.codebook.embed_sum"] = r(cfg.codebook_size, cfg.codebook_dim)
            usage = 3 * rng.random(cfg.codebook_size, dtype=np.float32)
            usage[:2] = 0.0
            sd[f"{base}.layers.{i}.codebook.cluster_usage"] = usage
    return sd


def _speechlike(n: int, rate: int, ch: int, seed: int):
    """``[ch, n]`` float32 in [-1, 1]: a gliding two-tone voice with noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    f0 = 140 + 40 * np.sin(2 * np.pi * 0.7 * t)
    voice = 0.25 * np.sin(2 * np.pi * np.cumsum(f0) / rate) + 0.1 * np.sin(2 * np.pi * 660 * t)
    x = voice[None] + 0.03 * rng.standard_normal((ch, n))
    return np.clip(x, -0.99, 0.99).astype(np.float32)


def _write_wav_pcm(path: str, wave, rate: int, width: int) -> None:
    """``wave [ch, n]`` through Python's ``wave``: 8-bit unsigned or 24-bit."""
    import wave as pywave

    import numpy as np

    inter = wave.T.reshape(-1)
    if width == 1:
        raw = np.round(inter * 127 + 128).astype(np.uint8).tobytes()
    else:
        u = np.round(inter * (2 ** 23 - 1)).astype(np.int64) & 0xFFFFFF
        raw = np.stack([u & 0xFF, (u >> 8) & 0xFF, u >> 16], -1).astype(np.uint8).tobytes()
    with pywave.open(path, "wb") as w:
        w.setnchannels(wave.shape[0])
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(raw)


def write_finetune_files(d: str) -> dict:
    """The clips, the JSONL (four two-message conversations, the fourth with
    a third message whose clip does not exist) and random full-width Mimi
    weights in the HF layout; each clip read back at its rate and channel
    count and resampled to 24 kHz at the length the native resampler
    predicts."""
    from csm_tpu_torch import native
    from csm_tpu_torch.checkpoint.safetensors_io import save_file
    from csm_tpu_torch.codec import MimiCodecConfig
    from csm_tpu_torch.data.audio_io import load_audio, load_audio_mono, save_wav

    t0 = time.perf_counter()
    clips = []
    for i, (name, rate, ch, writer, seconds) in enumerate(FT_CLIPS):
        path = os.path.join(d, name)
        n = int(seconds * rate)
        wave = _speechlike(n, rate, ch, seed=i)
        if writer == "save_wav":
            save_wav(path, wave, rate)
        else:
            _write_wav_pcm(path, wave, rate, writer)
        back, got_rate = load_audio(path)
        mono = load_audio_mono(path, 24000)
        want_len = native.resample_len(n, rate, 24000) if rate != 24000 else n
        clips.append(dict(path=path, rate=rate, channels=ch, samples=n, read_rate=got_rate,
                          read_shape=list(back.shape), mono_24k=len(mono), want_24k=want_len))
        check(got_rate == rate and back.shape == (ch, n) and len(mono) == want_len,
              f"finetune: {name} read back at {got_rate} Hz as {back.shape}, resampled to "
              f"{len(mono)} samples (want {rate} Hz, ({ch}, {n}), {want_len})")
    missing = os.path.join(d, "not_recorded.wav")
    with open(os.path.join(d, "train.jsonl"), "w") as f:
        for i, ((q, a), clip) in enumerate(zip(FT_TEXTS, clips)):
            messages = [
                {"role": "speaker_0", "content": [{"type": "text", "text": q}]},
                {"role": "speaker_1", "content": [{"type": "text", "text": a},
                                                  {"type": "audio", "url": clip["path"]}]},
            ]
            if i == len(FT_TEXTS) - 1:
                messages.append({"role": "speaker_0", "content": [
                    {"type": "text", "text": "And this one?"},
                    {"type": "audio", "url": missing}]})
            f.write(json.dumps({"messages": messages}) + "\n")
    io_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mimi_path = os.path.join(d, "mimi.safetensors")
    save_file(mimi_hf_state_dict(MimiCodecConfig(), seed=0), mimi_path)
    return dict(clips=clips, missing=missing, jsonl=os.path.join(d, "train.jsonl"),
                mimi_path=mimi_path, audio_io_s=io_s, mimi_write_s=time.perf_counter() - t0)


def _audio_spans(mask):
    """``[start, end)`` of each run of audio frames (codebook columns live)."""
    import numpy as np

    audio = mask[:, 0] == 1
    edges = np.flatnonzero(np.diff(np.concatenate([[0], audio.astype(int), [0]])))
    return list(zip(edges[::2], edges[1::2]))


def _code_shares(got, ref):
    """The share of equal codes per codebook, ``[32]``, of ``[32, frames]``
    codes."""
    import numpy as np

    return [float(x) for x in (np.asarray(got) == np.asarray(ref)).mean(axis=1)]


def finetune_cli() -> dict:
    """Phase 14: ``python -m csm_tpu_torch.train``'s ``main`` in-process on a
    JSONL of four conversations with clips in four WAV formats, at CSM-1B
    width (no ``--config_path``), bf16, 2 epochs, accumulation 2; then greedy
    generation from a dataset prompt, Mimi decode, ``save_wav`` and
    ``load_audio``."""
    import logging
    import threading

    import numpy as np
    import torch

    from csm_tpu_torch import CSMModel, native
    from csm_tpu_torch.codec import load_mimi, mimi
    from csm_tpu_torch.data.audio_io import load_audio, load_audio_mono, save_wav
    from csm_tpu_torch.train import cli
    from csm_tpu_torch.train.loop import CSMTrainer, flatten

    t_phase = time.perf_counter()
    check(native.available(), f"finetune: the native audio library is not available: "
                              f"{native.load_error()}")
    d = os.path.join(REPO, "csm_tpu_torch", "_build", "finetune_smoke")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    out_dir = os.path.join(d, "out")
    wrappers = train_counters()
    steps, encodes, saves, warned = [], [], [], []

    class Recorder(CSMTrainer):
        """The CLI's trainer, timing each optimizer step (synchronized) with
        the flash launches it made, and the final save."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            step_fn = self._step_fn

            def timed(state, base, batch):
                before = {k: w.launches for k, w in wrappers.items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step_fn(state, base, batch)
                torch.cuda.synchronize()
                steps.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                                  S=int(batch["input_ids"].shape[2]),
                                  launches={k: w.launches - before[k]
                                            for k, w in wrappers.items()}))
                return out

            self._step_fn = timed

        def save_model(self, output_dir=None):
            t0 = time.perf_counter()
            super().save_model(output_dir)
            saves.append(time.perf_counter() - t0)

    plain_encode = mimi.mimi_encode

    def recording_encode(cfg, params, wave, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codes = plain_encode(cfg, params, wave, *args, **kw)
        torch.cuda.synchronize()
        encodes.append(dict(thread=threading.current_thread().name, device=str(wave.device),
                            grad=torch.is_grad_enabled(), s=time.perf_counter() - t0))
        return codes

    class Warnings(logging.Handler):
        def emit(self, record):
            warned.append(record.getMessage())

    files = write_finetune_files(d)
    log(f"phase 14: wrote {len(files['clips'])} clips (audio I/O {files['audio_io_s']:.2f} s), "
        f"random full-width Mimi weights in {files['mimi_write_s']:.1f} s; the Llama-3.2 "
        "tokenizer is replaced by a char-level stand-in with BOS / EOS in the CLI's namespace "
        "(its files are not in the repository)")
    argv = ["--train_file", files["jsonl"], "--output_dir", out_dir, *FT_ARGS]
    saved_env = os.environ.get("CSM_TPU_MIMI_PATH")
    os.environ["CSM_TPU_MIMI_PATH"] = files["mimi_path"]
    patched = dict(load_llama3_tokenizer=CharTokenizer, CSMTrainer=Recorder)
    originals = {k: getattr(cli, k) for k in patched}
    handler = Warnings(logging.WARNING)
    dataset_logger = logging.getLogger("csm_tpu_torch.data.dataset")
    dataset_logger.addHandler(handler)
    try:
        for k, v in patched.items():
            setattr(cli, k, v)
        mimi.mimi_encode = recording_encode
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = cli.main(argv)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        train_launches = {k: w.launches for k, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated()
    finally:
        for k, v in originals.items():
            setattr(cli, k, v)
        mimi.mimi_encode = plain_encode
        dataset_logger.removeHandler(handler)
        if saved_env is None:
            os.environ.pop("CSM_TPU_MIMI_PATH", None)
        else:
            os.environ["CSM_TPU_MIMI_PATH"] = saved_env
    try:
        ds = trainer.train_dataset
        n_rows = len(FT_TEXTS)
        want_steps = math.ceil(n_rows * FT_EPOCHS / FT_ACCUM)
        losses = [m["loss"] for m in trainer._metrics_log]
        log(f"phase 14: main() in {main_s:.1f} s: {trainer.state.step} optimizer steps "
            f"(want {want_steps}), S {[s['S'] for s in steps]}, step ms "
            f"{[round(s['ms'], 1) for s in steps]}, losses {[round(x, 4) for x in losses]}, "
            f"flash launches per step {[s['launches'] for s in steps]}; peak memory "
            f"{peak / 2**30:.2f} GiB")
        check(trainer.state.step == want_steps and len(steps) == want_steps,
              f"finetune: {trainer.state.step} optimizer steps ({len(steps)} timed), want "
              f"{want_steps}")
        check(len(losses) == want_steps and all(math.isfinite(x) for x in losses),
              f"finetune: logged losses {losses}")
        check(steps and all(all(s["launches"][k] > 0 for k in wrappers) for s in steps),
              f"finetune: a step launched no flash kernel: {[s['launches'] for s in steps]}")
        check(len(ds) == n_rows * FT_EPOCHS, f"finetune: dataset len {len(ds)}, want "
                                             f"{n_rows * FT_EPOCHS}")
        check(encodes and all(e["thread"] == "csm-batch-prefetch" and e["device"] == "cuda:0"
                              and not e["grad"] for e in encodes),
              f"finetune: Mimi encodes in training: {encodes}")
        check(any(os.path.basename(files["missing"]) in m for m in warned),
              f"finetune: no warning named the missing clip: {warned}")

        # The items: every audio span ends in the zero EOS frame, codes in range.
        items = [ds[i] for i in range(n_rows)]
        spans = [_audio_spans(it["attention_mask"]) for it in items]
        bad = [(i, s) for i, it in enumerate(items) for s in spans[i]
               if (it["input_ids"][s[1] - 1, :32] != 0).any()
               or not ((it["input_ids"][s[0]:s[1], :32] >= 0).all()
                       and (it["input_ids"][s[0]:s[1], :32] < 2048).all())]
        check([len(s) for s in spans] == [1] * n_rows and not bad,
              f"finetune: audio spans {spans}, bad {bad}")

        # The card's encode against the port's CPU encode of the same clips.
        card = ds.processor.audio_tokenizer
        host = load_mimi(files["mimi_path"], device="cpu")
        codes = {"card": [], "cpu": [], "control": []}
        t0 = time.perf_counter()
        for clip in files["clips"]:
            wave = load_audio_mono(clip["path"], card.sample_rate)
            codes["card"].append(card.encode(wave))
            codes["cpu"].append(host.encode(wave))
            late = np.concatenate([[0.0], wave[:-1]]).astype(np.float32)
            codes["control"].append(host.encode(late))
        compare_s = time.perf_counter() - t0
        shares = {k: [_code_shares(c, g) for c, g in zip(codes["card"], codes[k])]
                  for k in ("cpu", "control")}
        pooled = {k: _code_shares(np.concatenate(codes["card"], 1), np.concatenate(codes[k], 1))
                  for k in ("cpu", "control")}
        least, least_control = min(pooled["cpu"]), min(pooled["control"])
        log(f"phase 14: card vs CPU Mimi codes, share equal per codebook over "
            f"{sum(c.shape[1] for c in codes['card'])} frames: "
            f"{[round(x, 3) for x in pooled['cpu']]}, least {least:.4f} (limit "
            f"{FT_CODE_SHARE}; least of a clip {min(min(x) for x in shares['cpu']):.4f}); "
            f"control, the CPU encode one sample later: least {least_control:.4f}, per "
            f"codebook {[round(x, 3) for x in pooled['control']]}")
        check(least >= FT_CODE_SHARE, f"finetune: card vs CPU Mimi codes, least share {least}")
        check(least_control < FT_CODE_SHARE,
              f"finetune: the one-sample-late control passes the code gate ({least_control})")
        # The same comparison with cudnn.allow_tf32 at torch's default (True),
        # as the CLI encodes when its caller sets nothing.
        before = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            codes["card_tf32"] = [card.encode(load_audio_mono(clip["path"], card.sample_rate))
                                  for clip in files["clips"]]
        finally:
            torch.backends.cudnn.allow_tf32 = before
        pooled["tf32"] = _code_shares(np.concatenate(codes["card_tf32"], 1),
                                      np.concatenate(codes["cpu"], 1))
        least_tf32 = min(pooled["tf32"])
        log(f"phase 14: card (cudnn.allow_tf32 at torch's default, True) vs CPU Mimi codes: "
            f"least share {least_tf32:.4f} (limit {FT_CODE_SHARE}), per codebook "
            f"{[round(x, 3) for x in pooled['tf32']]}")
        check(least_tf32 >= FT_CODE_SHARE,
              f"finetune: card Mimi codes under default TF32 vs CPU, least share {least_tf32}")

        # The saved model reloads bitwise equal to the trainer's parameters.
        t0 = time.perf_counter()
        model = CSMModel.from_pretrained(out_dir, dtype=torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        reload_s = time.perf_counter() - t0
        want = flatten(trainer.model_params())
        got = flatten(model.params)
        differ = [k for k in want if k not in got or not torch.equal(got[k], want[k])]
        check(got.keys() == want.keys() and not differ,
              f"finetune: the saved model differs from the trainer's parameters at {differ}")
        del trainer, want
        torch.cuda.empty_cache()

        # Greedy generation from a dataset prompt, Mimi decode, WAV round trip.
        for w in wrappers.values():
            w.launches = 0
        prompt = items[0]
        t0 = time.perf_counter()
        frames = model.generate(prompt["input_ids"][None],
                                prompt["attention_mask"][None].astype(np.float32),
                                max_new_frames=FT_GEN_FRAMES, greedy=True,
                                stop_on_all_zeros=False)
        gen_s = time.perf_counter() - t0
        gen_launches = {k: w.launches for k, w in wrappers.items()}
        wave = card.decode(np.minimum(frames[0].T, card.config.codebook_size - 1))
        path = os.path.join(d, "generated.wav")
        save_wav(path, np.clip(wave, -1, 1), card.sample_rate)
        back, rate = load_audio(path)
        n_samples = FT_GEN_FRAMES * int(card.sample_rate / card.frame_rate)
        log(f"phase 14: generated {tuple(frames.shape)} frames in {gen_s:.2f} s (flash launches "
            f"{gen_launches}), decoded to {wave.shape} samples, read back {back.shape} at "
            f"{rate} Hz")
        check(frames.shape == (1, FT_GEN_FRAMES, 32) and rate == card.sample_rate
              and back.shape == (1, n_samples) and np.isfinite(back).all()
              and np.isfinite(wave).all(),
              f"finetune: generated {frames.shape}, decoded {wave.shape}, read back "
              f"{back.shape} at {rate} Hz")
        del model
    finally:
        shutil.rmtree(d, ignore_errors=True)
        torch.cuda.empty_cache()
    stages = dict(audio_io_s=files["audio_io_s"], mimi_write_s=files["mimi_write_s"],
                  main_s=main_s, encode_s=sum(e["s"] for e in encodes),
                  steps_s=sum(s["ms"] for s in steps) / 1e3, save_s=sum(saves),
                  reload_s=reload_s, code_compare_s=compare_s, generate_s=gen_s)
    seconds = time.perf_counter() - t_phase
    log(f"phase 14 (fine-tuning from files) in {seconds:.1f} s: "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
        + f"; peak memory {peak / 2**30:.2f} GiB")
    launches = {k: train_launches[k] + gen_launches[k] for k in wrappers}
    return dict(seconds=seconds, stages=stages, peak_memory_bytes=peak, steps=steps,
                losses=losses, encodes=len(encodes), clips=files["clips"],
                code_share=pooled["cpu"], code_share_control=pooled["control"],
                code_share_tf32=pooled["tf32"],
                code_share_by_clip=shares, warnings=warned,
                train_launches=train_launches, generate_launches=gen_launches,
                launches=launches, frames=frames.tolist())


# ---------------------------------------------------------------------------
# Phase 13: sequence parallelism (K3 / K5a / K5b with q_offset, sharded steps)
# ---------------------------------------------------------------------------

SP_SHARDS = (2, 4)
# dk / dv summed over the shards against the unsharded launch's: every
# shard's partial is rounded to the operands' type before the sum, so bf16
# carries one rounding per shard besides the unsharded one (~1e-3 relative
# RMS each; 2.2e-3 at 2 shards in a CPU rehearsal of the plain versions);
# a wrong offset or mask gives 0.1-1.  fp32: summation order only.
SP_DKV_SUM_TOL = {"bfloat16": 5e-3, "float32": 1e-5}
# (data, seq, backbone layers, S, B, steps) of the sharded train steps: the
# first at full depth on phase 8's batch, the second cut to 4 backbone layers
# (four replicas of weights and AdamW state share the card).
SP_RUNS = ((1, 2, 16, 2048, 1, 3), (2, 2, 4, 1024, 2, 2))
SP_LAUNCH_TIMEOUT = 600.0
# The sharded step's first step against the one-process step on the same
# batch.  Phase 8's limits (TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL) are for
# kernels against plain attention; here the shard rows are bitwise and only
# summation orders differ, so the limits are tighter: on an H100 the sound
# runs read at most 5.5e-7 on the losses and 1.8e-5 on the grad norm.  Those
# cannot see a fault confined to dK / dV (the forward is untouched and one
# leaf barely moves a norm over 1.6 G values), so the gradients (summed over
# the ranks, scaled and clipped, as the update used them) are also held by
# the largest relative difference of a per-parameter norm, one per layer for
# the stacked weights: sound runs read at most 8.6e-4 (bf16 gradients of
# the norm weights), the control, a lost reduce-scatter of the K / V
# gather's backward, at least 0.17, and must break the limit.
SP_LOSS_RTOL = 1e-5
SP_GNORM_RTOL = 2e-4
SP_GRAD_NORM_RTOL = 3e-3


def _poison_allocator(like) -> None:
    """Leave NaN-filled blocks of ``like``'s size in the caching allocator,
    so that an output the kernel fails to write shows up."""
    import torch

    for _ in range(4):
        torch.full_like(like, float("nan"))


def check_q_offset(gen, dtype_name: str) -> dict:
    """K3 with LSE, K5a and K5b on query shards at ``q_offset = shard *
    S_local`` (B = 1, S = 2048, 32/8 heads, hd 64, 16 left-padded keys): the
    forward and lse and dq bitwise equal to the unsharded launches' rows, the
    forward within ``FLASH_TOL`` of its plain version at the same offset,
    dk / dv summed over the shards within ``SP_DKV_SUM_TOL`` of the
    unsharded ones, the key blocks after a shard's last row exactly zero; the
    ``q_offset = 0`` control must break the gates.  Times per shard call
    beside bounds (phase 7's formula over the shard's rows), plain versions
    and SDPA on the shard with an explicit mask."""
    import torch

    from csm_tpu_torch.ops import flash_attention as fa

    B, S, nq, nkv, hd = 1, TRAIN_S, 32, 8, 64
    g = nq // nkv
    dev, dtype = "cuda", getattr(torch, dtype_name)
    tag = f"q_offset {dtype_name}"
    q, do = (torch.randn((B, S, nq, hd), generator=gen, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn((B, S, nkv, hd), generator=gen, device=dev).to(dtype) for _ in range(2))
    valid = torch.ones((B, S), dtype=torch.int32, device=dev)
    valid[:, :16] = 0
    live = valid.cumsum(1) > 0
    out, lse = fa.flash_fwd(q, k, v, valid, True, with_lse=True)
    dq, dk, dv = fa.flash_bwd(q, k, v, valid, out, lse, do)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kh = k.transpose(1, 2).repeat_interleave(g, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(g, dim=1)
    esz = q.element_size()
    rec = {}
    for n in SP_SHARDS:
        Sl = S // n
        dk_sum = torch.zeros_like(dk, dtype=torch.float32)
        dv_sum = torch.zeros_like(dv, dtype=torch.float32)
        shards = []
        for s in range(n):
            off, sl = s * Sl, slice(s * Sl, (s + 1) * Sl)
            qs, dos, lv = q[:, sl], do[:, sl], live[:, sl]
            o, l = fa.flash_fwd(qs, k, v, valid, True, with_lse=True, q_offset=off)
            ref_o = fa.flash_attention_reference(qs, k, v, valid, True, q_offset=off)
            _poison_allocator(dk)
            gq, gk, gv = fa.flash_bwd(qs, k, v, valid, o, l, dos, True, off)
            torch.cuda.synchronize()
            fwd_bitwise = bool(torch.equal(o[lv], out[:, sl][lv])) and bool(torch.equal(l, lse[..., sl]))
            dq_bitwise = bool(torch.equal(gq, dq[:, sl]))
            unseen = -(-(s + 1) * Sl // 64) * 64  # key blocks no row of the shard can see
            future_zero = bool((gk[:, unseen:] == 0).all()) and bool((gv[:, unseen:] == 0).all())
            err = (o.float() - ref_o.float()).abs()[lv].max().item()
            dk_sum += gk.float()
            dv_sum += gv.float()
            check(fwd_bitwise and dq_bitwise, f"{tag} {n} shards, shard {s}: forward / lse bitwise "
                  f"{fwd_bitwise}, dq bitwise {dq_bitwise}")
            check(future_zero, f"{tag} {n} shards, shard {s}: future key blocks not exactly zero")
            check(err <= FLASH_TOL[dtype_name], f"{tag} {n} shards, shard {s}: forward vs plain "
                  f"{err:.3e}")
            r = dict(shard=s, q_offset=off, fwd_bitwise=fwd_bitwise, dq_bitwise=dq_bitwise,
                     future_blocks_zero=future_zero, err=err)
            if s > 0:
                # Control: the shard at offset 0 is another function.
                c, _ = fa.flash_fwd(qs, k, v, valid, True, with_lse=True)
                c_err = (c.float() - ref_o.float()).abs()[lv].max().item()
                broke = not torch.equal(c[lv], out[:, sl][lv]) and c_err > FLASH_TOL[dtype_name]
                check(broke, f"{tag} {n} shards, shard {s}: the q_offset=0 control passed the gates")
                r["control_err"] = c_err
            if dtype_name == "bfloat16":
                delta = fa._delta(o, dos)
                ms = dict(
                    fwd=cuda_ms(lambda: fa.flash_fwd(qs, k, v, valid, True, True, off), iters=5),
                    dq=cuda_ms(lambda: fa.flash_bwd_dq(qs, k, v, valid, dos, l, delta, True, off),
                               iters=5),
                    dkv=cuda_ms(lambda: fa.flash_bwd_dkv(qs, k, v, valid, dos, l, delta, True,
                                                         off), iters=5))
                plain = dict(
                    fwd=cuda_ms(lambda: fa.flash_attention_reference(qs, k, v, valid, True, True,
                                                                     off), iters=2, warmup=1),
                    bwd=cuda_ms(lambda: fa.flash_attention_bwd_reference(
                        qs, k, v, valid, o, l, dos, True, off), iters=2, warmup=1))
                pos = off + torch.arange(Sl, device=dev)
                ok = valid.bool()[:, None, None, :] & (torch.arange(S, device=dev) <= pos[:, None])
                bias = torch.where(ok, 0.0, fa.NEG_INF).to(dtype)
                qh = qs.transpose(1, 2).detach().requires_grad_(True)
                kq, vq = kh.detach().requires_grad_(True), vh.detach().requires_grad_(True)
                with torch.no_grad():
                    lib_fwd = cuda_ms(lambda: sdpa(qh, kq, vq, attn_mask=bias), iters=5)
                so = sdpa(qh, kq, vq, attn_mask=bias)
                lib_bwd = cuda_ms(lambda: torch.autograd.grad(so, (qh, kq, vq), dos.transpose(1, 2),
                                                             retain_graph=True), iters=5)
                del so, qh, kq, vq, bias
                # What this shard's data needs: each live (row, valid key <=
                # row) pair per head; q, dO and out of its live rows, k and v
                # of the valid keys it can see, lse and delta, the flags.
                cum = valid.cumsum(1)
                pairs = int(cum[:, sl].sum())
                n_live, n_keys = int(lv.sum()), int(valid[:, :(s + 1) * Sl].sum())
                q_rows, kv_rows, stats = n_live * nq * hd * esz, n_keys * nkv * hd * esz, n_live * nq * 4
                flags = B * S * valid.element_size()
                bounds = dict(
                    fwd=bound_ms(q_rows + 2 * kv_rows + flags + nbytes(o, l), 4 * hd * nq * pairs),
                    dq=bound_ms(2 * q_rows + 2 * kv_rows + 2 * stats + flags + nbytes(gq),
                                6 * hd * nq * pairs),
                    dkv=bound_ms(2 * q_rows + 2 * kv_rows + 2 * stats + flags + nbytes(gk, gv),
                                 8 * hd * nq * pairs))
                r.update(ms=ms, plain_ms=plain, library_ms=dict(fwd=lib_fwd, bwd=lib_bwd),
                         bound_ms={kk: b[0] for kk, b in bounds.items()},
                         bound_by={kk: b[1] for kk, b in bounds.items()}, pairs=pairs)
                log(f"{tag} {n} shards, shard {s} (q_offset {off}): K3+lse {ms['fwd']:.4f} ms (bound "
                    f"{bounds['fwd'][0]:.5f}), K5a {ms['dq']:.4f} (bound {bounds['dq'][0]:.5f}), "
                    f"K5b {ms['dkv']:.4f} (bound {bounds['dkv'][0]:.5f}); plain {plain['fwd']:.3f} / "
                    f"{plain['bwd']:.3f} ms; SDPA {lib_fwd:.4f} / {lib_bwd:.4f} ms; {pairs} pairs")
            shards.append(r)
        rel = dict(dk=rel_rms(dk_sum, dk.float()), dv=rel_rms(dv_sum, dv.float()))
        check(max(rel.values()) <= SP_DKV_SUM_TOL[dtype_name],
              f"{tag} {n} shards: summed dk / dv relative RMS {rel}")
        log(f"{tag} {n} shards: forward, lse and dq bitwise "
            f"{all(x['fwd_bitwise'] and x['dq_bitwise'] for x in shards)}, future key blocks zero "
            f"{all(x['future_blocks_zero'] for x in shards)}, summed dk / dv relative RMS "
            f"{rel['dk']:.2e} / {rel['dv']:.2e}, controls "
            f"{[round(x.get('control_err', 0.0), 4) for x in shards]}")
        rec[n] = dict(shards=shards, dkv_rel_rms=rel)
    return rec


def _params_digest(params) -> str:
    """SHA-256 of every parameter's bytes, in name order."""
    import hashlib

    import torch

    from csm_tpu_torch.train.loop import flatten

    h = hashlib.sha256()
    for name, t in flatten(params).items():
        h.update(name.encode())
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _grad_norms(params) -> dict:
    """The norm of each parameter's gradient, one per layer for the stacked
    layer weights: ``{name: [norm, ...]}``."""
    from csm_tpu_torch.train.loop import flatten

    out = {}
    for name, p in flatten(params).items():
        g = p.grad.float()
        g = g.reshape(g.shape[0], -1) if ".layers." in name else g.reshape(1, -1)
        out[name] = g.norm(dim=1).tolist()
    return out


def _grad_norm_diff(got: dict, ref: dict) -> tuple:
    """``(largest relative difference, parameter name)`` of two
    :func:`_grad_norms` records."""
    worst = (0.0, None)
    for name, r in ref.items():
        for a, b in zip(got[name], r):
            d = abs(a - b) / max(abs(b), 1e-30)
            if d > worst[0]:
                worst = (d, name)
    return worst


def _unsummed_grads_control(cfg, state, batch, max_dec: int, opt, mesh) -> dict:
    """The gradient norms (:func:`_grad_norms`) of one forward and backward
    with the K / V gather's reduce-scatter replaced by this rank's own block
    of the gradient (a lost reduce-scatter), then all-reduced, scaled and
    clipped as the train step does."""
    import torch

    from csm_tpu_torch.models import csm
    from csm_tpu_torch.parallel import collectives
    from csm_tpu_torch.train.loop import flatten

    def own_block(x, group, dim=1):
        n = collectives.group_size(group)
        return x.chunk(n, dim=dim)[torch.distributed.get_rank(group)].contiguous()

    leaves = list(flatten(state.params).values())
    for p in leaves:
        p.grad = None
    real = collectives.reduce_scatter_frames
    collectives.reduce_scatter_frames = own_block
    try:
        rows = batch["input_ids"].shape[1] // mesh.size("data")
        out = csm.forward(state.params, cfg, batch["input_ids"][0], batch["attention_mask"][0],
                          labels=batch["labels"][0], max_decoder_frames=max_dec, remat=True,
                          remat_policy="dots" if rows == 1 else "nothing", mesh=mesh)
        out.loss.backward()
    finally:
        collectives.reduce_scatter_frames = real
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
    collectives.all_reduce_flat_(grads, mesh.group("batch"))
    for p, g in zip(leaves, grads):
        p.grad = g
    opt.clip_(grads)
    norms = _grad_norms(state.params)
    for p in leaves:
        p.grad = None
    return norms


def sp_config(layers: int):
    from csm_tpu_torch import CSMConfig

    cfg = CSMConfig()
    return CSMConfig(backbone=dataclasses.replace(cfg.backbone, num_hidden_layers=layers))


def sp_max_dec(S: int, B: int) -> int:
    """Decoder frames of a global batch, as ``CSMTrainer`` sizes them
    (phase 8's ``S // 16 + 1`` at B = 1)."""
    return (B * S) // 16 + B


def _fwd_bwd_peak(cfg, params, batch, max_dec: int, mesh=None) -> int:
    """Bytes allocated above the resident state (weights, and the optimizer
    state if any) at the peak of one forward and backward with remat
    "auto": the activations kept and recomputed, and the gradients."""
    import torch

    from csm_tpu_torch.models import csm
    from csm_tpu_torch.train.loop import flatten

    leaves = list(flatten(params).values())
    for p in leaves:
        p.grad = None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rows = batch["input_ids"].shape[1] // (mesh.size("data") if mesh is not None else 1)
    out = csm.forward(params, cfg, batch["input_ids"][0], batch["attention_mask"][0],
                      labels=batch["labels"][0], max_decoder_frames=max_dec, remat=True,
                      remat_policy="dots" if rows == 1 else "nothing", mesh=mesh)
    out.loss.backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    for p in leaves:
        p.grad = None
    return peak


def _sp_step_rank(data: int, seq: int, layers: int, S: int, B: int, steps: int) -> dict:
    """One rank of a ``data`` x ``seq`` mesh on the shared card: ``steps``
    train steps of a random bf16 CSM (seed 0) with ``layers`` backbone
    layers on ``synthetic_conversation_batch(S, batch=B, seed=0)``, remat
    "auto", AdamW as phase 8; first the gradient norms of the lost
    reduce-scatter control (:func:`_unsummed_grads_control`), then per step
    its metrics, launches, ms, peak memory and a digest of the parameters,
    the first step's gradient norms; then the time of the gradients'
    all-reduce alone (the ranks aligned by a barrier) and the forward +
    backward peak (:func:`_fwd_bwd_peak`)."""
    import torch

    sys.path.insert(0, REPO)
    from csm_tpu_torch.models import csm
    from csm_tpu_torch.parallel import make_mesh
    from csm_tpu_torch.parallel.collectives import all_reduce_flat_
    from csm_tpu_torch.train import make_optimizer, make_train_step
    from csm_tpu_torch.train.loop import flatten
    from csm_tpu_torch.utils.synthetic import synthetic_conversation_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = sp_config(layers)
    mesh = make_mesh(data=data, seq=seq)
    params = csm.init_params(cfg, 0, torch.bfloat16, "cuda")
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in synthetic_conversation_batch(cfg, S, batch=B, seed=0).items()}
    opt = make_optimizer(5e-6, total_steps=100)
    state = opt.init(params)
    control = _unsummed_grads_control(cfg, state, batch, sp_max_dec(S, B), opt, mesh)
    step = make_train_step(cfg, opt, sp_max_dec(S, B), remat=True, remat_policy="auto", mesh=mesh)
    runs = []
    for i in range(steps):
        torch.cuda.reset_peak_memory_stats()
        state, m, dt, launches = _timed_step(step, state, batch)
        runs.append(dict(ms=dt * 1e3, launches=launches, peak_memory_bytes=torch.cuda.max_memory_allocated(),
                         digest=_params_digest(state.params), **m))
        if i == 0:
            grad_norms = _grad_norms(state.params)
    grads = [p.grad for p in flatten(state.params).values()]
    torch.distributed.barrier(mesh.group("batch"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    all_reduce_flat_(grads, mesh.group("batch"))
    torch.cuda.synchronize()
    allreduce_ms = (time.perf_counter() - t0) * 1e3
    del grads
    fwd_bwd = _fwd_bwd_peak(cfg, state.params, batch, sp_max_dec(S, B), mesh)
    return dict(coords=mesh.coords, q_offset=mesh.index("seq") * (S // seq), steps=runs,
                grad_norms=grad_norms, control_grad_norms=control,
                grad_allreduce_ms=allreduce_ms, fwd_bwd_peak_bytes=fwd_bwd)


def _sp_one_process(layers: int, S: int, B: int) -> dict:
    """The one-process first step of :func:`_sp_step_rank`'s run, its
    gradient norms and its forward + backward peak."""
    import torch

    from csm_tpu_torch.models import csm
    from csm_tpu_torch.train import make_optimizer, make_train_step
    from csm_tpu_torch.utils.synthetic import synthetic_conversation_batch

    cfg = sp_config(layers)
    params = csm.init_params(cfg, 0, torch.bfloat16, "cuda")
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in synthetic_conversation_batch(cfg, S, batch=B, seed=0).items()}
    opt = make_optimizer(5e-6, total_steps=100)
    state = opt.init(params)
    train_step = make_train_step(cfg, opt, sp_max_dec(S, B), remat=True, remat_policy="auto")
    torch.cuda.reset_peak_memory_stats()
    state, m, dt, launches = _timed_step(train_step, state, batch)
    rec = dict(ms=dt * 1e3, launches=launches, peak_memory_bytes=torch.cuda.max_memory_allocated(),
               grad_norms=_grad_norms(state.params), **m)
    rec["fwd_bwd_peak_bytes"] = _fwd_bwd_peak(cfg, state.params, batch, sp_max_dec(S, B))
    del state, params
    torch.cuda.empty_cache()
    return rec


def sharded_training() -> dict:
    """The sharded train steps of ``SP_RUNS``, each on ranks spawned by
    ``csm_tpu_torch.parallel.launch`` sharing ``cuda:0`` over gloo, against
    a one-process step on the same configuration and global batch."""
    import torch

    from csm_tpu_torch.parallel.launch import launch

    rec = {}
    for data, seq, layers, S, B, steps in SP_RUNS:
        tag = f"sharded train data={data} x seq={seq}, {layers} layers, S={S}, B={B}"
        ref = _sp_one_process(layers, S, B)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = launch(_sp_step_rank, data * seq, data, seq, layers, S, B, steps,
                       timeout=SP_LAUNCH_TIMEOUT, num_threads=2)
        wall = time.perf_counter() - t0
        first = ranks[0]["steps"][0]
        d_loss = {k: abs(first[k] - ref[k]) / abs(ref[k])
                  for k in ("loss", "backbone_loss", "decoder_loss")}
        d_gn = abs(first["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"])
        check(max(d_loss.values()) <= SP_LOSS_RTOL and d_gn <= SP_GNORM_RTOL,
              f"{tag}: first step vs one process, losses {d_loss}, grad norm {d_gn:.2e}")
        d_leaf = [_grad_norm_diff(r["grad_norms"], ref["grad_norms"]) for r in ranks]
        d_ctrl = [_grad_norm_diff(r["control_grad_norms"], ref["grad_norms"]) for r in ranks]
        check(max(d for d, _ in d_leaf) <= SP_GRAD_NORM_RTOL,
              f"{tag}: first step's per-parameter gradient norms vs one process {d_leaf}")
        check(min(d for d, _ in d_ctrl) > SP_GRAD_NORM_RTOL,
              f"{tag}: the lost reduce-scatter control passed the gradient gate: {d_ctrl}")
        for i in range(steps):
            digests = {r["steps"][i]["digest"] for r in ranks}
            check(len(digests) == 1, f"{tag}: step {i}: parameters differ across ranks")
            for r in ranks:
                st = r["steps"][i]
                check(all(math.isfinite(st[k]) for k in ("loss", "grad_norm")),
                      f"{tag}: step {i} rank {r['coords']}: non-finite metrics")
                want = {"flash_fwd": layers, "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
                check(st["launches"] == want, f"{tag}: step {i} rank {r['coords']}: launches "
                      f"{st['launches']}, want {want}")
        for r in ranks:
            st = r["steps"]
            log(f"{tag}: rank {r['coords']} q_offset {r['q_offset']}: steps "
                + ", ".join(f"{x['ms']:.0f} ms" for x in st)
                + f", loss {st[0]['loss']:.4f} (backbone {st[0]['backbone_loss']:.4f}, decoder "
                f"{st[0]['decoder_loss']:.4f}), grad norm {st[0]['grad_norm']:.4f}, launches a step "
                f"{st[0]['launches']}, peak {max(x['peak_memory_bytes'] for x in st) / 2**30:.2f} GiB "
                f"(forward + backward {r['fwd_bwd_peak_bytes'] / 2**30:.2f} GiB above the resident "
                f"state), gradient all-reduce alone {r['grad_allreduce_ms']:.0f} ms")
        log(f"{tag}: one process loss {ref['loss']:.4f}, grad norm {ref['grad_norm']:.4f}, peak "
            f"{ref['peak_memory_bytes'] / 2**30:.2f} GiB (forward + backward "
            f"{ref['fwd_bwd_peak_bytes'] / 2**30:.2f} GiB); relative difference of the first step "
            + ", ".join(f"{k} {x:.2e}" for k, x in d_loss.items()) + f", grad norm {d_gn:.2e} "
            f"(limits {SP_LOSS_RTOL}, {SP_GNORM_RTOL}); per-parameter gradient norms, "
            "worst a rank " + ", ".join(f"{d:.2e} ({n})" for d, n in d_leaf) + ", control "
            + ", ".join(f"{d:.2e} ({n})" for d, n in d_ctrl) + f" (limit {SP_GRAD_NORM_RTOL}); "
            f"parameters bitwise equal across ranks every step; {wall:.1f} s with the ranks' "
            "start")
        launches = {k: sum(st["launches"][k] for r in ranks for st in r["steps"])
                    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        rec[f"data{data}_seq{seq}"] = dict(
            config=dict(data=data, seq=seq, layers=layers, S=S, B=B, steps=steps), ranks=ranks,
            one_process=ref, loss_rel_diff=d_loss, grad_norm_rel_diff=d_gn,
            grad_norms_rel_diff=d_leaf, control_grad_norms_rel_diff=d_ctrl, wall_s=wall,
            launches=launches)
    return rec


# ---------------------------------------------------------------------------
# Phase 15: tensor parallelism (K3 / K5a / K5b on head shards, sharded steps
# and generation)
# ---------------------------------------------------------------------------

# The model=2 train steps, one launch each: (ranks' (data, seq) meshes,
# backbone layers, S, B, steps).  The first at full depth on phase 8's batch
# (phase 13's first one-process reference), then data=2 and seq=2 in one
# launch of four ranks, cut to 4 backbone layers on phase 13's second batch
# and reference (four ranks' weights and AdamW state share the card).
TP_RUNS = ((((1, 1),), 16, 2048, 1, 3), (((2, 1), (1, 2)), 4, 1024, 2, 1))
TP_LAUNCH_TIMEOUT = 600.0
TP_GEN_FRAMES = 16
# 15a's gates against the one-process step.  Phase 13's grad-norm limit
# holds as it is; the losses and the per-parameter norms get their own.
# Phase 13's shards compute bitwise the one-process rows, but a TP rank's
# column slice is a GEMM of its own shape and its row-parallel partials are
# summed across ranks, so now and then a bf16 value rounds the other way
# and the flip carries through the layers.  On an H100 sound runs read at
# most 1.06e-5 on a loss (the backbone's, 4 layers) and 3.9e-3 on a
# per-parameter gradient norm (a layer of backbone wv at full depth), where
# phase 13's limits are 1e-5 and 3e-3; the lost copy_to_model control read
# at least 0.74.  The limits sit ~5x and ~2.5x above those readings and
# ~70x below the control.
TP_LOSS_RTOL = 5e-5
TP_GRAD_NORM_RTOL = 1e-2
# 15b's TP prefill c0 logits against the one-process plain bf16 prefill's,
# relative RMS: as above, over 16 layers the two drift apart as two correct
# bf16 evaluations do (phase 3's gross limit; read 2.0e-2 on random
# weights).
TP_PREFILL_RMS_TOL = 5e-2


def _tp_grad_norms(params, dims, mesh) -> dict:
    """:func:`_grad_norms` of the whole model from this rank's shards: the
    squares of each sharded leaf's gradient (per layer for the stacked
    weights) summed over the ``model`` group, as the norms of the gathered
    gradients."""
    from csm_tpu_torch.parallel.collectives import all_reduce_sum
    from csm_tpu_torch.train.loop import flatten

    out = {}
    for (name, p), d in zip(flatten(params).items(), dims):
        g = p.grad.float()
        g = g.reshape(g.shape[0], -1) if ".layers." in name else g.reshape(1, -1)
        sq = g.square().sum(dim=1)
        if d is not None:
            sq = all_reduce_sum(sq, mesh.group("model"))
        out[name] = sq.sqrt().tolist()
    return out


def _tp_backward(cfg, state, batch, max_dec: int, opt, mesh, dims) -> None:
    """One forward and backward of the step's first microbatch with remat
    "dots", the gradients all-reduced over ``batch``, scaled and clipped as
    the train step does (the update is not applied)."""
    import torch

    from csm_tpu_torch.models import csm
    from csm_tpu_torch.parallel import collectives
    from csm_tpu_torch.train.loop import flatten

    leaves = list(flatten(state.params).values())
    for p in leaves:
        p.grad = None
    out = csm.forward(state.params, cfg, batch["input_ids"][0], batch["attention_mask"][0],
                      labels=batch["labels"][0], max_decoder_frames=max_dec, remat=True,
                      remat_policy="dots", mesh=mesh)
    out.loss.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
    collectives.all_reduce_flat_(grads, mesh.group("batch"))
    for p, g in zip(leaves, grads):
        p.grad = g
    opt.clip_(grads, [d is not None for d in dims], mesh.group("model"))


def _tp_lost_copy_control(cfg, state, batch, max_dec: int, opt, mesh, dims) -> dict:
    """The gradient norms (:func:`_tp_grad_norms`) of :func:`_tp_backward`
    with ``copy_to_model``'s backward all-reduce dropped: each rank keeps the
    gradient of its own heads and columns at every column-parallel input."""
    from csm_tpu_torch.parallel import collectives
    from csm_tpu_torch.train.loop import flatten

    real = collectives._CopyToModel.backward
    collectives._CopyToModel.backward = staticmethod(lambda ctx, grad: (grad, None))
    try:
        _tp_backward(cfg, state, batch, max_dec, opt, mesh, dims)
    finally:
        collectives._CopyToModel.backward = real
    norms = _tp_grad_norms(state.params, dims, mesh)
    for p in flatten(state.params).values():
        p.grad = None
    return norms


def _model_allreduce_clock():
    """Wrap the ``model`` group's all-reduce (``collectives._all_reduce_fp32``)
    with a synchronized host clock; returns ``(record, restore)``."""
    import torch

    from csm_tpu_torch.parallel import collectives

    real = collectives._all_reduce_fp32
    rec = {"ms": 0.0, "calls": 0, "bytes": 0}

    def timed(x, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(x, group)
        torch.cuda.synchronize()
        rec["ms"] += (time.perf_counter() - t0) * 1e3
        rec["calls"] += 1
        rec["bytes"] += x.numel() * 4
        return out

    collectives._all_reduce_fp32 = timed

    def restore():
        collectives._all_reduce_fp32 = real

    return rec, restore


def _tp_step_rank(meshes, layers: int, S: int, B: int, steps: int) -> list:
    """One rank of each ``(data, seq)`` x model=2 mesh of ``meshes`` in turn
    (one launch, so one start of the ranks) on the shared card: its shard of
    a random bf16 CSM (seed 0) with ``layers`` backbone layers; the gradient
    norms of the lost ``copy_to_model`` control; ``steps`` train steps
    (remat "dots", AdamW as phase 8) with metrics, launches, ms, peak memory
    and digests of its shard and of its replicated leaves; the first step's
    gradient norms; then one forward and backward with the model group's
    all-reduces timed."""
    import hashlib

    import torch

    sys.path.insert(0, REPO)
    from csm_tpu_torch.models import csm
    from csm_tpu_torch.parallel import make_mesh, shard_params
    from csm_tpu_torch.train import make_optimizer, make_train_step
    from csm_tpu_torch.train.loop import flatten, leaf_dims
    from csm_tpu_torch.utils.synthetic import synthetic_conversation_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = sp_config(layers)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in synthetic_conversation_batch(cfg, S, batch=B, seed=0).items()}
    max_dec = sp_max_dec(S, B)
    out = []
    for data, seq in meshes:
        mesh = make_mesh(data=data, seq=seq, model=2)
        params = shard_params(csm.init_params(cfg, 0, torch.bfloat16, "cuda"), mesh, cfg)
        torch.cuda.empty_cache()
        dims = leaf_dims(cfg, mesh)
        opt = make_optimizer(5e-6, total_steps=100)
        state = opt.init(params)
        control = _tp_lost_copy_control(cfg, state, batch, max_dec, opt, mesh, dims)
        step = make_train_step(cfg, opt, max_dec, remat=True, remat_policy="dots", mesh=mesh)

        def replicated_digest():
            h = hashlib.sha256()
            for (name, t), d in zip(flatten(state.params).items(), dims):
                if d is None:
                    h.update(name.encode())
                    h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy()
                             .tobytes())
            return h.hexdigest()

        runs = []
        for i in range(steps):
            torch.cuda.reset_peak_memory_stats()
            state, m, dt, launches = _timed_step(step, state, batch)
            runs.append(dict(ms=dt * 1e3, launches=launches,
                             peak_memory_bytes=torch.cuda.max_memory_allocated(),
                             digest=_params_digest(state.params),
                             replicated_digest=replicated_digest(), **m))
            if i == 0:
                grad_norms = _tp_grad_norms(state.params, dims, mesh)
        clock, restore = _model_allreduce_clock()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _tp_backward(cfg, state, batch, max_dec, opt, mesh, dims)
            torch.cuda.synchronize()
            clock["fwd_bwd_ms"] = (time.perf_counter() - t0) * 1e3
        finally:
            restore()
        out.append(dict(mesh=dict(mesh.shape), coords=mesh.coords, steps=runs,
                        grad_norms=grad_norms, control_grad_norms=control,
                        model_allreduce=clock,
                        local_params=sum(p.numel() for p in flatten(state.params).values()),
                        local_wq=tuple(state.params["backbone"]["layers"]["wq"].shape)))
        del state, params, step
        torch.cuda.empty_cache()
    return out


def tp_training(sp_refs: dict) -> dict:
    """Phase 15a: the model=2 train steps of ``TP_RUNS`` on ranks spawned by
    ``csm_tpu_torch.parallel.launch`` sharing ``cuda:0`` over gloo, each
    against phase 13's one-process step on the same configuration and global
    batch (``sp_refs``, by (layers, S, B)): losses, grad norm, per-parameter
    gradient norms (the lost ``copy_to_model`` control must break that
    gate), each model rank's shard bitwise equal across its data / seq
    replicas and the replicated parameters bitwise equal on every rank."""
    import torch

    from csm_tpu_torch.parallel.launch import launch

    rec = {}
    for meshes, layers, S, B, steps in TP_RUNS:
        ref = sp_refs[(layers, S, B)]
        world = 2 * meshes[0][0] * meshes[0][1]
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = launch(_tp_step_rank, world, meshes, layers, S, B, steps,
                     timeout=TP_LAUNCH_TIMEOUT, num_threads=2)
        wall = time.perf_counter() - t0
        for k, (data, seq) in enumerate(meshes):
            ranks = [r[k] for r in out]
            tag = f"TP train data={data} x seq={seq} x model=2, {layers} layers, S={S}, B={B}"
            first = ranks[0]["steps"][0]
            d_loss = {x: abs(first[x] - ref[x]) / abs(ref[x])
                      for x in ("loss", "backbone_loss", "decoder_loss")}
            d_gn = abs(first["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"])
            check(max(d_loss.values()) <= TP_LOSS_RTOL and d_gn <= SP_GNORM_RTOL,
                  f"{tag}: first step vs one process, losses {d_loss}, grad norm {d_gn:.2e}")
            d_leaf = [_grad_norm_diff(r["grad_norms"], ref["grad_norms"]) for r in ranks]
            d_ctrl = [_grad_norm_diff(r["control_grad_norms"], ref["grad_norms"]) for r in ranks]
            check(max(d for d, _ in d_leaf) <= TP_GRAD_NORM_RTOL,
                  f"{tag}: first step's per-parameter gradient norms vs one process {d_leaf}")
            check(min(d for d, _ in d_ctrl) > TP_GRAD_NORM_RTOL,
                  f"{tag}: the lost copy_to_model control passed the gradient gate: {d_ctrl}")
            want = {"flash_fwd": layers, "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
            for i in range(steps):
                for m in (0, 1):
                    digests = {r["steps"][i]["digest"] for r in ranks if r["coords"]["model"] == m}
                    check(len(digests) == 1, f"{tag}: step {i}: model rank {m}'s shards differ "
                          "across the data / seq replicas")
                check(len({r["steps"][i]["replicated_digest"] for r in ranks}) == 1,
                      f"{tag}: step {i}: the replicated parameters differ across ranks")
                for r in ranks:
                    st = r["steps"][i]
                    check(all(math.isfinite(st[x]) for x in ("loss", "grad_norm")),
                          f"{tag}: step {i} rank {r['coords']}: non-finite metrics")
                    check(st["launches"] == want, f"{tag}: step {i} rank {r['coords']}: "
                          f"launches {st['launches']}, want {want}")
            for r in ranks:
                st, ar = r["steps"], r["model_allreduce"]
                log(f"{tag}: rank {r['coords']} ({r['local_params'] / 1e6:.0f} M parameters, wq "
                    f"{r['local_wq']}): steps " + ", ".join(f"{x['ms']:.0f} ms" for x in st)
                    + f", loss {st[0]['loss']:.4f}, grad norm {st[0]['grad_norm']:.4f}, launches "
                    f"a step {st[0]['launches']}, peak "
                    f"{max(x['peak_memory_bytes'] for x in st) / 2**30:.2f} GiB; model-group "
                    f"all-reduces of a forward + backward: {ar['calls']} calls, "
                    f"{ar['bytes'] / 1e9:.2f} GB, {ar['ms']:.0f} ms of {ar['fwd_bwd_ms']:.0f} ms")
            log(f"{tag}: one process loss {ref['loss']:.4f}, grad norm {ref['grad_norm']:.4f}; "
                "relative difference of the first step "
                + ", ".join(f"{x} {v:.2e}" for x, v in d_loss.items()) + f", grad norm "
                f"{d_gn:.2e} (limits {TP_LOSS_RTOL}, {SP_GNORM_RTOL}); per-parameter gradient "
                "norms, worst a rank " + ", ".join(f"{d:.2e} ({n})" for d, n in d_leaf)
                + ", lost copy_to_model control " + ", ".join(f"{d:.2e} ({n})" for d, n in d_ctrl)
                + f" (limit {TP_GRAD_NORM_RTOL}); {wall:.1f} s with the ranks' start")
            launches = {x: sum(st["launches"][x] for r in ranks for st in r["steps"]) for x in want}
            rec[f"data{data}_seq{seq}_model2"] = dict(
                config=dict(data=data, seq=seq, model=2, layers=layers, S=S, B=B, steps=steps),
                ranks=ranks, loss_rel_diff=d_loss, grad_norm_rel_diff=d_gn,
                grad_norms_rel_diff=d_leaf, control_grad_norms_rel_diff=d_ctrl,
                launch_wall_s=wall, launches=launches)
    return rec


def _traced_generate(params, cfg, ids, mask, n_frames: int, mesh=None):
    """Greedy ``generation.generate`` of ``n_frames`` with every frame's
    smallest c0 top-2 gap (a host read, which waits for the frame's
    backbone pass) and the host clock at each: ``(frames, gaps, seconds
    from the call to each frame's c0 logits)``."""
    from csm_tpu_torch import generation

    gaps, stamps = [], []
    orig = generation.decode_frame
    t0 = time.perf_counter()

    def traced(params, config, last_h, c0_logits, **kw):
        top2 = c0_logits.float().topk(2, dim=-1).values
        gaps.append((top2[:, 0] - top2[:, 1]).min().item())
        stamps.append(time.perf_counter() - t0)
        return orig(params, config, last_h, c0_logits, **kw)

    generation.decode_frame = traced
    try:
        frames = generation.generate(params, cfg, ids, mask, max_new_frames=n_frames, greedy=True,
                                     stop_on_all_zeros=False, mesh=mesh)
    finally:
        generation.decode_frame = orig
    return frames, gaps, stamps


def _prefill_logits(params, cfg, ids, mask, mesh=None):
    """The c0 logits of the bf16 flash prefill of ``ids`` (fp32, numpy)."""
    import torch

    from csm_tpu_torch.models import csm, llama

    nkv = llama.local_heads(params["backbone"]["layers"], cfg.backbone)[1]
    cache = llama.KVCache.create(cfg.backbone, ids.shape[0], 128, dtype=torch.bfloat16,
                                 device="cuda", num_kv_heads=nkv)
    with torch.no_grad():
        out = csm.forward(params, cfg, torch.as_tensor(ids, device="cuda"),
                          torch.as_tensor(mask, device="cuda"), cache=cache, flash_prefill=True,
                          mesh=mesh)
    return out.logits.float().cpu().numpy()


def _tp_generate_rank(ckpt: str) -> dict:
    """One rank of a model=2 mesh on the shared card: its shard of the
    sharpened weights, the flash prefill's c0 logits, then 16 greedy frames
    from phase 6's 64-frame prompt (K3's launches counted, each frame's c0
    logits stamped on the host clock)."""
    import torch

    sys.path.insert(0, REPO)
    from csm_tpu_torch import CSMModel
    from csm_tpu_torch.ops.flash_attention import flash_fwd
    from csm_tpu_torch.parallel import make_mesh, shard_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    model = CSMModel.from_pretrained(ckpt, dtype=torch.bfloat16, device="cuda")
    cfg = model.config
    mesh = make_mesh(data=1, model=2)
    params = shard_params(model.params, mesh, cfg)
    del model
    torch.cuda.empty_cache()
    ids, mask = prompt(cfg, 1, 64, seed=1)
    logits = _prefill_logits(params, cfg, ids, mask, mesh)
    flash_fwd.launches = 0
    torch.cuda.synchronize()
    frames, gaps, stamps = _traced_generate(params, cfg, ids, mask, TP_GEN_FRAMES, mesh)
    steps = [b - a for a, b in zip(stamps, stamps[1:])]
    return dict(frames=frames, gaps=gaps, logits=logits, flash_fwd=flash_fwd.launches,
                first_frame_ms=stamps[0] * 1e3,
                frame_step_ms=sorted(steps)[len(steps) // 2] * 1e3, coords=mesh.coords)


def tp_generation() -> dict:
    """Phase 15b: 16 greedy bf16 frames on a model=2 mesh of two ranks on
    the card, from phase 6's prompt on phase 9's sharpened weights, against
    the one-process plain bf16 path: tokens equal where the smallest c0
    top-2 gap exceeds SHARP_GAP (reported either way), both ranks' tokens
    identical, K3 once per layer a rank in the prefill, the prefill's c0
    logits within TP_PREFILL_RMS_TOL of one process's."""
    import numpy as np
    import torch

    from csm_tpu_torch import CSMModel
    from csm_tpu_torch.parallel.launch import launch

    model = CSMModel.from_pretrained(SHARP_DIR, dtype=torch.bfloat16, device="cuda")
    cfg = model.config
    ids, mask = prompt(cfg, 1, 64, seed=1)
    ref_logits = _prefill_logits(model.params, cfg, ids, mask)
    ref, gaps, _ = _traced_generate(model.params, cfg, ids, mask, TP_GEN_FRAMES)
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch(_tp_generate_rank, 2, SHARP_DIR, timeout=TP_LAUNCH_TIMEOUT, num_threads=2)
    wall = time.perf_counter() - t0
    L = cfg.backbone.num_hidden_layers
    gap = min(gaps)
    gated = gap > SHARP_GAP
    same = [bool(np.array_equal(r["frames"], ref)) for r in ranks]
    share = [float((r["frames"] == ref).mean()) if r["frames"].shape == ref.shape else 0.0
             for r in ranks]
    logit_rms = [rel_rms(torch.as_tensor(r["logits"]), torch.as_tensor(ref_logits)) for r in ranks]
    check(ref.shape == (1, TP_GEN_FRAMES, cfg.audio_num_codebooks),
          f"TP generate: one-process frames {ref.shape}")
    check(bool(np.array_equal(ranks[0]["frames"], ranks[1]["frames"])),
          "TP generate: the two ranks' tokens differ")
    check(all(r["flash_fwd"] == L for r in ranks),
          f"TP generate: K3 launches a rank {[r['flash_fwd'] for r in ranks]}, want {L}")
    check(max(logit_rms) <= TP_PREFILL_RMS_TOL,
          f"TP generate: prefill c0 logits relative RMS {logit_rms} vs one process")
    if gated:
        check(all(same), f"TP generate: tokens differ from one process ({share} equal) with a "
              f"min c0 top-2 gap of {gap:.3f} > {SHARP_GAP}")
    log(f"TP generate (model=2, bf16, sharpened weights, 64-frame prompt, {TP_GEN_FRAMES} greedy "
        f"frames): tokens equal to one process {same} (share {share}), ranks identical "
        f"{bool(np.array_equal(ranks[0]['frames'], ranks[1]['frames']))}; min c0 top-2 gap "
        f"{gap:.3f} ({'gated' if gated else 'not gated'} at {SHARP_GAP}); prefill c0 logits "
        f"relative RMS {[f'{x:.2e}' for x in logit_rms]} (limit {TP_PREFILL_RMS_TOL}); K3 launches "
        f"a rank {[r['flash_fwd'] for r in ranks]}; c0 logits of the first frame after "
        f"{[round(r['first_frame_ms'], 1) for r in ranks]} ms (prefill), then a frame step every "
        f"{[round(r['frame_step_ms'], 1) for r in ranks]} ms (median) a rank (the ranks "
        f"time-share one card); {wall:.1f} s with the ranks' start")
    return dict(frames_equal=same, token_share_equal=share, min_c0_top2_gap=gap, gated=gated,
                prefill_logits_rel_rms=logit_rms, wall_s=wall,
                launches={"flash_fwd": sum(r["flash_fwd"] for r in ranks)},
                ranks=[{k: v for k, v in r.items() if k not in ("frames", "logits")}
                       for r in ranks])


def tensor_parallelism(gen, sp_refs: dict) -> dict:
    """Phase 15: K3 / K5a / K5b at a model=2 rank's CSM-1B backbone head
    shard (16 query / 4 KV heads, hd 64, bf16: K3 at the prefill shape of
    phase 2 and with LSE, K5a and K5b at phase 7's B = 1, S = 2048), then
    the model=2 train steps (15a) and generation (15b)."""
    import torch

    rec = dict(flash=check_flash(8, gen, "bfloat16", nq=16, nkv=4),
               flash_bwd=check_flash_bwd(1, TRAIN_S, gen, "bfloat16", nq=16, nkv=4))
    torch.cuda.empty_cache()
    rec["train"] = tp_training(sp_refs)
    try:
        rec["generate"] = tp_generation()
    finally:
        shutil.rmtree(SHARP_DIR, ignore_errors=True)
    return rec


# ---------------------------------------------------------------------------
# Phase 16: the last modules (entry, the attention switch, profiling,
# measure, warm-up, the example scripts, the multi-rank dryrun)
# ---------------------------------------------------------------------------

TOOLING_DIR = os.path.join(REPO, "csm_tpu_torch", "_build", "tooling_smoke")
ENTRY_LAUNCHES = 16  # one K3 a backbone layer
SWITCH_S = 128
# Phase 3's gross gate: the plain attention against the flash kernel.
SWITCH_RMS_TOL = 5e-2
MEASURE_S = (128, 512, 2048)
TRACE_FRAMES, TIMER_FRAMES, TIMER_CALLS = 8, 16, 3
TRACED = ("flash_fwd_wgmma_kernel", "bbq_step_kernel", "fused_decoder_kernel")
WARM_FRAMES, WARM_PROMPT = 16, 64
# A warmed first call against the second: a first call that still paid for
# a build, a library load or the allocator's growth takes several times as
# long.
WARM_FIRST_RATIO = 2.0
EX_FRAMES = 16
EX_TEXTS = ("The parcel came this morning.", "Shall we take the early train?",
            "It was loud, and far too short.")
CHILD_TIMEOUT = 300.0

# Run in a child interpreter with CSM_TPU_ATTENTION=xla: a forward of a
# small bf16 model on the card whose shapes the flash kernels take, under
# the switch read at import and then under "auto" (the control).
_XLA_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from csm_tpu_torch import CSMConfig
from csm_tpu_torch.models import csm
from csm_tpu_torch.ops import attention
from csm_tpu_torch.ops.flash_attention import flash_fwd
cfg = CSMConfig.tiny()
params = csm.init_params(cfg, 0, torch.bfloat16, "cuda")
ids = torch.ones((1, 16, 33), dtype=torch.long, device="cuda")
mask = torch.ones((1, 16, 33), dtype=torch.float32, device="cuda")
read = attention._impl
launches = {}
for impl in (read, "auto"):
    attention.set_attention_impl(impl)
    before = flash_fwd.launches
    csm.forward(params, cfg, ids, mask)
    torch.cuda.synchronize()
    launches[impl] = flash_fwd.launches - before
print(json.dumps({"impl": read, "launches": launches, "layers": cfg.backbone.num_hidden_layers}))
"""

# Run in a child interpreter: phase 6's checkpoint under quantize(bits=4),
# with ("warm") or without ("cold") ``warmup_generation`` first, then two
# 16-frame greedy calls at B = 1 from phase 6's prompt; every nvcc started
# (by _build) is recorded.
_WARM_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke
from csm_tpu_torch import CSMModel
from csm_tpu_torch.ops import _build
from csm_tpu_torch.utils.warmup import warmup_generation
mode, ckpt, frames, S = sys.argv[2], sys.argv[3], int(sys.argv[4]), int(sys.argv[5])
nvcc = []
start = _build._start
def watched(name):
    job = start(name)
    if job is not None:
        nvcc.append(name)
    return job
_build._start = watched
t0 = time.perf_counter()
model = CSMModel.from_pretrained(ckpt, dtype=torch.bfloat16).quantize(bits=4)
torch.cuda.synchronize()
rec = dict(mode=mode, load_s=time.perf_counter() - t0)
wrappers = chip_smoke.launch_counters()
for w in wrappers.values():
    w.launches = 0
if mode == "warm":
    t0 = time.perf_counter()
    rec["runs"] = warmup_generation(model.params, model.config, batch_sizes=(1, 8),
                                    prompt_buckets=(S,), frame_budgets=(frames,),
                                    qdec=model._qdec, qbb=model._qbb, qsb=model._qsb)
    rec["warmup_s"] = time.perf_counter() - t0
    rec["warmup_launches"] = {k: w.launches for k, w in wrappers.items()}
    rec["loaded_after_warmup"] = sorted(_build._loaded)
rec["nvcc_before_calls"] = list(nvcc)
ids, mask = chip_smoke.prompt(model.config, 1, S, seed=1)
calls = []
for _ in range(2):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.generate(ids, mask, max_new_frames=frames, greedy=True, stop_on_all_zeros=False)
    torch.cuda.synchronize()
    calls.append(1e3 * (time.perf_counter() - t0))
rec.update(call_ms=calls, frames=list(out.shape), nvcc=nvcc)
print(json.dumps(rec))
"""


def _child(code: str, *args, env=None) -> dict:
    """Run ``code`` in a fresh interpreter; its last stdout line as JSON."""
    res = subprocess.run([sys.executable, "-c", code, REPO, *map(str, args)], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=CHILD_TIMEOUT)
    if res.returncode != 0:
        raise RuntimeError(f"child process failed (rc={res.returncode}):\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def _counts(wrappers) -> dict:
    return {k: w.launches for k, w in wrappers.items()}


def _zero(wrappers) -> None:
    for w in wrappers.values():
        w.launches = 0


def entry_and_switch(params, cfg) -> dict:
    """16a: ``entry()``'s CSM-1B forward, then the same uncached forward on
    phase 6's weights under each value of the attention switch, and a child
    interpreter started with ``CSM_TPU_ATTENTION=xla``."""
    import torch

    from csm_tpu_torch.entry import entry
    from csm_tpu_torch.models import csm
    from csm_tpu_torch.ops import attention

    wrappers = launch_counters()
    fn, args = entry()
    _zero(wrappers)
    logits = fn(*args)
    torch.cuda.synchronize()
    n_entry = wrappers["flash_fwd"].launches
    del args
    ok = (tuple(logits.shape) == (1, cfg.audio_vocab_size)
          and bool(torch.isfinite(logits.float()).all()))
    log(f"entry(): logits {tuple(logits.shape)} {logits.dtype}, finite {ok}, K3 launches {n_entry}")
    check(ok, f"entry(): logits {tuple(logits.shape)}, want finite (1, {cfg.audio_vocab_size})")
    check(n_entry == ENTRY_LAUNCHES, f"entry(): {n_entry} K3 launches, want {ENTRY_LAUNCHES}")

    ids, mask = (torch.as_tensor(x, device="cuda") for x in prompt(cfg, 1, SWITCH_S, seed=1))
    out, launches = {}, {}
    try:
        for impl in ("auto", "flash", "xla"):
            attention.set_attention_impl(impl)
            before = wrappers["flash_fwd"].launches
            with torch.no_grad():
                out[impl] = csm.forward(params, cfg, ids, mask).logits.float()
            torch.cuda.synchronize()
            launches[impl] = wrappers["flash_fwd"].launches - before
    finally:
        attention.set_attention_impl("auto")
    same = torch.equal(out["auto"], out["flash"])
    rms = rel_rms(out["xla"], out["auto"])
    log(f"attention switch, CSM-1B forward at S = {SWITCH_S}: K3 launches {launches}; auto "
        f"bitwise equal to flash: {same}; xla vs auto relative RMS {rms:.3e} (limit "
        f"{SWITCH_RMS_TOL})")
    check(launches == {"auto": ENTRY_LAUNCHES, "flash": ENTRY_LAUNCHES, "xla": 0},
          f"attention switch: K3 launches {launches}, want 16 / 16 / 0")
    check(same, "attention switch: auto and flash logits differ")
    check(rms <= SWITCH_RMS_TOL, f"attention switch: xla vs auto relative RMS {rms:.3e}")
    child = _child(_XLA_CHILD, env={**os.environ, "CSM_TPU_ATTENTION": "xla"})
    log(f"child with CSM_TPU_ATTENTION=xla: switch read {child['impl']!r}, K3 launches "
        f"{child['launches']} (auto the control)")
    check(child["impl"] == "xla" and child["launches"] == {"xla": 0, "auto": child["layers"]},
          f"child with CSM_TPU_ATTENTION=xla: {child}")
    return dict(entry_launches=n_entry, switch_launches=launches, auto_equals_flash=same,
                xla_rel_rms=rms, child=child,
                launches=dict(flash_fwd=n_entry + launches["auto"] + launches["flash"]))


def measure_prefill(params, cfg) -> dict:
    """16b: ``prefill_ms_on_device`` and ``prefill_flops`` at each
    ``MEASURE_S``, the model-FLOPs share of the data sheet's peak, each time
    beside its bounds (gated at the FLOPs bound)."""
    from csm_tpu_torch.utils.measure import (H100_BF16_DENSE_FLOPS, prefill_flops,
                                             prefill_ms_on_device)

    wrappers = launch_counters()
    _zero(wrappers)
    rows = {}
    for S in MEASURE_S:
        ms = prefill_ms_on_device(params, cfg, S)
        flops = prefill_flops(None, cfg, S)
        same = flops == prefill_flops(params, cfg, S)
        flops_ms = flops / H100_BF16_DENSE_FLOPS * 1e3
        weight_bytes = sum(t.numel() * t.element_size()
                           for t in params["backbone"]["layers"].values())
        bytes_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
        share = flops / (ms * 1e-3 * H100_BF16_DENSE_FLOPS)
        rows[S] = dict(ms=ms, flops=flops, flops_bound_ms=flops_ms, weight_bytes_bound_ms=bytes_ms,
                       model_flops_share=share)
        log(f"prefill S = {S}: {ms:.3f} ms (median of 3, CUDA events), {flops / 1e12:.3f} TFLOP "
            f"-> FLOPs bound {flops_ms:.3f} ms, the backbone weights' bytes {bytes_ms:.3f} ms; "
            f"model-FLOPs share {share:.1%}")
        check(same, f"prefill_flops at S = {S}: the shapes' count differs from the params'")
        check(ms >= flops_ms, f"prefill S = {S}: {ms:.3f} ms is under its FLOPs bound "
              f"{flops_ms:.3f} ms (the count or the clock is wrong)")
    launches = _counts(wrappers)
    want = len(MEASURE_S) * 4 * ENTRY_LAUNCHES  # a warm-up call and 3 timed ones each
    check(launches["flash_fwd"] == want, f"measure: {launches['flash_fwd']} K3 launches, want {want}")
    for S in MEASURE_S:
        rows[S]["profile"] = profile_prefill(params, cfg, S)
    return dict(by_S=rows, launches=launches)


# Host calls that wait for the card or copy to it, counted in a profiled
# prefill.
HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpyAsync")


def profile_prefill(params, cfg, S: int) -> dict:
    """Where the time of the prefill ``prefill_ms_on_device`` times goes:
    device busy share and kernels under ``torch.profiler``, and the host's
    waits and copies."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from csm_tpu_torch.models import csm
    from csm_tpu_torch.models.llama import KVCache

    rng = np.random.default_rng(0)
    ids = np.zeros((1, S, cfg.frame_width), np.int64)
    ids[..., -1] = rng.integers(1, cfg.text_vocab_size, (1, S))
    mask = (ids > 0).astype(np.float32)
    ids, mask = torch.as_tensor(ids, device="cuda"), torch.as_tensor(mask, device="cuda")
    cache = KVCache.create(cfg.backbone, 1, ((S + 128 + 127) // 128) * 128,
                           dtype=params["backbone"]["final_norm"].dtype, device="cuda")
    with torch.no_grad():
        csm.forward(params, cfg, ids, mask, cache=cache, flash_prefill=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            csm.forward(params, cfg, ids, mask, cache=cache, flash_prefill=True)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rec = device_breakdown(prof, ("flash_fwd",), f"prefill S = {S}", wall_ms, 1, "prefill")
    waits = {n: sum(e.name == n for e in prof.events()) for n in HOST_WAITS}
    log(f"  prefill S = {S}: host waits and copies {waits}")
    return dict(rec, host_waits=waits)


def profiling_tools(model, cfg, e2e: dict) -> dict:
    """16c: ``trace()`` around an 8-frame ``quantize(bits=4)`` generate
    (its kernel events must name K3, K1q and K2), ``FrameTimer`` over three
    16-frame calls beside phase 6's reading, and ``enable_nan_checks`` on a
    CUDA tensor."""
    import glob

    import torch

    from csm_tpu_torch.utils import FrameTimer, enable_nan_checks, trace
    from csm_tpu_torch.utils.profiling import sync

    wrappers = launch_counters()
    model.quantize(bits=4)
    ids, mask = prompt(cfg, 1, 64, seed=1)
    kw = dict(greedy=True, stop_on_all_zeros=False)
    model.generate(ids, mask, max_new_frames=2, **kw)
    shutil.rmtree(TOOLING_DIR, ignore_errors=True)
    _zero(wrappers)
    with trace(TOOLING_DIR, name="generate"):
        model.generate(ids, mask, max_new_frames=TRACE_FRAMES, **kw)
        torch.cuda.synchronize()
    files = glob.glob(os.path.join(TOOLING_DIR, "*.pt.trace.json"))
    names, region = set(), False
    if len(files) == 1:
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        names = {e["name"] for e in events if e.get("cat") == "kernel"}
        region = any(e.get("name") == "generate" for e in events)
    seen = {k: sum(k in n for n in names) > 0 for k in TRACED}
    log(f"trace(): {len(files)} file(s), {len(names)} distinct kernels; port kernels named {seen}")
    check(len(files) == 1 and all(seen.values()) and region,
          f"trace(): files {files}, port kernels named {seen}")

    timer = FrameTimer()
    for _ in range(TIMER_CALLS):
        with timer.step(frames=TIMER_FRAMES):
            frames = model.generate(ids, mask, max_new_frames=TIMER_FRAMES, **kw)
            sync(model.params)
    summary = timer.summary()
    check(frames.shape == (1, TIMER_FRAMES, cfg.audio_num_codebooks),
          f"FrameTimer run: frames {frames.shape}")
    log(f"FrameTimer over {TIMER_CALLS} {TIMER_FRAMES}-frame quantize(bits=4) B=1 calls: "
        f"{summary['frames_per_sec']:.2f} frames/s, p50 {summary['p50_step_ms']:.1f} ms, real-time "
        f"factor {summary['audio_realtime_factor']:.2f} (phase 6: "
        f"{e2e['quantize4_B1']['frames_per_s']:.2f} frames/s, prefill included)")
    launches = _counts(wrappers)

    x = torch.tensor([-1.0, 4.0], device="cuda")
    raised = False
    try:
        enable_nan_checks(True)
        try:
            torch.log(x)
        except FloatingPointError:
            raised = True
    finally:
        enable_nan_checks(False)
    after = bool(torch.isnan(torch.log(x)).any())
    log(f"enable_nan_checks: raised on log(-1) on the card {raised}; after off, NaN returned {after}")
    check(raised and after, f"enable_nan_checks: raised {raised}, returned NaN after off {after}")
    shutil.rmtree(TOOLING_DIR, ignore_errors=True)
    return dict(trace_kernels=seen, n_trace_kernels=len(names), frame_timer=summary,
                nan_raised=raised, nan_after_off=after, launches=launches)


def warmup_children() -> dict:
    """16d: the warm-up in a fresh child process (2 runs, K3 / K1q-4 / K2
    launched, every kernel library loaded, no nvcc), its first real call
    against its second (gated), and a cold child without it (a reading)."""
    warm = _child(_WARM_CHILD, "warm", E2E_CKPT, WARM_FRAMES, WARM_PROMPT)
    cold = _child(_WARM_CHILD, "cold", E2E_CKPT, WARM_FRAMES, WARM_PROMPT)
    wl = warm["warmup_launches"]
    first, second = warm["call_ms"]
    log(f"warm-up child: {warm['runs']} runs in {warm['warmup_s']:.2f} s, launches {wl}, "
        f"libraries loaded {warm['loaded_after_warmup']}, nvcc started {warm['nvcc']}; then "
        f"{WARM_FRAMES}-frame calls {first:.1f} ms, {second:.1f} ms (ratio {first / second:.2f}, "
        f"limit {WARM_FIRST_RATIO})")
    c1, c2 = cold["call_ms"]
    log(f"cold child (no warm-up): {c1:.1f} ms, {c2:.1f} ms (ratio {c1 / c2:.2f}); nvcc started "
        f"{cold['nvcc']}")
    check(warm["runs"] == 2, f"warm-up: {warm['runs']} runs, want 2")
    for k in ("flash_fwd", "bb_decode_q4", "fused_decoder"):
        check(wl[k] > 0, f"warm-up: {k} never launched ({wl})")
    check(set(warm["loaded_after_warmup"]) >= set(KERNELS),
          f"warm-up: loaded {warm['loaded_after_warmup']}, want {KERNELS}")
    check(not warm["nvcc"] and not cold["nvcc"],
          f"nvcc ran in a child: warm {warm['nvcc']}, cold {cold['nvcc']}")
    check(first <= WARM_FIRST_RATIO * second,
          f"warm-up: first call {first:.1f} ms > {WARM_FIRST_RATIO} x the second {second:.1f} ms")
    check(warm["frames"] == [1, WARM_FRAMES, 32] == cold["frames"],
          f"warm-up children: frames {warm['frames']}, {cold['frames']}")
    return dict(warm=warm, cold=cold, launches=wl)


def example_scripts() -> dict:
    """16e: ``csm_tpu_torch.examples.generate`` (int4 offline, int4
    streamed, int8) and ``.serve`` (4 slots, three texts) in-process on
    phase 6's checkpoint, with random full-width Mimi weights in the HF
    layout, phase 14's char-level tokenizer stand-in and a 24 kHz clip as
    the context."""
    import numpy as np

    from csm_tpu_torch.checkpoint.safetensors_io import save_file
    from csm_tpu_torch.codec import MimiCodecConfig
    from csm_tpu_torch.data.audio_io import load_wav, save_wav
    from csm_tpu_torch.examples import generate as gen_example
    from csm_tpu_torch.examples import serve as serve_example

    d = os.path.join(TOOLING_DIR, "examples")
    os.makedirs(d, exist_ok=True)
    mimi_path = os.path.join(d, "mimi.safetensors")
    save_file(mimi_hf_state_dict(MimiCodecConfig(), seed=0), mimi_path)
    clip = os.path.join(d, "context.wav")
    save_wav(clip, _speechlike(2 * 24000, 24000, 1, seed=2), 24000)
    for m in (gen_example, serve_example):
        m.load_llama3_tokenizer = lambda *a, **k: CharTokenizer()
    wrappers = launch_counters()
    _zero(wrappers)
    common = ["--model", E2E_CKPT, "--mimi", mimi_path, "--bf16", "--topk", "1",
              "--frames", str(EX_FRAMES), "--context", clip,
              "--context-text", "We have a lot to talk about.",
              "--text", "This voice is cloned from the context."]
    runs, times = {}, {}
    for tag, extra in (("int4", ["--quantize", "--bits", "4"]),
                       ("int4_stream", ["--quantize", "--bits", "4", "--stream"]),
                       ("int8", ["--quantize"])):
        out = os.path.join(d, f"{tag}.wav")
        t0 = time.perf_counter()
        runs[tag] = gen_example.main(common + extra + ["--out", out])
        times[tag] = time.perf_counter() - t0
        wave, rate = load_wav(out)
        n = runs[tag]["frames"].shape[1]
        runs[tag]["wav_shape"] = list(wave.shape)
        check(rate == 24000 and wave.shape == (1, n * 1920) and n > 0,
              f"examples.generate {tag}: {n} frames, WAV {wave.shape} at {rate} Hz")
    a, b = runs["int4"], runs["int4_stream"]
    same = np.array_equal(a["frames"], b["frames"])
    err = (float(np.abs(a["wave"] - b["wave"]).max()) if a["wave"].shape == b["wave"].shape
           else float("inf"))
    ok = same and bool(np.allclose(b["wave"], a["wave"], rtol=WAVE_RTOL, atol=WAVE_ATOL))
    log(f"examples.generate: int4 {a['frames'].shape[1]} frames in {times['int4']:.1f} s, "
        f"streamed {b['frames'].shape[1]} in {times['int4_stream']:.1f} s (frames equal {same}, PCM "
        f"max |diff| {err:.3e}, phase 12's gate rtol {WAVE_RTOL} atol {WAVE_ATOL}), int8 "
        f"{runs['int8']['frames'].shape[1]} in {times['int8']:.1f} s")
    check(ok, f"examples.generate: streamed vs offline frames equal {same}, PCM diff {err:.3e}")
    gen_launches = _counts(wrappers)

    _zero(wrappers)
    prefix = os.path.join(d, "serve")
    t0 = time.perf_counter()
    results = serve_example.main(["--model", E2E_CKPT, "--mimi", mimi_path, "--slots", "4",
                                  "--frames", str(EX_FRAMES), "--out-prefix", prefix,
                                  "--texts", *EX_TEXTS])
    serve_s = time.perf_counter() - t0
    serve_launches = _counts(wrappers)
    lens = {}
    for rid in range(len(EX_TEXTS)):
        n = results[rid].shape[0] if rid in results else -1
        wave, _ = load_wav(f"{prefix}_{rid}.wav") if n > 0 else (np.zeros((1, 0)), 0)
        lens[rid] = (n, wave.shape[1])
        check(n > 0 and wave.shape == (1, n * 1920),
              f"examples.serve: request {rid} {n} frames, WAV {wave.shape}")
    log(f"examples.serve: 3 requests on 4 slots in {serve_s:.1f} s, (frames, samples) {lens}; "
        f"launches generate {gen_launches}, serve {serve_launches}")
    for k in ("flash_fwd", "bb_decode_q", "bb_decode_q4", "fused_decoder"):
        check(gen_launches[k] > 0, f"examples.generate: {k} never launched ({gen_launches})")
    for k in ("flash_fwd", "bb_decode_q", "fused_decoder"):
        check(serve_launches[k] > 0, f"examples.serve: {k} never launched ({serve_launches})")
    return dict(generate={k: dict(frames=r["frames"].shape[1], wav_shape=r["wav_shape"],
                                  seconds=times[k]) for k, r in runs.items()},
                streamed_equal=same, streamed_pcm_max_abs=err, serve_seconds=serve_s,
                serve=lens, launches={k: gen_launches[k] + serve_launches[k] for k in gen_launches})


def last_modules(model, cfg, e2e: dict) -> dict:
    """Phase 16, on phase 6's model and checkpoint; removes the checkpoint
    when done."""
    import numpy as np

    from csm_tpu_torch.entry import dryrun_multichip

    rec = {}
    try:
        rec["entry"] = entry_and_switch(model.params, cfg)
        rec["measure"] = measure_prefill(model.params, cfg)
        rec["profiling"] = profiling_tools(model, cfg, e2e)
        rec["warmup"] = warmup_children()
        rec["examples"] = example_scripts()
        t0 = time.perf_counter()
        m = dryrun_multichip(4)
        rec["dryrun"] = dict(metrics=m, seconds=time.perf_counter() - t0)
        check(all(np.isfinite(v) for v in m.values()), f"dryrun_multichip(4): {m}")
    finally:
        shutil.rmtree(E2E_CKPT, ignore_errors=True)
        shutil.rmtree(TOOLING_DIR, ignore_errors=True)
    return rec


# ---------------------------------------------------------------------------
# Phase 17: the hybrid backbone (Granite-4.0-H-Micro) and its mixer step
# ---------------------------------------------------------------------------

SSM_BATCHES = (1, 8, 32)


def granite_config():
    """CSM on Granite-4.0-H-Micro's backbone at its published widths."""
    from csm_tpu_torch import CSMConfig
    from csm_tpu_torch.config import HybridConfig

    return CSMConfig.from_dict(dict(CSMConfig().to_dict(), text_vocab_size=100352,
                                    backbone_config=HybridConfig().to_dict()))


def ssm_bound(c, B: int):
    """The least time of one mixer step launch at batch ``B`` (bf16): each
    stream's state read and written once, its ``in_proj`` row read, its conv
    state read and written, the layer's conv and per-head parameters read
    once, the f32 gated output written; its operations (5 a state element,
    the conv's 4 multiply-adds a channel) at the fp32 rate it computes in."""
    H, P, N = c.mamba_n_heads, c.mamba_d_head, c.mamba_d_state
    K, C = c.mamba_d_conv, c.conv_dim
    n_bytes = (2 * (2 * B * H * P * N + B * c.in_proj_dim + 2 * B * (K - 1) * C + C * K + C
                    + 3 * H) + 4 * B * c.mamba_inner)
    return bound_ms(n_bytes, 5 * B * H * P * N + 2 * K * B * C, "float32")


def check_ssm(c, B: int, gen) -> dict:
    """The mixer step kernel against its plain version at the published
    widths, bf16 activations, parameters and states, three consecutive
    launches each from the plain version's states: the conv state bitwise,
    the gated output within 1e-4 of its largest value (the two differ by the
    order of float32 sums), the state within one bf16 step at its largest
    value (2^-7 of it: a float32 sum may round to the other side); the
    control, the plain version from a zeroed state (a state lost between
    frames), must break the output's gate.  Then times beside the bound and
    the plain version."""
    import torch

    from csm_tpu_torch.ops import ssm

    dev, H, C = "cuda", c.mamba_n_heads, c.conv_dim
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), H, device=dev))
    lp = {"conv_w": randn(C, c.mamba_d_conv, scale=0.5), "conv_b": randn(C, scale=0.1),
          "dt_bias": (dt + torch.log(-torch.expm1(-dt))).to(bf),
          "A_log": torch.log(torch.linspace(1, 16, H, device=dev)).to(bf),
          "D": torch.ones((H,), device=dev, dtype=bf)}
    conv = randn(B, c.mamba_d_conv - 1, C)
    st = randn(B, H, c.mamba_d_head, c.mamba_d_state, scale=0.5)
    y_err = s_err = ctrl = 0.0
    conv_equal = True
    for _ in range(3):
        z = randn(B, c.in_proj_dim)
        conv_k, st_k, conv0 = conv.clone(), st.clone(), conv.clone()
        want = ssm.ssm_step_reference(z, conv, st, lp, c)
        got = ssm.ssm_step(z, conv_k, st_k, lp, c)
        lost = ssm.ssm_step_reference(z, conv0, torch.zeros_like(st), lp, c)
        torch.cuda.synchronize()
        top = want.abs().max().item()
        y_err = max(y_err, (got - want).abs().max().item() / top)
        s_err = max(s_err, (st_k.float() - st.float()).abs().max().item()
                    / st.float().abs().max().item())
        ctrl = max(ctrl, (lost - want).abs().max().item() / top)
        conv_equal &= torch.equal(conv_k, conv)
    check(conv_equal, f"ssm_step B={B}: the conv state differs from the plain version's")
    check(y_err <= 1e-4, f"ssm_step B={B}: output error {y_err:.3g} over 1e-4")
    check(s_err <= 2 ** -7, f"ssm_step B={B}: state error {s_err:.3g} over one bf16 step")
    check(ctrl > 1e-2, f"ssm_step B={B}: the zeroed-state control {ctrl:.3g} passes the gate")
    z = randn(B, c.in_proj_dim)
    ms = cuda_ms(lambda: ssm.ssm_step(z, conv, st, lp, c), iters=50)
    plain = cuda_ms(lambda: ssm.ssm_step_reference(z, conv, st, lp, c), iters=10)
    bound, by = ssm_bound(c, B)
    log(f"ssm_step B={B}: output err {y_err:.3g} (control {ctrl:.3g}), state err {s_err:.3g}, "
        f"conv state bitwise {conv_equal}; {ms * 1e3:.1f} us (bound {bound * 1e3:.1f} us by "
        f"{by}, plain {plain * 1e3:.1f} us)")
    return dict(err=y_err, state_err=s_err, control_err=ctrl, ms=ms, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=None,
                shape=f"B={B}, 64 heads x 64 x 128 state, one group, bf16")


def hybrid_prompts(cfg, B: int, S: int, seed: int):
    """``[B, S, 33]`` prompts with no padding (a hybrid prompt's pads go
    after its frames)."""
    import numpy as np

    rows = [prompt(cfg, 1, S, seed + b) for b in range(B)]
    return np.concatenate([r[0] for r in rows]), np.concatenate([r[1] for r in rows])


def hybrid_end_to_end() -> dict:
    """A random bf16 Granite-backbone CSM (seed 0) with the cell's K2 bundle
    (int8 decoder, bf16 head): greedy ``generate`` of 16 frames at B = 1 and
    8 from 64-frame prompts, then a greedy ``CSMServer`` (8 slots, window
    256, 12 requests of 20-120 frames for 8-24 frames, its steps replayed as
    a CUDA graph after the first few), each with ``ssm_step.launches`` set
    to 0 just before it: one launch a mixer a backbone step.  Then three
    graphed server steps under ``torch.profiler``: its device trace holds
    the replayed kernel under its name, 36 a step."""
    import numpy as np
    import torch

    from csm_tpu_torch.models import csm, hybrid
    from csm_tpu_torch.ops.fused_decoder import prepare_fused_decoder
    from csm_tpu_torch.ops.ssm import ssm_step
    from csm_tpu_torch.generation import generate
    from csm_tpu_torch.serving import CSMServer

    cfg = granite_config()
    mixers = len(cfg.backbone.mamba_layers)
    t0 = time.perf_counter()
    params = csm.init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    qdec = prepare_fused_decoder(params, cfg, head_bits=16)
    log(f"random Granite-backbone CSM bf16 + K2 bundle in {time.perf_counter() - t0:.1f} s")
    real_step, steps = hybrid.step, [0]

    def counted(*a, **k):
        steps[0] += 1
        return real_step(*a, **k)

    hybrid.step = counted
    out = {}
    try:
        for B in (1, 8):
            ids, mask = hybrid_prompts(cfg, B, 64, seed=170 + B)
            generate(params, cfg, ids, mask, max_new_frames=2, greedy=True,
                     stop_on_all_zeros=False, qdec=qdec)
            torch.cuda.synchronize()
            steps[0] = ssm_step.launches = 0
            t0 = time.perf_counter()
            frames = generate(params, cfg, ids, mask, max_new_frames=16, greedy=True,
                              stop_on_all_zeros=False, qdec=qdec)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            check(frames.shape == (B, 16, 32), f"hybrid generate B={B}: frames {frames.shape}")
            check(steps[0] == 15 and ssm_step.launches == mixers * steps[0],
                  f"hybrid generate B={B}: {ssm_step.launches} mixer launches over {steps[0]} "
                  f"steps, want {mixers} a step over 15")
            out[f"generate_B{B}"] = dict(launches=ssm_step.launches, steps=steps[0],
                                         frames_per_s=B * 16 / dt)
            log(f"hybrid generate B={B}: 16 frames in {dt:.2f} s, {ssm_step.launches} mixer "
                f"launches over {steps[0]} steps")
        rng = np.random.default_rng(17)
        server = CSMServer(params, cfg, n_slots=8, window=256, greedy=True, qdec=qdec)
        steps[0] = ssm_step.launches = 0
        t0 = time.perf_counter()
        for i in range(12):
            ids, mask = hybrid_prompts(cfg, 1, int(rng.integers(20, 121)), seed=180 + i)
            server.submit(ids, mask, max_new_frames=int(rng.integers(8, 25)))
        server.run_until_idle()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        st = server.stats()
        check(st["completed"] == 12, f"hybrid server: {st['completed']} of 12 requests done")
        check(steps[0] > 0 and ssm_step.launches == mixers * steps[0],
              f"hybrid server: {ssm_step.launches} mixer launches over {steps[0]} steps")
        check(len(hybrid._CAPTURED) == 1, "hybrid server: its step was never captured")
        out["serve"] = dict(launches=ssm_step.launches, steps=steps[0],
                            frames=st["frames_emitted"], seconds=dt)
        log(f"hybrid server: 12 requests, {st['frames_emitted']} frames in {dt:.2f} s, "
            f"{ssm_step.launches} mixer launches over {steps[0]} steps (graphed)")
        from torch.profiler import ProfilerActivity, profile

        ids, mask = hybrid_prompts(cfg, 1, 40, seed=199)
        for i in range(8):
            server.submit(ids, mask, max_new_frames=40)
        for _ in range(4):
            server.step()
        torch.cuda.synchronize()
        launches0 = ssm_step.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                server.step()
            torch.cuda.synchronize()
        traced = sum(e.count for e in prof.key_averages() if "ssm_step_kernel" in e.key)
        check(traced == 3 * mixers == ssm_step.launches - launches0,
              f"hybrid server traced: {traced} ssm_step_kernel records over 3 graphed steps "
              f"({ssm_step.launches - launches0} counted), want {3 * mixers}")
        out["traced_replays"] = traced
        log(f"hybrid server traced: {traced} ssm_step_kernel records in 3 graphed steps")
        server.run_until_idle()
        out["serve"]["launches_all"] = ssm_step.launches
    finally:
        hybrid.step = real_step
    return out


def hybrid_backbone(gen) -> dict:
    """Phase 17: the mixer step kernel at B = 1, 8 and 32, then the hybrid
    backbone end to end; the kernel's row of the ``kernels`` line."""
    t0 = time.perf_counter()
    c = granite_config().backbone
    ssm = {B: check_ssm(c, B, gen) for B in SSM_BATCHES}
    e2e = hybrid_end_to_end()
    log(f"phase 17 (the hybrid backbone) in {time.perf_counter() - t0:.1f} s")
    launches = dict(generate=sum(e2e[f"generate_B{B}"]["launches"] for B in (1, 8)),
                    serve=e2e["serve"]["launches_all"])
    return dict(readings=ssm, e2e=e2e, row=dict(
        name="ssm_step", route="cuda", source="csm_tpu_torch/csrc/ssm_step.cu",
        replaces="none (the JAX package runs a Llama backbone only)", r=ssm[32],
        launches=sum(launches.values()), launches_by_path=launches,
        by_batch={B: dict(ms=r["ms"], bound_ms=r["bound_ms"], err=r["err"],
                          state_err=r["state_err"]) for B, r in ssm.items()}))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from csm_tpu_torch import CSMConfig, CSMModel
    from csm_tpu_torch.ops import _build

    # The plain versions are the yardsticks of the kernels' rounding: fp32
    # matmuls in full fp32, bf16 matmuls reduced in fp32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build(KERNELS)
    log(f"built {', '.join(KERNELS)} in {time.perf_counter() - t0:.1f} s")
    os.makedirs(OUT_DIR, exist_ok=True)
    for name in KERNELS:
        report = _build.ptxas_report(name)
        with open(os.path.join(OUT_DIR, f"ptxas_{name}.log"), "w") as f:
            f.write(report)
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    hgmma = tensor_core_check()

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flash = {B: check_flash(B, gen) for B in (1, 8)}
    flash_f32 = check_flash(8, gen, "float32")

    cfg = CSMConfig()
    t0 = time.perf_counter()
    model = CSMModel(cfg, dtype=torch.bfloat16, seed=0)
    model.exact()
    log(f"random CSM-1B bf16 model + exact bundle in {time.perf_counter() - t0:.1f} s")
    bb = {B: check_bb(model._qsb, cfg, B, gen) for B in (1, 8)}
    model._qsb = model._qdec = None
    torch.cuda.empty_cache()

    from csm_tpu_torch.ops.bb_kernel import prepare_streamed_backbone
    from csm_tpu_torch.ops.fused_decoder import prepare_fused_decoder

    jittered = perturbed_norms(model.params, gen)
    qsb8 = prepare_streamed_backbone(jittered, cfg, bits=8)
    bbq = {B: check_bbq(qsb8, cfg, B, gen) for B in (1, 8, 32)}
    del qsb8
    t0 = time.perf_counter()
    qsb4 = prepare_streamed_backbone(jittered, cfg, bits=4)
    bbq4 = {B: check_bbq(qsb4, cfg, B, gen) for B in (1, 8, 32)}
    del qsb4
    log(f"phase 10 (K1q-4) in {time.perf_counter() - t0:.1f} s")
    qdecs = {hb: prepare_fused_decoder(jittered, cfg, head_bits=hb) for hb in (16, 8)}
    fused = {B: check_fused(qdecs, jittered, cfg, B, gen) for B in (1, 8, 32)}
    del qdecs, jittered
    torch.cuda.empty_cache()

    results = {"e2e": {}}
    counters, loaded = end_to_end(model, results)
    del model
    t0 = time.perf_counter()
    from csm_tpu_torch.codec import MimiCodec, MimiCodecConfig, random_mimi_params

    codec = MimiCodec(MimiCodecConfig(), random_mimi_params(MimiCodecConfig(), seed=0))
    results["serving_int4"] = serving_full_width(loaded, cfg, codec, bits=4)
    results["serving_int8"] = serving_full_width(loaded, cfg, codec, bits=8)
    results["tf32_pcm"] = tf32_pcm_reading(codec, cfg)
    log(f"phase 12 (serving) in {time.perf_counter() - t0:.1f} s")
    del codec
    torch.cuda.empty_cache()
    hyb = hybrid_backbone(gen)
    results["hybrid"] = {"e2e": hyb["e2e"], **{f"ssm_step_B{B}": r
                                               for B, r in hyb["readings"].items()}}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results["last_modules"] = lm = last_modules(loaded, cfg, results["e2e"])
    log(f"phase 16 (the last modules) in {time.perf_counter() - t0:.1f} s")
    del loaded
    golden_on_card()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    flash_bwd = {(B, S, dt): check_flash_bwd(B, S, gen, dt)
                 for B, S in FLASH_BWD_SHAPES for dt in ("bfloat16", "float32")}
    torch.cuda.empty_cache()
    log(f"phase 7 (flash backward) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train = train_full_width(cfg)
    results["trainer"] = trainer_full_width(cfg, train.pop("params"))
    results["train"] = train["record"]
    log(f"phase 8 (training at full width) in {time.perf_counter() - t0:.1f} s")
    results["finetune_cli"] = ft = finetune_cli()
    t0 = time.perf_counter()
    results["sharpened"] = sharpened_agreement(cfg)
    log(f"phase 9 (sharpened weights) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    q_off = {dt: check_q_offset(gen, dt) for dt in ("bfloat16", "float32")}
    torch.cuda.empty_cache()
    results["q_offset"] = q_off
    results["sharded_training"] = sharded_training()
    log(f"phase 13 (sequence parallelism) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sp_refs = {(r["config"]["layers"], r["config"]["S"], r["config"]["B"]): r["one_process"]
               for r in results["sharded_training"].values()}
    results["tensor_parallel"] = tp = tensor_parallelism(gen, sp_refs)
    log(f"phase 15 (tensor parallelism) in {time.perf_counter() - t0:.1f} s")

    fb = flash_bwd[(1, TRAIN_S, "bfloat16")]
    tl = train["launches"]
    fl = ft["launches"]
    s4, sv = results["serving_int4"]["launches"], results["serving_int8"]["launches"]
    sp = {k: sum(r["launches"][k] for r in results["sharded_training"].values())
          for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    tpl = {k: sum(r["launches"][k] for r in tp["train"].values())
           for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    tpg = tp["generate"]["launches"]["flash_fwd"]

    def last(path: str, k: str) -> int:
        """Phase 16's launches of kernel ``k`` on one of its paths."""
        parts = {"entry": ("entry",), "tooling": ("measure", "profiling"),
                 "warmup": ("warmup",), "examples": ("examples",)}[path]
        return sum(lm[p]["launches"].get(k, 0) for p in parts)

    def last_paths(k: str, paths=("entry", "tooling", "warmup", "examples")) -> dict:
        return {p: last(p, k) for p in paths}

    def head_shard(r: dict) -> dict:
        """A kernel's reading at the model=2 head shard (phase 15c)."""
        keys = ("err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "shape")
        return {k: r[k] for k in keys if k in r}

    def shard_readings(part: str) -> dict:
        """The bf16 q_offset readings of one kernel, per shard count."""
        return {f"{n}_shards": [
            dict(q_offset=x["q_offset"], ms=x["ms"][part], bound_ms=x["bound_ms"][part],
                 bound_by=x["bound_by"][part],
                 plain_ms=x["plain_ms"]["fwd" if part == "fwd" else "bwd"],
                 library_ms=x["library_ms"]["fwd" if part == "fwd" else "bwd"])
            for x in rec["shards"]] for n, rec in q_off["bfloat16"].items()}

    rows = [
        dict(name="flash_fwd", route="cuda", source="csm_tpu_torch/csrc/flash_fwd.cu",
             replaces="csm_tpu/ops/flash_attention.py:104", r=flash[8],
             launches=(counters["flash_fwd"] + tl["flash_fwd"] + s4["flash_fwd"] + sp["flash_fwd"]
                       + fl["flash_fwd"] + tpl["flash_fwd"] + tpg
                       + sum(last_paths("flash_fwd").values())),
             launches_by_path=dict(generate=counters["flash_fwd"], train=tl["flash_fwd"],
                                   serve=s4["flash_fwd"], train_sharded=sp["flash_fwd"],
                                   finetune_cli=fl["flash_fwd"], train_tp=tpl["flash_fwd"],
                                   generate_tp=tpg, **last_paths("flash_fwd")),
             with_lse=dict(fb["fwd"], shape=fb["shape"]), q_offset=shard_readings("fwd"),
             head_shard=head_shard(tp["flash"]),
             head_shard_with_lse=dict(head_shard(tp["flash_bwd"]["fwd"]),
                                      shape=tp["flash_bwd"]["shape"]),
             hgmma=hgmma["flash_fwd_wgmma_kernel"]),
        dict(name="flash_bwd_dq", route="cuda", source="csm_tpu_torch/csrc/flash_bwd.cu",
             replaces="csm_tpu/ops/flash_attention.py:303", r=dict(fb["dq"], shape=fb["shape"]),
             launches=(tl["flash_bwd_dq"] + sp["flash_bwd_dq"] + fl["flash_bwd_dq"]
                       + tpl["flash_bwd_dq"]),
             launches_by_path=dict(train=tl["flash_bwd_dq"], train_sharded=sp["flash_bwd_dq"],
                                   finetune_cli=fl["flash_bwd_dq"], train_tp=tpl["flash_bwd_dq"]),
             q_offset=shard_readings("dq"),
             head_shard=dict(head_shard(tp["flash_bwd"]["dq"]), shape=tp["flash_bwd"]["shape"]),
             hgmma=hgmma["flash_bwd_dq_wgmma_kernel"]),
        dict(name="flash_bwd_dkv", route="cuda", source="csm_tpu_torch/csrc/flash_bwd.cu",
             replaces="csm_tpu/ops/flash_attention.py:367", r=dict(fb["dkv"], shape=fb["shape"]),
             launches=(tl["flash_bwd_dkv"] + sp["flash_bwd_dkv"] + fl["flash_bwd_dkv"]
                       + tpl["flash_bwd_dkv"]),
             launches_by_path=dict(train=tl["flash_bwd_dkv"], train_sharded=sp["flash_bwd_dkv"],
                                   finetune_cli=fl["flash_bwd_dkv"],
                                   train_tp=tpl["flash_bwd_dkv"]),
             q_offset=shard_readings("dkv"),
             head_shard=dict(head_shard(tp["flash_bwd"]["dkv"]), shape=tp["flash_bwd"]["shape"]),
             hgmma=hgmma["flash_bwd_dkv_wgmma_kernel"]),
        dict(name="bb_decode", route="cuda", source="csm_tpu_torch/csrc/bb_decode.cu",
             replaces="csm_tpu/ops/bb_kernel.py:573", r=bb[1],
             kernels_per_step={B: r["kernels_per_step"] for B, r in bb.items()},
             hmma=hgmma["bb_step_kernel"]),
        dict(name="bb_decode_q", route="cuda", source="csm_tpu_torch/csrc/bb_decode_q.cu",
             replaces="csm_tpu/ops/bb_kernel.py:573", r=bbq[1],
             launches=counters["bb_decode_q"] + sv["bb_decode_q"] + last("examples", "bb_decode_q"),
             launches_by_path=dict(generate=counters["bb_decode_q"],
                                   serve_int8=sv["bb_decode_q"],
                                   examples=last("examples", "bb_decode_q")),
             kernels_per_step={B: r["kernels_per_step"] for B, r in bbq.items()},
             hmma=hgmma["bbq_step_kernel"]),
        dict(name="bb_decode_q4", route="cuda", source="csm_tpu_torch/csrc/bb_decode_q.cu",
             replaces="csm_tpu/ops/bb_kernel.py:573", r=bbq4[1],
             launches=(counters["bb_decode_q4"] + s4["bb_decode_q4"]
                       + sum(last_paths("bb_decode_q4").values())),
             launches_by_path=dict(generate=counters["bb_decode_q4"], serve=s4["bb_decode_q4"],
                                   **last_paths("bb_decode_q4")),
             kernels_per_step={B: r["kernels_per_step"] for B, r in bbq4.items()},
             hmma=hgmma["bbq_step_kernel"]),
        dict(name="fused_decoder", route="cuda", source="csm_tpu_torch/csrc/fused_decoder.cu",
             replaces="csm_tpu/ops/fused_decoder.py:566", r=fused[1],
             launches=(counters["fused_decoder"] + s4["fused_decoder"]
                       + sum(last_paths("fused_decoder").values())),
             launches_by_path=dict(generate=counters["fused_decoder"],
                                   serve=s4["fused_decoder"], **last_paths("fused_decoder")),
             sync_counts=fused[1]["gates"]["head16_sampled"]["sync_counts"],
             hmma=hgmma["fused_decoder_kernel"]),
        hyb["row"],
    ]
    kernels = []
    for row in rows:
        r = row.pop("r")
        row.setdefault("launches", counters.get(row["name"]))
        kernels.append(dict(
            **row, max_abs_err=r["err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], shape=r["shape"],
        ))
    extra = {
        "flash_fwd_B1": flash[1], "flash_fwd_B8_float32": flash_f32, "bb_decode_B1": bb[1],
        "bb_decode_B8": bb[8], **{f"bb_decode_q_B{B}": r for B, r in bbq.items()},
        **{f"bb_decode_q4_B{B}": r for B, r in bbq4.items()},
        **{f"fused_decoder_B{B}": r for B, r in fused.items()},
        **{f"flash_bwd_B{B}_S{S}_{dt}": r for (B, S, dt), r in flash_bwd.items()},
        **results,
        "card": smi, "seconds": time.perf_counter() - t_start,
    }
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"kernels": kernels, "failures": FAILURES, **extra}, f, indent=1)
    if FAILURES:
        print(f"{len(FAILURES)} check(s) failed", flush=True)
        print(f"{len(FAILURES)} check(s) failed:\n" + "\n".join(FAILURES), file=sys.stderr,
              flush=True)
        return 1
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def main_hybrid() -> int:
    """Phase 17 alone (``--hybrid``): the card's line, the three kernels it
    runs built, the mixer step kernel's checks and the hybrid backbone end
    to end; its record in ``chiprun_out/chip_smoke_hybrid.json``."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from csm_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.perf_counter()
    _build.build(HYBRID_KERNELS)
    log(f"built {', '.join(HYBRID_KERNELS)} in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    hyb = hybrid_backbone(gen)
    row = hyb["row"]
    r = row.pop("r")
    kernels = [dict(**row, max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
                    shape=r["shape"])]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_hybrid.json"), "w") as f:
        json.dump({"kernels": kernels, "failures": FAILURES, "e2e": hyb["e2e"],
                   "readings": {str(B): v for B, v in hyb["readings"].items()}, "card": smi,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    if FAILURES:
        print(f"{len(FAILURES)} check(s) failed:\n" + "\n".join(FAILURES), file=sys.stderr,
              flush=True)
        return 1
    log(json.dumps({"kernels": kernels}))
    log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main_hybrid() if sys.argv[1:] == ["--hybrid"] else main())
