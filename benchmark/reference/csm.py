"""The plain reference of CSM-1B: the backbone (Llama-3.2-1B shapes, RMSNorm,
GQA with llama3-scaled RoPE, SwiGLU), the codebook-0 head, the 4-layer
decoder over ``[projected hidden; projected codebook embeddings]`` with its
31 head slices, and the training losses.  Plain ``torch`` in float32 with
TF32 off, one sequence at a time, no cache and no kernel; it imports nothing
of the program and takes nothing the program made.

What the program's set-up derives from the weights is worked out again
here from the same weights: the norm weights folded into the products, the
int8 per-output-channel and the row-equilibrated int4 bundles
(:func:`int8_dequant`, :func:`int4_dequant`), the bf16-rounded decoder
head.  Each tier's weights are applied where that tier applies them: the
prompt's positions through the param-precision prefill, later positions
through the backbone step's weights (see :func:`serve_weights`).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.shapes import nest

FAMILIES = ("wqkv", "wo", "w_gu", "w_down")


def no_tf32(fn):
    """Run ``fn`` with TF32 off for matmuls and convolutions (float32 means
    float32 on the card), restoring the caller's settings after."""
    @functools.wraps(fn)
    def wrapped(*a, **k):
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*a, **k)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return wrapped


# ---------------------------------------------------------------------------
# RoPE (Llama-3 scaling), norms, attention
# ---------------------------------------------------------------------------


def rope_table(c, n: int, device):
    """``(cos, sin) [n, head_dim]`` of a stack ``c`` (a ``LlamaConfig``)."""
    hd = c.hidden_size // c.num_attention_heads
    inv = 1.0 / (c.rope_theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    sc = c.rope_scaling
    if sc is not None and sc.rope_type == "llama3":
        lo = sc.original_max_position_embeddings / sc.low_freq_factor
        hi = sc.original_max_position_embeddings / sc.high_freq_factor
        wavelen = 2.0 * np.pi / inv
        smooth = (sc.original_max_position_embeddings / wavelen - sc.low_freq_factor) / (
            sc.high_freq_factor - sc.low_freq_factor)
        smoothed = (1.0 - smooth) * inv / sc.factor + smooth * inv
        out = np.where(wavelen > lo, inv / sc.factor, inv)
        inv = np.where((wavelen <= lo) & (wavelen >= hi), smoothed, out)
    freqs = np.outer(np.arange(n, dtype=np.float32), inv.astype(np.float32))
    emb = np.concatenate([freqs, freqs], axis=-1)
    return torch.from_numpy(np.cos(emb)).to(device), torch.from_numpy(np.sin(emb)).to(device)


def rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm without its weight (the weight is folded into the product
    after it)."""
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None, :] + rot * sin[:, None, :]


def _attention(q, k, v):
    """Causal GQA over one sequence: ``q [T, nq, hd]``, ``k, v [T, nkv, hd]``."""
    T, nq, hd = q.shape
    nkv = k.shape[1]
    qg = q.reshape(T, nkv, nq // nkv, hd)
    scores = torch.einsum("tngh,snh->ngts", qg, k) / math.sqrt(hd)
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    return torch.einsum("ngts,snh->tngh", probs, v).reshape(T, nq * hd)


# ---------------------------------------------------------------------------
# Weights: folding and the quantized bundles, worked out again
# ---------------------------------------------------------------------------


def int8_dequant(w: torch.Tensor) -> torch.Tensor:
    """Symmetric per-output-channel int8 of ``[..., K, N]`` (scale =
    column amax / 127, half to even), dequantized."""
    amax = w.abs().amax(dim=-2, keepdim=True)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(w / s), -127, 127) * s


def int4_dequant(w: torch.Tensor) -> torch.Tensor:
    """Row-equilibrated int4 of ``[..., K, N]``: each row divided by its
    largest magnitude ``u``, then a per-column scale onto ``[-7, 7]`` (half
    to even); dequantized as ``u * q * s``."""
    u = w.abs().amax(dim=-1, keepdim=True)
    u = torch.where(u > 0, u, torch.ones_like(u))
    wn = w / u
    amax = wn.abs().amax(dim=-2, keepdim=True)
    s = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    return torch.clamp(torch.round(wn / s), -7, 7) * s * u


def int4_per_channel_dequant(w: torch.Tensor) -> torch.Tensor:
    """Symmetric per-output-channel int4 (the control's step below int8)."""
    amax = w.abs().amax(dim=-2, keepdim=True)
    s = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    return torch.clamp(torch.round(w / s), -7, 7) * s


def bf16_round(w: torch.Tensor) -> torch.Tensor:
    return w.to(torch.bfloat16).float()


def fold_stack(stack: dict, quant: Optional[Callable] = None) -> dict:
    """A stack's four weight families in f32 with the RMSNorm weights folded
    into ``wqkv`` and ``w_gu`` (exact algebra), each passed through
    ``quant`` (a dequantizing function) if given; the final norm apart."""
    lay = stack["layers"]
    an = lay["attn_norm"].float()[:, :, None]
    mn = lay["mlp_norm"].float()[:, :, None]
    fam = {"wqkv": torch.cat([lay[n].float() * an for n in ("wq", "wk", "wv")], dim=-1),
           "wo": lay["wo"].float(),
           "w_gu": torch.cat([lay[n].float() * mn for n in ("w_gate", "w_up")], dim=-1),
           "w_down": lay["w_down"].float()}
    if quant is not None:
        fam = {k: quant(v) for k, v in fam.items()}
    fam["final_norm"] = stack["final_norm"].float()
    return fam


def serve_weights(params: dict, cfg, tier: str) -> dict:
    """The reference's weights for a served tier.  ``"prefill"``: the
    backbone as the param-precision prefill applies it (prompt positions
    and the first frame's c0 head); ``"step"``: as the backbone step applies
    it (later positions); ``"decoder"``: the codebook loop's.  ``tier``:
    ``"int4"`` (``quantize(bits=4)``: int4 layers and an int8 c0 head in the
    step, an int8 decoder with a bf16 head) or ``"exact"`` (every part at
    the param precision)."""
    fnw = params["backbone"]["final_norm"].float()[:, None]
    c0 = params["codebook0_head"].float() * fnw
    prefill = dict(fold_stack(params["backbone"]), head=c0)
    dfn = params["decoder"]["final_norm"].float()[None, :, None]
    dhead = params["audio_head"].float() * dfn
    if tier == "int4":
        step = dict(fold_stack(params["backbone"], int4_dequant), head=int8_dequant(c0))
        dec = dict(fold_stack(params["decoder"], int8_dequant), head=bf16_round(dhead))
    elif tier == "exact":
        step = prefill
        dec = dict(fold_stack(params["decoder"]), head=dhead)
    else:
        raise ValueError(f"unknown tier {tier!r}")
    return {"prefill": prefill, "step": step, "decoder": dec}


def fp8_dequant(w: torch.Tensor) -> torch.Tensor:
    """Float8 e4m3 per output channel (column amax onto 448), dequantized."""
    amax = w.abs().amax(dim=-2, keepdim=True)
    s = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (w / s).to(torch.float8_e4m3fn).float() * s


def lower_precision(w: dict, tier: str, parts=("prefill", "step", "decoder"),
                    fn: Callable = int8_dequant) -> dict:
    """The control's weights: served parts one precision step below what the
    configuration states.  ``exact``: bf16 -> ``fn`` (per-output-channel
    int8, or :func:`fp8_dequant`) on ``parts`` (``("decoder",)`` is the
    exact tier's int8 drafts served without their verify).  ``int4``: the
    prefill bf16 -> int8 and the decoder int8 -> int4; its int4 step stays
    int4."""
    def lower(part, f):
        return {k: (v if k == "final_norm" else f(v)) for k, v in part.items()}

    if tier == "int4":
        return {"prefill": lower(w["prefill"], int8_dequant), "step": w["step"],
                "decoder": lower(w["decoder"], int4_per_channel_dequant)}
    return {k: (lower(v, fn) if k in parts else v) for k, v in w.items()}


def controls(tier: str) -> tuple:
    """What the serving check can put in the program's place: ``lower``,
    the reference one precision step below what the configuration states
    (int8 for the exact tier; Mimi in TF32); for the exact tier also
    ``fp8`` and ``drafts``, its int8 decoder without the verify;
    ``no_topk``, the reference sampling without its top-k filter."""
    return ("lower", "fp8", "drafts", "no_topk") if tier == "exact" else ("lower", "no_topk")


def control_weights(w: dict, tier: str, control: str) -> dict:
    """The weights ``control`` (one of :func:`controls`) serves in place of
    the tier's ``w``."""
    if control == "no_topk":
        return w
    if control == "fp8":
        return lower_precision(w, tier, fn=fp8_dequant)
    if control == "drafts":
        return lower_precision(w, tier, parts=("decoder",))
    return lower_precision(w, tier)


# ---------------------------------------------------------------------------
# The stacks
# ---------------------------------------------------------------------------


def stack_forward(c, segments: List[tuple], h: torch.Tensor, cos, sin, remat: bool = False):
    """A Llama stack over one sequence ``h [T, D]`` (f32), position ``t``
    through the folded weights of the segment ``(start, stop, weights)``
    that holds it.  Returns the last layer's residual stream (not normed)."""
    nq, nkv = c.num_attention_heads, c.num_key_value_heads
    hd = c.hidden_size // nq
    Fi, eps = c.intermediate_size, c.rms_norm_eps

    def mm(x, name, l):
        return torch.cat([x[a:b] @ w[name][l] for a, b, w in segments], dim=0)

    def layer(h, l):
        T = h.shape[0]
        qkv = mm(rms(h, eps), "wqkv", l)
        q = _rope(qkv[:, :nq * hd].reshape(T, nq, hd), cos, sin)
        k = _rope(qkv[:, nq * hd:(nq + nkv) * hd].reshape(T, nkv, hd), cos, sin)
        v = qkv[:, (nq + nkv) * hd:].reshape(T, nkv, hd)
        h = h + mm(_attention(q, k, v), "wo", l)
        gu = mm(rms(h, eps), "w_gu", l)
        return h + mm(F.silu(gu[:, :Fi]) * gu[:, Fi:], "w_down", l)

    for l in range(c.num_hidden_layers):
        h = checkpoint(layer, h, l, use_reentrant=False) if remat else layer(h, l)
    return h


def embed_frames(params: dict, cfg, ids: torch.Tensor, mask: torch.Tensor,
                 cast: Callable = lambda t: t.float()) -> torch.Tensor:
    """``[T, 33]`` ids and mask -> the 33-way masked embedding sum ``[T, D]``
    (rows gathered, then cast)."""
    N, Va = cfg.audio_num_codebooks, cfg.audio_vocab_size
    offs = torch.arange(N, device=ids.device) * Va
    audio = cast(params["audio_embeddings"][ids[:, :N].long() + offs])  # [T, N, D]
    text = cast(params["text_embeddings"][ids[:, N].long()])
    m = mask.float()
    return torch.einsum("tnd,tn->td", audio, m[:, :N]) + text * m[:, N:]


def decoder_inputs(params: dict, cfg, prev_h: torch.Tensor, codes: torch.Tensor, n: int,
                   cast: Callable = lambda t: t.float()) -> torch.Tensor:
    """``[F, 1 + n, Dd]``: the projected hidden, then the projected
    embeddings of codebooks ``0..n-1`` of each frame (``codes [F, >= n]``)."""
    Va = cfg.audio_vocab_size
    proj = cast(params["projection"])
    offs = torch.arange(n, device=codes.device) * Va
    emb = cast(params["audio_embeddings"][codes[:, :n].long() + offs])  # [F, n, D]
    return torch.cat([(prev_h @ proj)[:, None], emb @ proj], dim=1)


def decoder_forward(cfg, dec: dict, x: torch.Tensor) -> torch.Tensor:
    """The decoder over ``x [F, P, Dd]`` (every frame its own causal
    sequence at positions ``0..P-1``); the final residual ``rms``-normed
    (the final norm weight sits folded in the head)."""
    c = cfg.decoder
    cos, sin = rope_table(c, x.shape[1], x.device)
    out = [stack_forward(c, [(0, x.shape[1], dec)], xf, cos, sin) for xf in x]
    return rms(torch.stack(out), c.rms_norm_eps)


# ---------------------------------------------------------------------------
# Serving: logits of each served token, teacher-forced
# ---------------------------------------------------------------------------


@no_tf32
@torch.no_grad()
def served_logits(params: dict, cfg, w: dict, prompt_ids: torch.Tensor,
                  prompt_mask: torch.Tensor, frames: torch.Tensor):
    """For one request (``prompt [S, 33]``, served ``frames [F, 32]``) the
    reference logits of every served token, ``(c0 [F, Va], rest [F, 31,
    Va])``: the backbone over the prompt and the first ``F - 1`` served
    frames (positions ``0..S-1`` through ``w["prefill"]``, later ones through
    ``w["step"]``), c0 from the hidden before each frame, and the decoder
    teacher-forced on the served codebooks."""
    S, N, F_ = prompt_ids.shape[0], cfg.audio_num_codebooks, frames.shape[0]
    dev = prompt_ids.device
    ids = torch.zeros((S + F_ - 1, cfg.audio_num_codebooks + 1), dtype=torch.long, device=dev)
    mask = torch.zeros(ids.shape, dtype=torch.float32, device=dev)
    ids[:S], mask[:S] = prompt_ids, prompt_mask
    ids[S:, :N] = frames[:F_ - 1]
    mask[S:, :N] = 1.0
    T = ids.shape[0]
    bc = cfg.backbone
    cos, sin = rope_table(bc, T, dev)
    h = stack_forward(bc, [(0, S, w["prefill"]), (S, T, w["step"])],
                      embed_frames(params, cfg, ids, mask), cos, sin)
    hn = rms(h[S - 1:], bc.rms_norm_eps)  # [F, D]: the hidden before each frame
    c0 = torch.cat([hn[:1] @ w["prefill"]["head"], hn[1:] @ w["step"]["head"]], dim=0)
    last_h = hn * torch.cat([w["prefill"]["final_norm"][None].expand(1, -1),
                             w["step"]["final_norm"][None].expand(F_ - 1, -1)], dim=0)
    x = decoder_inputs(params, cfg, last_h, frames, N - 1)  # [F, 32, Dd]
    dh = decoder_forward(cfg, w["decoder"], x)  # [F, 32, Dd]
    rest = torch.einsum("fcd,cdv->fcv", dh[:, 1:N], w["decoder"]["head"])
    return c0, rest


# ---------------------------------------------------------------------------
# Training: the loss and AdamW
# ---------------------------------------------------------------------------


def _ce_sum(logits, targets):
    valid = targets != -100
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, torch.where(valid, targets, 0)[:, None].long())[:, 0]
    return torch.where(valid, nll, torch.zeros_like(nll)).sum(), valid.sum()


def train_loss(params: dict, cfg, ids, mask, labels, max_decoder_frames: int,
               cast: Callable) -> tuple:
    """``(loss, backbone loss, decoder loss)`` of one ``[S, 33]`` sequence:
    the backbone's shifted CE on codebook 0 and the decoder's CE on codebooks
    1..31 of the first ``max_decoder_frames`` frames with all 32 labels,
    each conditioned on the hidden before it (frame 0 wraps to ``S - 1``).
    ``cast`` turns a master weight into the weight the forward computes with
    (the compute precision, applied to gathered rows and whole matrices)."""
    S, N, Va = ids.shape[0], cfg.audio_num_codebooks, cfg.audio_vocab_size
    bc = cfg.backbone

    def stack(p):
        lay = {k: cast(v) for k, v in p["layers"].items()}
        an, mn = lay["attn_norm"][:, :, None], lay["mlp_norm"][:, :, None]
        return {"wqkv": torch.cat([lay[n] * an for n in ("wq", "wk", "wv")], dim=-1),
                "wo": lay["wo"],
                "w_gu": torch.cat([lay[n] * mn for n in ("w_gate", "w_up")], dim=-1),
                "w_down": lay["w_down"], "final_norm": cast(p["final_norm"])}

    bb = stack(params["backbone"])
    cos, sin = rope_table(bc, S, ids.device)
    h = stack_forward(bc, [(0, S, bb)], embed_frames(params, cfg, ids, mask, cast), cos, sin,
                      remat=True)
    hidden = rms(h, bc.rms_norm_eps) * bb["final_norm"]
    c0 = hidden @ cast(params["codebook0_head"])
    tgt = F.pad(labels[1:, 0], (0, 1), value=-100)
    bb_sum, bb_n = _ce_sum(c0, tgt)

    valid = (labels[:, :N] != -100).all(dim=-1)
    t_idx = torch.nonzero(valid)[:max_decoder_frames, 0]
    prev_h = hidden[(t_idx - 1) % S]
    x = decoder_inputs(params, cfg, prev_h, ids[t_idx], N, cast)  # [F, 33, Dd]
    dec = stack(params["decoder"])
    dh = decoder_forward(cfg, dec, x) * dec["final_norm"]
    logits = torch.einsum("fcd,cdv->fcv", dh[:, 1:N], cast(params["audio_head"]))
    dec_sum, dec_n = _ce_sum(logits.reshape(-1, Va), labels[t_idx, 1:N].reshape(-1))
    bb_loss = bb_sum / bb_n.clamp(min=1)
    dec_loss = dec_sum / dec_n.clamp(min=1)
    return bb_loss + dec_loss, bb_loss, dec_loss


def adamw_lr(step: int, lr: float, total: int, warmup: int = 0) -> float:
    """The linear schedule: warmup from 0, then decay to 0 at ``total``."""
    def linear(a, b, n, c):
        return (a - b) * (1.0 - min(max(c, 0), n) / n) + b

    if warmup > 0:
        if step < warmup:
            return linear(0.0, lr, warmup, step)
        return linear(lr, 0.0, max(total - warmup, 1), step - warmup)
    return linear(lr, 0.0, max(total, 1), step)


@no_tf32
def train_steps(params: Dict[str, torch.Tensor], cfg, batches: List[dict], opt: dict,
                max_decoder_frames: int, cast: Callable) -> dict:
    """Train the flat ``{path: f32 master}`` tree in place for ``len(batches)``
    steps (each ``[accum, 1, S, 33]`` arrays: microbatch gradients summed,
    scaled by 1/accum, clipped to ``opt["max_grad_norm"]`` by their global
    norm, one AdamW update).  Returns per step the loss and the global norm
    before clipping, the first step's clipped gradient per leaf, and per leaf
    the parameters' change after the last step."""
    start = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    out = {"loss": [], "grad_norm": [], "grad": {}}
    tree = nest(params)
    for step, batch in enumerate(batches):
        accum = batch["input_ids"].shape[0]
        for p in params.values():
            p.grad = None
        total = 0.0
        for a in range(accum):
            loss, _, _ = train_loss(tree, cfg, batch["input_ids"][a, 0],
                                    batch["attention_mask"][a, 0], batch["labels"][a, 0],
                                    max_decoder_frames, cast)
            loss.backward()
            total += float(loss.detach())
        with torch.no_grad():
            grads = {k: p.grad.div_(accum) for k, p in params.items()}
            norm = torch.stack([g.square().sum() for g in grads.values()]).sum().sqrt()
            if norm >= opt["max_grad_norm"]:
                for g in grads.values():
                    g.div_(norm).mul_(opt["max_grad_norm"])
            lr = adamw_lr(step, opt["lr"], opt["total_steps"], opt.get("warmup_steps", 0))
            t = step + 1
            for k, p in params.items():
                g = grads[k]
                p.mul_(1.0 - lr * opt.get("weight_decay", 0.0))
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
            if step == 0:
                out["grad"] = {k: float(g.norm()) for k, g in grads.items()}
        out["loss"].append(total / accum)
        out["grad_norm"].append(float(norm))
        for p in params.values():
            p.grad = None
    with torch.no_grad():
        out["change"] = {k: float((p - start[k]).norm()) for k, p in params.items()}
    return out
