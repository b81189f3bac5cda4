"""The plain reference of CSM on a Granite-4.0-H-Micro backbone (HF
``GraniteMoeHybrid`` without experts): 36 Mamba-2 mixers and 4 GQA attention
layers with no position embedding (layers 5, 15, 25, 35), each followed by
a SwiGLU MLP, with the μP multipliers; then CSM-1B's codebook-0 head and
4-layer decoder.  Plain ``torch`` in float32 with TF32 off, one sequence at
a time, no cache and no kernel; it imports nothing of the program and takes
nothing the program made.

As published (``modeling_granitemoehybrid.py``, Mamba-2):

- ``h = embedding_multiplier * e``, ``e`` CSM's summed frame embedding (the
  multiplier's placement is CSM's choice, stated in the configuration);
- per layer ``h += residual_multiplier * mixer(rms(h))``, then ``h +=
  residual_multiplier * mlp(rms(h))``;
- the mixer: ``in_proj`` to ``z``, ``xBC``, ``dt``; ``xBC`` through the causal
  depthwise conv (width ``d_conv``, with bias) and SiLU, split into ``x``,
  ``B``, ``C``; ``Δ = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the
  recurrence run position by position (not in its chunked form), ``S_t =
  exp(Δ_t A) S_{t-1} + Δ_t x_t ⊗ B_t``, ``y_t = S_t C_t + D x_t``, from a zero
  state; ``out_proj(rms_w(y ⊙ silu(z)))`` over all channels;
- attention: scores ``q·k * attention_multiplier``, causal, over the whole
  sequence;
- a final RMSNorm; the c0 logits ``c0_head(h) / logits_scaling`` (the scaling
  applied to CSM's head, CSM's choice).

Departures: none in the mathematics.  What the program's set-up derives from
the weights is worked out again from the same weights: the codebook loop's
int8 decoder with its bf16 head (``reference/csm.py``'s functions, the same
bundle as ``csm-1b-int4`` serves).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.csm import (  # noqa: F401  (bf16_round: the family's)
    bf16_round,
    decoder_forward,
    decoder_inputs,
    embed_frames,
    fold_stack,
    int4_per_channel_dequant,
    int8_dequant,
    no_tf32,
    rms,
)

MATRICES = ("in_proj", "out_proj", "w_gate", "w_up", "w_down", "wq", "wk", "wv", "wo")


def serve_weights(params: dict, cfg, tier: str) -> dict:
    """The reference's served model: ``"backbone"``, the function that turns
    a backbone weight into the one it applies (the bf16 weights upcast, or a
    control's lower precision), ``"state"``, the dtype the recurrent state is
    held in between positions (None: float32), and ``"decoder"``, the codebook
    loop's int8 decoder with its bf16 head.  ``tier``: ``"bf16"``."""
    if tier != "bf16":
        raise ValueError(f"unknown tier {tier!r}")
    dfn = params["decoder"]["final_norm"].float()[None, :, None]
    dhead = params["audio_head"].float() * dfn
    return {"backbone": lambda name, w: w.float(), "state": None,
            "decoder": dict(fold_stack(params["decoder"], int8_dequant), head=bf16_round(dhead))}


def controls(tier: str) -> tuple:
    """What the serving check can put in the program's place: ``lower``, the
    served weights one precision step below what the configuration states
    (the backbone's matrices int8 per output channel, the decoder int4);
    ``state_bf16`` and ``state_fp8``, the recurrent state held between
    positions in bfloat16 or in float8 (e4m3, no scale); ``no_topk``, the
    reference sampling without its top-k filter."""
    return ("lower", "state_bf16", "state_fp8", "no_topk")


def control_weights(w: dict, tier: str, control: str) -> dict:
    """The served model ``control`` (one of :func:`controls`) puts in the
    place of the tier's ``w``."""
    if control == "no_topk":
        return w
    if control in ("state_bf16", "state_fp8"):
        return dict(w, state=torch.bfloat16 if control == "state_bf16" else torch.float8_e4m3fn)
    dec = {k: (v if k == "final_norm" else int4_per_channel_dequant(v))
           for k, v in w["decoder"].items()}
    return dict(w, backbone=lambda name, t: int8_dequant(t.float()) if name in MATRICES
                else t.float(), decoder=dec)


def _mamba(lp: dict, c, x: torch.Tensor, state_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """One Mamba-2 mixer over ``x [T, D]`` (normed), position by position."""
    T = x.shape[0]
    H, P, N, G = c.mamba_n_heads, c.mamba_d_head, c.mamba_d_state, c.mamba_n_groups
    inner = c.mamba_expand * c.hidden_size
    C = inner + 2 * G * N
    K = c.mamba_d_conv
    zxbcdt = x @ lp["in_proj"]
    z, xbc, dt = zxbcdt[:, :inner], zxbcdt[:, inner:inner + C], zxbcdt[:, inner + C:]
    conv = F.conv1d(xbc.T[None], lp["conv_w"][:, None, :], lp["conv_b"], padding=K - 1,
                    groups=C)[0, :, :T].T
    xbc = F.silu(conv)
    xs = xbc[:, :inner].reshape(T, H, P)
    Bm = xbc[:, inner:inner + G * N].reshape(T, G, N).repeat_interleave(H // G, dim=1)
    Cm = xbc[:, inner + G * N:].reshape(T, G, N).repeat_interleave(H // G, dim=1)
    delta = F.softplus(dt + lp["dt_bias"])  # [T, H]
    decay = torch.exp(delta * -torch.exp(lp["A_log"]))  # [T, H]
    dx = delta[:, :, None] * xs  # [T, H, P]
    S = torch.zeros((H, P, N), device=x.device)
    ys = torch.empty((T, H, P), device=x.device)
    for t in range(T):
        S = decay[t][:, None, None] * S + dx[t][:, :, None] * Bm[t][:, None, :]
        ys[t] = torch.einsum("hpn,hn->hp", S, Cm[t])
        if state_dtype is not None:
            S = S.to(state_dtype).float()
    y = (ys + lp["D"][:, None] * xs).reshape(T, inner) * F.silu(z)
    return (rms(y, c.rms_norm_eps) * lp["gate_norm"]) @ lp["out_proj"]


def _attention(lp: dict, c, x: torch.Tensor) -> torch.Tensor:
    T = x.shape[0]
    nq, nkv = c.num_attention_heads, c.num_key_value_heads
    hd = c.hidden_size // nq
    q = (x @ lp["wq"]).reshape(T, nkv, nq // nkv, hd)
    k = (x @ lp["wk"]).reshape(T, nkv, hd)
    v = (x @ lp["wv"]).reshape(T, nkv, hd)
    scores = torch.einsum("tngh,snh->ngts", q, k) * c.attention_multiplier
    causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, -math.inf), dim=-1)
    return torch.einsum("ngts,snh->tngh", probs, v).reshape(T, nq * hd) @ lp["wo"]


def backbone(params: dict, c, h: torch.Tensor, weight: Callable,
             state_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The hybrid stack over one sequence ``h [T, D]`` (the embedded frames,
    before ``embedding_multiplier``); returns the last layer's residual stream
    (not normed).  Each layer's weights pass ``weight(name, tensor)``."""
    bb = params["backbone"]
    h = h * c.embedding_multiplier
    im = ia = 0
    for kind in c.layer_types:
        group, i = ("mamba", im) if kind == "mamba" else ("attn", ia)
        lp = {n: weight(n, w[i]) for n, w in bb[group].items()}
        if kind == "mamba":
            out = _mamba(lp, c, rms(h, c.rms_norm_eps) * lp["norm"], state_dtype)
            im += 1
        else:
            out = _attention(lp, c, rms(h, c.rms_norm_eps) * lp["attn_norm"])
            ia += 1
        h = h + c.residual_multiplier * out
        x = rms(h, c.rms_norm_eps) * lp["mlp_norm"]
        h = h + c.residual_multiplier * ((F.silu(x @ lp["w_gate"]) * (x @ lp["w_up"]))
                                         @ lp["w_down"])
    return h


@no_tf32
@torch.no_grad()
def served_logits(params: dict, cfg, w: dict, prompt_ids: torch.Tensor,
                  prompt_mask: torch.Tensor, frames: torch.Tensor):
    """For one request (``prompt [S, 33]``, served ``frames [F, 32]``) the
    reference logits of every served token, ``(c0 [F, Va], rest [F, 31,
    Va])``: the backbone over the prompt and the first ``F - 1`` served
    frames, c0 from the hidden before each frame, and the decoder
    teacher-forced on the served codebooks."""
    S, N, F_ = prompt_ids.shape[0], cfg.audio_num_codebooks, frames.shape[0]
    dev = prompt_ids.device
    ids = torch.zeros((S + F_ - 1, N + 1), dtype=torch.long, device=dev)
    mask = torch.zeros(ids.shape, dtype=torch.float32, device=dev)
    ids[:S], mask[:S] = prompt_ids, prompt_mask
    ids[S:, :N] = frames[:F_ - 1]
    mask[S:, :N] = 1.0
    c = cfg.backbone
    h = backbone(params, c, embed_frames(params, cfg, ids, mask), w["backbone"], w["state"])
    last_h = rms(h[S - 1:], c.rms_norm_eps) * params["backbone"]["final_norm"].float()
    c0 = (last_h @ params["codebook0_head"].float()) / c.logits_scaling
    x = decoder_inputs(params, cfg, last_h, frames, N - 1)  # [F, 32, Dd]
    dh = decoder_forward(cfg, w["decoder"], x)
    rest = torch.einsum("fcd,cdv->fcv", dh[:, 1:N], w["decoder"]["head"])
    return c0, rest
