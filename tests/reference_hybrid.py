"""Plain float32 reference of CSM's hybrid backbone (HF ``GraniteMoeHybrid``
without experts, as ``ibm-granite/granite-4.0-h-micro`` publishes it), for
the port's tests.  Plain ``torch`` with TF32 off, one sequence at a time, no
cache, no kernel and no chunking; it imports nothing of the port or of the
JAX package and reads the parameters in the port's layout (a dict of
tensors) and the config's numbers by attribute.

As published:

- ``h = embedding_multiplier * e`` with ``e`` CSM's summed frame embedding
  (CSM's choice: the multiplier applies to the summed 33-way embedding);
- every layer ``h += residual_multiplier * mixer(rms(h))``, then ``h +=
  residual_multiplier * mlp(rms(h))``, the mixer a Mamba-2 layer or GQA
  attention with no position embedding and scores times
  ``attention_multiplier``;
- the Mamba-2 layer: ``in_proj`` to ``z``, ``xBC``, ``dt``; a causal
  depthwise conv of width ``d_conv`` with bias over ``xBC``, SiLU; ``Δ =
  softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the recurrence run position
  by position, ``S_t = exp(Δ_t A) S_{t-1} + Δ_t x_t ⊗ B_t``, ``y_t = S_t C_t
  + D x_t``; ``out_proj(rms_w(y ⊙ silu(z)))`` over all channels;
- a final RMSNorm, and the c0 logits ``c0_head(h) / logits_scaling`` (CSM's
  choice: the published LM head's scaling applies to CSM's codebook-0 head).

Departures: none in the mathematics.  Frames whose mask is all zero are not
given to it (the program's padding); the recurrence starts from zero states.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def _embed(params, cfg, ids, mask):
    N, Va = cfg.audio_num_codebooks, cfg.audio_vocab_size
    offs = torch.arange(N) * Va
    audio = params["audio_embeddings"].float()[ids[:, :N].long() + offs]
    text = params["text_embeddings"].float()[ids[:, N].long()]
    m = mask.float()
    return torch.einsum("tnd,tn->td", audio, m[:, :N]) + text * m[:, N:]


def mamba(lp, c, x):
    """One Mamba-2 layer over ``x [T, D]`` (normed), position by position."""
    T = x.shape[0]
    H, P, N, G = c.mamba_n_heads, c.mamba_d_head, c.mamba_d_state, c.mamba_n_groups
    inner = c.mamba_expand * c.hidden_size
    C = inner + 2 * G * N
    K = c.mamba_d_conv
    zxbcdt = x @ lp["in_proj"]
    z, xbc, dt = zxbcdt[:, :inner], zxbcdt[:, inner:inner + C], zxbcdt[:, inner + C:]
    # Causal depthwise conv: weight [C, K] as HF's conv1d [C, 1, K], left padding K - 1.
    conv = F.conv1d(xbc.T[None], lp["conv_w"][:, None, :], lp["conv_b"], padding=K - 1,
                    groups=C)[0, :, :T].T
    xbc = F.silu(conv)
    xs = xbc[:, :inner].reshape(T, H, P)
    Bm = xbc[:, inner:inner + G * N].reshape(T, G, N).repeat_interleave(H // G, dim=1)
    Cm = xbc[:, inner + G * N:].reshape(T, G, N).repeat_interleave(H // G, dim=1)
    delta = F.softplus(dt + lp["dt_bias"])  # [T, H]
    A = -torch.exp(lp["A_log"])
    S = torch.zeros((H, P, N))
    ys = []
    for t in range(T):
        S = torch.exp(delta[t] * A)[:, None, None] * S + \
            (delta[t][:, None] * xs[t])[:, :, None] * Bm[t][:, None, :]
        ys.append(torch.einsum("hpn,hn->hp", S, Cm[t]) + lp["D"][:, None] * xs[t])
    y = torch.stack(ys).reshape(T, inner) * F.silu(z)
    return _rms(y, lp["gate_norm"], c.rms_norm_eps) @ lp["out_proj"]


def attention(lp, c, x):
    """Causal GQA over ``x [T, D]`` (normed) with no position embedding."""
    T = x.shape[0]
    nq, nkv = c.num_attention_heads, c.num_key_value_heads
    hd = c.hidden_size // nq
    q = (x @ lp["wq"]).reshape(T, nkv, nq // nkv, hd)
    k = (x @ lp["wk"]).reshape(T, nkv, hd)
    v = (x @ lp["wv"]).reshape(T, nkv, hd)
    scores = torch.einsum("tngh,snh->ngts", q, k) * c.attention_multiplier
    causal = torch.ones((T, T), dtype=torch.bool).tril()
    probs = torch.softmax(scores.masked_fill(~causal, -math.inf), dim=-1)
    return torch.einsum("ngts,snh->tngh", probs, v).reshape(T, nq * hd) @ lp["wo"]


def mlp(lp, x):
    return (F.silu(x @ lp["w_gate"]) * (x @ lp["w_up"])) @ lp["w_down"]


def c0_logits(params, cfg, ids, mask):
    """The c0 logits ``[T, Va]`` at every position of one sequence ``ids,
    mask [T, 33]`` (every frame real), float32."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            c = cfg.backbone
            bb = {k: ({n: w.float() for n, w in v.items()} if isinstance(v, dict) else v.float())
                  for k, v in params["backbone"].items()}
            h = _embed(params, cfg, ids, mask) * c.embedding_multiplier
            im = ia = 0
            for kind in c.layer_types:
                group, i = ("mamba", im) if kind == "mamba" else ("attn", ia)
                lp = {n: w[i] for n, w in bb[group].items()}
                if kind == "mamba":
                    h = h + c.residual_multiplier * mamba(lp, c, _rms(h, lp["norm"],
                                                                       c.rms_norm_eps))
                    im += 1
                else:
                    h = h + c.residual_multiplier * attention(lp, c, _rms(h, lp["attn_norm"],
                                                                           c.rms_norm_eps))
                    ia += 1
                h = h + c.residual_multiplier * mlp(lp, _rms(h, lp["mlp_norm"], c.rms_norm_eps))
            h = _rms(h, bb["final_norm"], c.rms_norm_eps)
            return (h @ params["codebook0_head"].float()) / c.logits_scaling
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
