"""The plain reference of the Mimi decoder (codes -> 24 kHz PCM), frozen
here from the port's offline decode path: RVQ dequantization (semantic +
acoustic codebooks and their output projections, a code past the codebook
clamped to its last centroid), the grouped transposed-conv upsample, the
causal transformer at 25 Hz (LayerNorm, RoPE, sliding window, GELU MLP,
layer scale), the SEANet decoder with its causal trims.  Plain ``torch``;
imports nothing of the program.  Float32; TF32 stays off unless the caller
turns it on (the control does).

``cfg`` is a :class:`types.SimpleNamespace` of the configuration file's
``codec`` object (the published ``kyutai/mimi`` sizes)."""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e9


def config(d: dict) -> SimpleNamespace:
    return SimpleNamespace(**d)


def conv(in_ch, out_ch, kernel, stride=1, dilation=1, groups=1, bias=True, transposed=False):
    return SimpleNamespace(in_ch=in_ch, out_ch=out_ch, kernel=kernel, stride=stride,
                           dilation=dilation, groups=groups, bias=bias, transposed=transposed)


def decoder_plan(cfg) -> list:
    """The SEANet decoder: ``("conv", spec)`` / ``("elu",)`` / ``("resnet",
    [spec, spec])``."""
    scaling = 2 ** len(cfg.upsampling_ratios)
    plan = [("conv", conv(cfg.hidden_size, scaling * cfg.num_filters, cfg.kernel_size))]
    for ratio in cfg.upsampling_ratios:
        current = scaling * cfg.num_filters
        plan.append(("elu",))
        plan.append(("conv", conv(current, current // 2, ratio * 2, stride=ratio,
                                  transposed=True)))
        for j in range(cfg.num_residual_layers):
            dim = current // 2
            hidden = dim // cfg.compress
            plan.append(("resnet", [conv(dim, hidden, cfg.residual_kernel_size,
                                         dilation=cfg.dilation_growth_rate ** j),
                                    conv(hidden, dim, 1)]))
        scaling //= 2
    plan.append(("elu",))
    plan.append(("conv", conv(cfg.num_filters, cfg.audio_channels, cfg.last_kernel_size)))
    return plan


def upsample_spec(cfg):
    k = 2 * int(cfg.encodec_frame_rate / cfg.frame_rate)
    return conv(cfg.hidden_size, cfg.hidden_size, k, stride=2, bias=False,
                groups=cfg.upsample_groups, transposed=True)


def _conv(x, w, b, s):
    k_eff = (s.kernel - 1) * s.dilation + 1
    pad = k_eff - s.stride
    n = math.ceil((x.shape[-1] - k_eff + pad) / s.stride)
    extra = n * s.stride + k_eff - pad - x.shape[-1]
    x = F.pad(x, (pad, extra))
    return F.conv1d(x, w, b, stride=s.stride, dilation=s.dilation, groups=s.groups)


def _conv_t(x, w, b, s, trim_right_ratio):
    out = F.conv_transpose1d(x, w, b, stride=s.stride, groups=s.groups)
    total = s.kernel - s.stride
    right = math.ceil(total * trim_right_ratio)
    return out[..., total - right:out.shape[-1] - right]


def _layernorm(x, w, b, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def _rope(cfg, T, device):
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, cfg.head_dim, 2, dtype=np.float64) / cfg.head_dim))
    freqs = np.outer(np.arange(T, dtype=np.float32), inv.astype(np.float32))
    emb = np.concatenate([freqs, freqs], axis=-1)
    return torch.from_numpy(np.cos(emb)).to(device), torch.from_numpy(np.sin(emb)).to(device)


def _rotate(v, cos, sin):
    half = v.shape[-1] // 2
    rot = torch.cat([-v[..., half:], v[..., :half]], dim=-1)
    return v * cos[None, :, None, :] + rot * sin[None, :, None, :]


def transformer(cfg, params, x):
    """Causal transformer over ``x [B, T, H]``: query ``s`` attends keys
    ``t`` with ``s - window < t <= s``."""
    B, T, _ = x.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    cos, sin = _rope(cfg, T, x.device)
    q_pos = torch.arange(T, device=x.device)[:, None]
    k_pos = torch.arange(T, device=x.device)[None, :]
    ok = (k_pos <= q_pos) & (q_pos - k_pos < cfg.sliding_window)
    bias = torch.where(ok, 0.0, NEG_INF)
    lay = params["layers"]
    h = x
    for l in range(lay["wq"].shape[0]):
        p = {k: v[l] for k, v in lay.items()}
        y = _layernorm(h, p["ln1_w"], p["ln1_b"], cfg.norm_eps)
        q = _rotate((y @ p["wq"]).reshape(B, T, nh, hd), cos, sin)
        k = _rotate((y @ p["wk"]).reshape(B, T, nh, hd), cos, sin)
        v = (y @ p["wv"]).reshape(B, T, nh, hd)
        probs = torch.softmax(torch.einsum("bsnh,btnh->bnst", q, k) / math.sqrt(hd) + bias, dim=-1)
        attn = torch.einsum("bnst,btnh->bsnh", probs, v).reshape(B, T, nh * hd)
        h = h + (attn @ p["wo"]) * p["scale_attn"]
        y = _layernorm(h, p["ln2_w"], p["ln2_b"], cfg.norm_eps)
        h = h + (F.gelu(y @ p["fc1"]) @ p["fc2"]) * p["scale_mlp"]
    return h


def _rvq(codebooks, codes):
    V = codebooks.shape[1]
    out = 0
    for q in range(codes.shape[1]):
        out = out + codebooks[q][codes[:, q].long().clamp(0, V - 1)]
    return out


def decode(cfg, params, codes: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """``codes [B, Q, frames]`` -> PCM ``[B, frames * 1920]``, in float32
    with TF32 off (``tf32=True``: the control's precision below it)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        return _decode(cfg, params, codes)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _decode(cfg, params, codes):
    qz = params["quantizer"]
    ns = cfg.num_semantic_quantizers
    x = _rvq(qz["semantic"]["codebooks"], codes[:, :ns]) @ qz["semantic"]["output_proj"]
    if codes.shape[1] > ns:
        x = x + _rvq(qz["acoustic"]["codebooks"], codes[:, ns:]) @ qz["acoustic"]["output_proj"]
    x = _conv_t(x.transpose(1, 2), params["upsample"]["w"], None, upsample_spec(cfg),
                cfg.trim_right_ratio)
    x = transformer(cfg, params["decoder_transformer"], x.transpose(1, 2)).transpose(1, 2)
    for item, p in zip(decoder_plan(cfg), params["decoder"]):
        if item[0] == "elu":
            x = F.elu(x)
        elif item[0] == "conv":
            s = item[1]
            x = (_conv_t(x, p["w"], p.get("b"), s, cfg.trim_right_ratio) if s.transposed
                 else _conv(x, p["w"], p.get("b"), s))
        else:
            res = x
            for s, cp in zip(item[1], p["block"]):
                x = _conv(F.elu(x), cp["w"], cp.get("b"), s)
            x = res + x
    return x[:, 0]
