"""Streaming Mimi: codes to audio (and audio to codes) chunk by chunk with
carried state (counterpart of ``csm_tpu/codec/streaming.py``).

Concatenated chunk outputs equal a full :func:`~csm_tpu_torch.codec.mimi.
mimi_decode` over the same codes up to float reassociation, because the
state carries:

- a **padding cache** per causal conv: its last ``padding_total`` input
  samples, which replace the zero left-pad from the second chunk on;
- an **overlap tail** per transposed conv: a stride-``s``, kernel-``k``
  transposed conv overlaps adjacent chunks by ``k - s`` output samples,
  which are summed into the next chunk's head;
- a **sliding-window KV shift buffer** for the codec transformer: the last
  keys and values at absolute RoPE positions, moshi's context exactly.  A
  stream longer than the RoPE table (``ROPE_TABLE_POS``) is rebased: the
  cached keys are rotated back by a constant phase and the position shifts
  down, which RoPE's relative attention does not see.

A state is a dict of tensors and Python ints; :func:`decode_step` and
:func:`encode_step` return a new one.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from csm_tpu_torch.codec.mimi import (
    NEG_INF,
    ConvSpec,
    MimiCodecConfig,
    codec_rope,
    decoder_plan,
    downsample_spec,
    encoder_plan,
    fp32_convolutions,
    per_layer,
    quantizer_decode,
    quantizer_encode,
    transformer_layer,
    upsample_spec,
)
from csm_tpu_torch.utils.profiling import span

ROPE_TABLE_POS = 8192  # streaming RoPE table length; rebased before it is reached


# ---------------------------------------------------------------------------
# Streaming conv primitives
# ---------------------------------------------------------------------------


def _stream_conv(x, w, b, spec: ConvSpec, cache):
    """Causal conv with a carried left-context cache; the chunk length must
    be a multiple of the stride (frame-aligned chunks)."""
    xc = torch.cat([cache, x], dim=-1)
    out = F.conv1d(xc, w, b, stride=spec.stride, dilation=spec.dilation, groups=spec.groups)
    pad = spec.padding_total
    new_cache = xc[..., xc.shape[-1] - pad:] if pad > 0 else cache
    return out, new_cache


def _stream_conv_transpose(x, w, b, spec: ConvSpec, tail):
    """Causal transposed conv emitting ``t * stride`` samples per ``t``-sample
    chunk; the ``k - s`` raw samples past them are carried and summed into
    the next chunk's head.  The bias goes on after the overlap-add (the
    carried tail has none), so each sample receives it once."""
    k, s = spec.kernel, spec.stride
    raw = F.conv_transpose1d(x, w, None, stride=s, groups=spec.groups)  # [B, C, (t-1)s + k]
    t_out = x.shape[-1] * s
    overlap = k - s
    head = raw[..., :t_out]
    if overlap > 0:
        head = torch.cat([head[..., :overlap] + tail, head[..., overlap:]], dim=-1)
        new_tail = raw[..., t_out:t_out + overlap]
    else:
        new_tail = tail
    if b is not None:
        head = head + b[None, :, None]
    return head, new_tail


# ---------------------------------------------------------------------------
# Streaming transformer (shift KV buffer, absolute positions)
# ---------------------------------------------------------------------------


def _rebase_rotation(cfg: MimiCodecConfig, delta: int, device):
    """``(cos, sin)`` of ``-delta * inv_freq`` (float64, HF duplicated
    layout): rotating a cached key by it moves its RoPE phase back by exactly
    ``delta`` positions."""
    inv_freq = 1.0 / (np.float64(cfg.rope_theta)
                      ** (np.arange(0, cfg.head_dim, 2, dtype=np.float64) / cfg.head_dim))
    ang = -np.float64(delta) * inv_freq
    emb = np.concatenate([ang, ang], axis=-1)
    return (torch.tensor(np.cos(emb), dtype=torch.float32, device=device),
            torch.tensor(np.sin(emb), dtype=torch.float32, device=device))


def _kv_init(cfg: MimiCodecConfig, batch: int, max_chunk_frames: int, dtype, device) -> dict:
    """The KV shift buffer: ``window + 2 max_chunk - 1`` slots, so that the
    earliest query of a chunk still sees its whole window (the transformer
    takes 2 tokens per frame after the x2 upsample)."""
    W = (cfg.sliding_window or 256) + 2 * max_chunk_frames - 1
    shape = (cfg.num_hidden_layers, batch, W, cfg.num_attention_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "pos": 0}


def _stream_transformer(cfg: MimiCodecConfig, params: dict, x: torch.Tensor, kv: dict):
    """One cached transformer step over a ``[B, t, H]`` chunk; ``kv`` holds
    ``k`` / ``v [L, B, W, nh, hd]`` and ``pos``, the chunk's first absolute
    position.  Returns ``(h, new kv)``."""
    B, t, _ = x.shape
    hd = cfg.head_dim
    W = kv["k"].shape[2]
    if cfg.sliding_window is not None and t > W - cfg.sliding_window + 1:
        raise ValueError(
            f"chunk of {t} tokens exceeds the KV buffer margin ({W} slots, window "
            f"{cfg.sliding_window}); increase max_chunk_frames in the state init")
    dev = x.device
    if kv["pos"] + t >= ROPE_TABLE_POS:
        delta = ROPE_TABLE_POS // 2
        cos_d, sin_d = _rebase_rotation(cfg, delta, dev)
        k = kv["k"]
        rot = torch.cat([-k[..., hd // 2:], k[..., :hd // 2]], dim=-1)
        kv = {**kv, "k": (k * cos_d + rot * sin_d).to(k.dtype), "pos": kv["pos"] - delta}
    pos0 = kv["pos"]
    cos_t, sin_t = codec_rope(cfg, ROPE_TABLE_POS, dev)
    cos_q, sin_q = cos_t[pos0:pos0 + t], sin_t[pos0:pos0 + t]
    # After the shift, slot j holds absolute position pos0 + t - W + j.
    q_pos = (pos0 + torch.arange(t, device=dev))[:, None]
    k_pos = (pos0 + t - W + torch.arange(W, device=dev))[None, :]
    ok = (k_pos <= q_pos) & (k_pos >= 0)
    if cfg.sliding_window is not None:
        ok = ok & (q_pos - k_pos < cfg.sliding_window)
    bias = torch.where(ok, 0.0, NEG_INF).to(x.dtype)
    h, new_k, new_v = x, [], []
    for l, (lp, k, v) in enumerate(zip(per_layer(params), kv["k"].unbind(0), kv["v"].unbind(0))):
        with span("csm.codec.layer", l=l):
            h, (ck, cv) = transformer_layer(cfg, lp, h, cos_q, sin_q, bias, kv=(k, v))
        new_k.append(ck)
        new_v.append(cv)
    return h, {"k": torch.stack(new_k), "v": torch.stack(new_v), "pos": pos0 + t}


# ---------------------------------------------------------------------------
# Decoder streaming state
# ---------------------------------------------------------------------------


def decode_state_init(cfg: MimiCodecConfig, batch: int, dtype=torch.float32,
                      max_chunk_frames: int = 8, device=None) -> dict:
    """Zero streaming-decode state; ``max_chunk_frames`` is the largest
    codes chunk one :func:`decode_step` will receive."""
    up = upsample_spec(cfg)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    convs: List[torch.Tensor] = []
    tails: List[torch.Tensor] = []
    for item in decoder_plan(cfg):
        if item[0] == "conv":
            spec = item[1]
            if spec.transposed:
                tails.append(zeros(batch, spec.out_ch, spec.kernel - spec.stride))
            else:
                convs.append(zeros(batch, spec.in_ch, spec.padding_total))
        elif item[0] == "resnet":
            convs.extend(zeros(batch, spec.in_ch, spec.padding_total) for spec in item[1])
    return {
        "upsample_tail": zeros(batch, up.in_ch, up.kernel - up.stride),
        "kv": _kv_init(cfg, batch, max_chunk_frames, dtype, device),
        "conv_caches": convs,
        "conv_tails": tails,
    }


@torch.no_grad()
@fp32_convolutions
def decode_step(cfg: MimiCodecConfig, params: dict, state: dict,
                codes: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Decode ``codes [B, Q, t]`` -> ``(wave [B, 1, t hop], new state)``, hop
    = 2 x total stride (1920 samples, 80 ms, a frame at the default
    config)."""
    x = quantizer_decode(cfg, params["quantizer"], codes).transpose(1, 2)  # [B, H, t]
    x, up_tail = _stream_conv_transpose(x, params["upsample"]["w"], None, upsample_spec(cfg),
                                        state["upsample_tail"])
    h, kv = _stream_transformer(cfg, params["decoder_transformer"], x.transpose(1, 2),
                                state["kv"])
    x = h.transpose(1, 2)
    convs, tails = list(state["conv_caches"]), list(state["conv_tails"])
    ci = ti = 0
    with span("csm.codec.seanet"):
        for item, p in zip(decoder_plan(cfg), params["decoder"]):
            kind = item[0]
            if kind == "elu":
                x = F.elu(x)
            elif kind == "conv":
                spec = item[1]
                if spec.transposed:
                    x, tails[ti] = _stream_conv_transpose(x, p["w"], p.get("b"), spec, tails[ti])
                    ti += 1
                else:
                    x, convs[ci] = _stream_conv(x, p["w"], p.get("b"), spec, convs[ci])
                    ci += 1
            else:  # resnet
                res = x
                for spec, cp in zip(item[1], p["block"]):
                    x, convs[ci] = _stream_conv(F.elu(x), cp["w"], cp.get("b"), spec, convs[ci])
                    ci += 1
                x = res + x
    return x, {"upsample_tail": up_tail, "kv": kv, "conv_caches": convs, "conv_tails": tails}


# ---------------------------------------------------------------------------
# Encoder streaming state
# ---------------------------------------------------------------------------


def _encoder_conv_specs(cfg: MimiCodecConfig) -> List[ConvSpec]:
    """Every conv of the encoder stack and the downsample, in order."""
    specs = []
    for item in encoder_plan(cfg):
        if item[0] == "conv":
            specs.append(item[1])
        elif item[0] == "resnet":
            specs.extend(item[1])
    specs.append(downsample_spec(cfg))
    return specs


def encode_state_init(cfg: MimiCodecConfig, batch: int, dtype=torch.float32,
                      max_chunk_frames: int = 8, device=None) -> dict:
    """Zero streaming-encode state.  Chunks must be multiples of the 80 ms
    ``frame_size`` so every strided conv keeps its phase."""
    return {
        "conv_caches": [torch.zeros((batch, s.in_ch, s.padding_total), dtype=dtype, device=device)
                        for s in _encoder_conv_specs(cfg)],
        # The "replicate"-padded downsample seeds its cache from the first
        # chunk's first sample instead of zeros.
        "started": False,
        "kv": _kv_init(cfg, batch, max_chunk_frames, dtype, device),
    }


@torch.no_grad()
@fp32_convolutions
def encode_step(cfg: MimiCodecConfig, params: dict, state: dict, wave: torch.Tensor,
                num_quantizers: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """Encode a ``[B, 1, t frame_size]`` chunk -> ``(codes [B, Q, t], new
    state)``."""
    if wave.shape[-1] % cfg.frame_size != 0:
        raise ValueError(f"streaming encode chunks must be multiples of frame_size="
                         f"{cfg.frame_size}, got {wave.shape[-1]}")
    nq = cfg.num_quantizers if num_quantizers is None else num_quantizers
    convs = list(state["conv_caches"])
    x = wave.float()
    ci = 0
    for item, p in zip(encoder_plan(cfg), params["encoder"]):
        kind = item[0]
        if kind == "elu":
            x = F.elu(x)
        elif kind == "conv":
            x, convs[ci] = _stream_conv(x, p["w"], p.get("b"), item[1], convs[ci])
            ci += 1
        else:  # resnet
            res = x
            for spec, cp in zip(item[1], p["block"]):
                x, convs[ci] = _stream_conv(F.elu(x), cp["w"], cp.get("b"), spec, convs[ci])
                ci += 1
            x = res + x
    h, kv = _stream_transformer(cfg, params["encoder_transformer"], x.transpose(1, 2),
                                state["kv"])
    x = h.transpose(1, 2)
    cache = convs[ci] if state["started"] else x[..., :1].expand_as(convs[ci])
    x, convs[ci] = _stream_conv(x, params["downsample"]["w"], None, downsample_spec(cfg), cache)
    codes = quantizer_encode(cfg, params["quantizer"], x.transpose(1, 2), nq)
    return codes, {"conv_caches": convs, "started": True, "kv": kv}


class StreamingMimiEncoder:
    """Feed frame-aligned audio, get codes per frame:
    ``enc.feed(wave [B, 1, n 1920]) -> [B, Q, n]`` numpy codes."""

    def __init__(self, codec, batch: int = 1):
        self.codec = codec
        self.reset(batch)

    def feed(self, wave) -> np.ndarray:
        w = torch.as_tensor(np.asarray(wave, np.float32), device=self.codec.device)
        codes, self.state = encode_step(self.codec.config, self.codec.params, self.state, w,
                                        self.codec.num_codebooks)
        return codes.cpu().numpy()

    def reset(self, batch: Optional[int] = None) -> None:
        """Start a new stream (of ``batch`` rows, default the current)."""
        b = batch or self.state["kv"]["k"].shape[1]
        self.state = encode_state_init(self.codec.config, b, device=self.codec.device)


class StreamingMimiDecoder:
    """Feed frames of codes, get audio chunks:
    ``dec.feed(codes [B, Q, t]) -> [B, t hop]`` numpy PCM."""

    def __init__(self, codec, batch: int = 1):
        self.codec = codec
        self.reset(batch)

    def feed(self, codes) -> np.ndarray:
        codes = np.asarray(codes)
        with span("csm.codec.feed", B=codes.shape[0]):
            c = torch.as_tensor(codes, device=self.codec.device).long()
            out, self.state = decode_step(self.codec.config, self.codec.params, self.state, c)
            return out[:, 0, :].cpu().numpy()

    def reset(self, batch: Optional[int] = None) -> None:
        """Start a new stream (of ``batch`` rows, default the current)."""
        b = batch or self.state["kv"]["k"].shape[1]
        self.state = decode_state_init(self.codec.config, b, device=self.codec.device)
