"""Mimi codec: model definition and functional forward passes (counterpart
of ``csm_tpu/codec/mimi.py``).

encode:  wave ``[B, 1, T]``
  -> SEANet encoder (causal convs, ELU, residual blocks; total stride 960)
  -> causal transformer at 25 Hz (LayerNorm with bias, MHA with RoPE
     theta 10000, sliding window 250, GELU MLP, per-channel layer scale)
  -> causal stride-2 "replicate"-padded downsample to 12.5 Hz
  -> split RVQ: 1 semantic + 31 acoustic residual quantizers, each side with
     its own 1x1 input/output projections; nearest-neighbour (Euclidean)
     code assignment -> codes ``[B, 32, frames]``

decode:  codes -> RVQ dequantize (sum of codebook vectors + output
  projection, semantic + acoustic summed) -> grouped transposed-conv
  upsample (stride 2) -> causal transformer -> SEANet decoder (transposed
  convs with a causal right trim) -> wave ``[B, 1, T]``

The parameters keep the JAX package's layout (torch ``[out, in/groups, k]``
conv kernels, ``[in, out/groups, k]`` transposed-conv kernels, input-major
linear weights, transformer layers stacked on a leading axis), so the
convolutions are ``torch.nn.functional`` calls on them as they are.  The
codec holds no Pallas kernel in the JAX package: its convolutions and
products stay library calls here too.

The convolutions run in full fp32 whatever the caller set
(:func:`fp32_convolutions`): under torch's default ``cudnn.allow_tf32 =
True`` the card's encode drifted from the CPU's in the later residual
codebooks (0.965 of codes equal in the worst one on an H100; 1.0 in fp32).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from csm_tpu_torch.device import DeviceLike, resolve_device

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class MimiCodecConfig:
    """Shape of the Mimi codec; defaults are the published kyutai/mimi."""

    sampling_rate: int = 24000
    frame_rate: float = 12.5
    encodec_frame_rate: float = 25.0
    audio_channels: int = 1
    num_quantizers: int = 32
    num_semantic_quantizers: int = 1
    codebook_size: int = 2048
    codebook_dim: int = 256
    hidden_size: int = 512
    num_filters: int = 64
    num_residual_layers: int = 1
    upsampling_ratios: Tuple[int, ...] = (8, 6, 5, 4)
    kernel_size: int = 7
    last_kernel_size: int = 3
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    compress: int = 2
    trim_right_ratio: float = 1.0
    vector_quantization_hidden_dimension: int = 256
    upsample_groups: int = 512
    # transformer
    num_hidden_layers: int = 8
    intermediate_size: int = 2048
    num_attention_heads: int = 8
    num_key_value_heads: int = 8
    head_dim: int = 64
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = 250
    layer_scale_initial_scale: float = 0.01

    @property
    def total_stride(self) -> int:
        """Encoder hop at the transformer rate (960 samples at 25 Hz for the
        default config; the x2 downsample makes 1920 per 12.5 Hz frame)."""
        s = 1
        for r in self.upsampling_ratios:
            s *= r
        return s

    @property
    def frame_size(self) -> int:
        return int(self.sampling_rate / self.frame_rate)

    @classmethod
    def tiny(cls, **overrides) -> "MimiCodecConfig":
        kwargs = dict(
            num_quantizers=8,
            codebook_size=64,
            codebook_dim=16,
            hidden_size=32,
            num_filters=8,
            vector_quantization_hidden_dimension=16,
            upsample_groups=32,
            num_hidden_layers=2,
            intermediate_size=64,
            num_attention_heads=4,
            num_key_value_heads=4,
            head_dim=8,
            sliding_window=16,
        )
        kwargs.update(overrides)
        return cls(**kwargs)


# ---------------------------------------------------------------------------
# Layer plan: the static structure of the SEANet conv stacks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    in_ch: int
    out_ch: int
    kernel: int
    stride: int = 1
    dilation: int = 1
    groups: int = 1
    bias: bool = True
    pad_mode: str = "constant"
    transposed: bool = False

    @property
    def effective_kernel(self) -> int:
        return (self.kernel - 1) * self.dilation + 1

    @property
    def padding_total(self) -> int:
        return self.effective_kernel - self.stride


def encoder_plan(cfg: MimiCodecConfig) -> List:
    """The encoder layer sequence: ``("conv", ConvSpec)`` / ``("elu",)`` /
    ``("resnet", [ConvSpec, ConvSpec])``; SEANet with reversed ratios."""
    plan = [("conv", ConvSpec(cfg.audio_channels, cfg.num_filters, cfg.kernel_size))]
    scaling = 1
    for ratio in reversed(cfg.upsampling_ratios):
        current = scaling * cfg.num_filters
        for j in range(cfg.num_residual_layers):
            hidden = current // cfg.compress
            plan.append(("resnet", [
                ConvSpec(current, hidden, cfg.residual_kernel_size,
                         dilation=cfg.dilation_growth_rate ** j),
                ConvSpec(hidden, current, 1),
            ]))
        plan.append(("elu",))
        plan.append(("conv", ConvSpec(current, current * 2, ratio * 2, stride=ratio)))
        scaling *= 2
    plan.append(("elu",))
    plan.append(("conv", ConvSpec(scaling * cfg.num_filters, cfg.hidden_size,
                                  cfg.last_kernel_size)))
    return plan


def decoder_plan(cfg: MimiCodecConfig) -> List:
    """The decoder layer sequence (the SEANet mirror, transposed convs)."""
    scaling = 2 ** len(cfg.upsampling_ratios)
    plan = [("conv", ConvSpec(cfg.hidden_size, scaling * cfg.num_filters, cfg.kernel_size))]
    for ratio in cfg.upsampling_ratios:
        current = scaling * cfg.num_filters
        plan.append(("elu",))
        plan.append(("conv", ConvSpec(current, current // 2, ratio * 2, stride=ratio,
                                      transposed=True)))
        for j in range(cfg.num_residual_layers):
            dim = current // 2
            hidden = dim // cfg.compress
            plan.append(("resnet", [
                ConvSpec(dim, hidden, cfg.residual_kernel_size,
                         dilation=cfg.dilation_growth_rate ** j),
                ConvSpec(hidden, dim, 1),
            ]))
        scaling //= 2
    plan.append(("elu",))
    plan.append(("conv", ConvSpec(cfg.num_filters, cfg.audio_channels, cfg.last_kernel_size)))
    return plan


def downsample_spec(cfg: MimiCodecConfig) -> ConvSpec:
    k = 2 * int(cfg.encodec_frame_rate / cfg.frame_rate)
    return ConvSpec(cfg.hidden_size, cfg.hidden_size, k, stride=2, bias=False,
                    pad_mode="replicate")


def upsample_spec(cfg: MimiCodecConfig) -> ConvSpec:
    k = 2 * int(cfg.encodec_frame_rate / cfg.frame_rate)
    return ConvSpec(cfg.hidden_size, cfg.hidden_size, k, stride=2, bias=False,
                    groups=cfg.upsample_groups, transposed=True)


# ---------------------------------------------------------------------------
# Conv primitives (causal padding, torch NCH / OIH layout)
# ---------------------------------------------------------------------------


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                  spec: ConvSpec) -> torch.Tensor:
    """Causal conv: left-pad ``padding_total``, right-pad the ``extra`` so no
    sample is dropped (ceil framing), then a valid conv."""
    length = x.shape[-1]
    k_eff, stride = spec.effective_kernel, spec.stride
    n_frames = math.ceil((length - k_eff + spec.padding_total) / stride)
    ideal = n_frames * stride + k_eff - spec.padding_total
    extra = ideal - length
    mode = "replicate" if spec.pad_mode == "replicate" else "constant"
    x = F.pad(x, (spec.padding_total, extra), mode=mode)
    return F.conv1d(x, w, b, stride=stride, dilation=spec.dilation, groups=spec.groups)


def causal_conv_transpose1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                            spec: ConvSpec, trim_right_ratio: float = 1.0) -> torch.Tensor:
    """Transposed conv (``w`` in the ``[in, out/groups, k]`` layout) with the
    causal trim: ``ceil((k - stride) * trim_right_ratio)`` from the right,
    the rest from the left."""
    out = F.conv_transpose1d(x, w, b, stride=spec.stride, groups=spec.groups)
    padding_total = spec.kernel - spec.stride
    padding_right = math.ceil(padding_total * trim_right_ratio)
    padding_left = padding_total - padding_right
    return out[..., padding_left:out.shape[-1] - padding_right]


def _apply_plan(plan: List, params: List[dict], x: torch.Tensor,
                trim_right_ratio: float = 1.0) -> torch.Tensor:
    """Run a SEANet layer plan; ``params[i]`` matches ``plan[i]``."""
    for item, p in zip(plan, params):
        kind = item[0]
        if kind == "elu":
            x = F.elu(x)
        elif kind == "conv":
            spec = item[1]
            if spec.transposed:
                x = causal_conv_transpose1d(x, p["w"], p.get("b"), spec, trim_right_ratio)
            else:
                x = causal_conv1d(x, p["w"], p.get("b"), spec)
        elif kind == "resnet":
            res = x
            for spec, cp in zip(item[1], p["block"]):
                x = causal_conv1d(F.elu(x), cp["w"], cp.get("b"), spec)
            x = res + x
        else:
            raise ValueError(kind)
    return x


# ---------------------------------------------------------------------------
# Codec transformer (LayerNorm + MHA/RoPE + layer scale + GELU MLP)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def codec_rope(cfg: MimiCodecConfig, max_positions: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin) [max_positions, head_dim]`` float32 on ``device``, the HF
    duplicated layout, computed as the JAX package computes them; memoized
    (a streaming step asks for them every frame), never written."""
    inv_freq = 1.0 / (cfg.rope_theta
                      ** (np.arange(0, cfg.head_dim, 2, dtype=np.float64) / cfg.head_dim))
    t = np.arange(max_positions, dtype=np.float32)
    freqs = np.outer(t, inv_freq.astype(np.float32))
    emb = np.concatenate([freqs, freqs], axis=-1)
    return torch.from_numpy(np.cos(emb)).to(device), torch.from_numpy(np.sin(emb)).to(device)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def rotate(v: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE (rotate-half) of ``v [B, T, nh, hd]`` by ``cos/sin [T, hd]``."""
    half = v.shape[-1] // 2
    rot = torch.cat([-v[..., half:], v[..., :half]], dim=-1)
    return v * cos[None, :, None, :] + rot * sin[None, :, None, :]


def transformer_layer(cfg: MimiCodecConfig, lp: dict, h: torch.Tensor, cos, sin, bias,
                      kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One codec transformer layer over ``h [B, t, H]`` with queries and new
    keys rotated by ``cos/sin [t, hd]``.  ``kv``: the cached keys/values
    ``[B, W, nh, hd]`` the chunk's are shifted into (streaming); then the
    shifted buffers are returned with ``h``.  ``bias [t, T]`` is additive."""
    B, t, _ = h.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    y = layernorm(h, lp["ln1_w"], lp["ln1_b"], cfg.norm_eps)
    q = rotate((y @ lp["wq"]).reshape(B, t, nh, hd), cos, sin)
    k = rotate((y @ lp["wk"]).reshape(B, t, nh, hd), cos, sin)
    v = (y @ lp["wv"]).reshape(B, t, nh, hd)
    if kv is not None:
        k = torch.cat([kv[0][:, t:], k], dim=1)
        v = torch.cat([kv[1][:, t:], v], dim=1)
    scores = torch.einsum("bsnh,btnh->bnst", q, k) / math.sqrt(hd)
    probs = torch.softmax(scores + bias, dim=-1).to(v.dtype)
    attn = torch.einsum("bnst,btnh->bsnh", probs, v).reshape(B, t, nh * hd)
    h = h + (attn @ lp["wo"]) * lp["scale_attn"]
    y = layernorm(h, lp["ln2_w"], lp["ln2_b"], cfg.norm_eps)
    y = F.gelu(y @ lp["fc1"], approximate="none") @ lp["fc2"]
    return h + y * lp["scale_mlp"], (k, v)


def per_layer(params: dict) -> list:
    """The stacked transformer weights as one dict per layer (one unbind per
    weight, not a slice per layer and weight: a streaming step is host-bound
    on its small ops)."""
    split = {name: w.unbind(0) for name, w in params["layers"].items()}
    return [{name: ws[l] for name, ws in split.items()} for l in range(len(split["wq"]))]


def codec_transformer(cfg: MimiCodecConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Causal transformer over ``[B, T, H]`` with moshi's sliding window:
    query ``s`` attends keys ``t`` with ``s - window < t <= s`` (the HF eager
    port drops the window; the two differ only past it)."""
    T = x.shape[1]
    cos, sin = codec_rope(cfg, T, x.device)
    q_pos = torch.arange(T, device=x.device)[:, None]
    k_pos = torch.arange(T, device=x.device)[None, :]
    ok = k_pos <= q_pos
    if cfg.sliding_window is not None:
        ok = ok & (q_pos - k_pos < cfg.sliding_window)
    bias = torch.where(ok, 0.0, NEG_INF).to(x.dtype)
    h = x
    for lp in per_layer(params):
        h, _ = transformer_layer(cfg, lp, h, cos, sin, bias)
    return h


# ---------------------------------------------------------------------------
# Residual vector quantization
# ---------------------------------------------------------------------------


def rvq_encode(codebooks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Sequential residual nearest-neighbour quantization of ``x [B, T, D]``
    against ``codebooks [Q, V, D]``; returns ``[B, Q, T]`` int64.  The
    distance drops the ``|x|^2`` term; ties go to the first index."""
    residual, out = x, []
    for embed in codebooks:
        dist = (embed * embed).sum(dim=-1) - 2.0 * (residual @ embed.T)
        idx = torch.argmin(dist, dim=-1)
        residual = residual - embed[idx]
        out.append(idx)
    return torch.stack(out, dim=1)


def rvq_decode(codebooks: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``codes [B, Q, T]`` -> summed centroid vectors ``[B, T, D]``.  A code
    past the codebook (CSM's audio vocabulary has 3 more tokens than Mimi's
    2048 codes) takes the last centroid rather than faulting the device."""
    Q, V = codes.shape[1], codebooks.shape[1]
    codes = codes.long().clamp(0, V - 1).transpose(0, 1)  # [Q, B, T]
    q = torch.arange(Q, device=codes.device)[:, None, None]
    return codebooks[:Q][q, codes].sum(dim=0)


def quantizer_encode(cfg: MimiCodecConfig, q: dict, emb: torch.Tensor, nq: int) -> torch.Tensor:
    """Split RVQ of ``emb [B, T', H]`` -> codes ``[B, nq, T']``."""
    sem = rvq_encode(q["semantic"]["codebooks"], emb @ q["semantic"]["input_proj"])
    n_ac = nq - cfg.num_semantic_quantizers
    if n_ac > 0:
        ac = rvq_encode(q["acoustic"]["codebooks"][:n_ac], emb @ q["acoustic"]["input_proj"])
        return torch.cat([sem, ac], dim=1)
    return sem


def quantizer_decode(cfg: MimiCodecConfig, q: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes ``[B, Q, T']`` -> embeddings ``[B, T', H]``."""
    ns = cfg.num_semantic_quantizers
    emb = rvq_decode(q["semantic"]["codebooks"], codes[:, :ns]) @ q["semantic"]["output_proj"]
    if codes.shape[1] > ns:
        n_ac = codes.shape[1] - ns
        ac = rvq_decode(q["acoustic"]["codebooks"][:n_ac], codes[:, ns:])
        emb = emb + ac @ q["acoustic"]["output_proj"]
    return emb


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


class _Fp32Convolutions(contextlib.ContextDecorator):
    """``cudnn.allow_tf32`` off while any block is open, restored to what it
    was when the last overlapping block ends.  The setting is global to the
    process; blocks may overlap across threads (the trainer's batch-prefetch
    thread encodes while the main thread trains), so a lock and a depth
    count keep one thread from restoring it under another's convolutions."""

    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = True

    def __enter__(self):
        with self._lock:
            if self._depth == 0:
                self._saved = torch.backends.cudnn.allow_tf32
                torch.backends.cudnn.allow_tf32 = False
            self._depth += 1
        return self

    def __exit__(self, *exc):
        with self._lock:
            self._depth -= 1
            if self._depth == 0:
                torch.backends.cudnn.allow_tf32 = self._saved
        return False


# Every Mimi pass (offline and streaming) runs its convolutions in fp32.
fp32_convolutions = _Fp32Convolutions()


@fp32_convolutions


def mimi_encode(cfg: MimiCodecConfig, params: dict, wave: torch.Tensor,
                num_quantizers: Optional[int] = None) -> torch.Tensor:
    """``wave [B, 1, T]`` -> codes ``[B, num_quantizers, frames]`` int64."""
    nq = cfg.num_quantizers if num_quantizers is None else num_quantizers
    x = _apply_plan(encoder_plan(cfg), params["encoder"], wave.float())
    x = codec_transformer(cfg, params["encoder_transformer"], x.transpose(1, 2)).transpose(1, 2)
    x = causal_conv1d(x, params["downsample"]["w"], None, downsample_spec(cfg))
    return quantizer_encode(cfg, params["quantizer"], x.transpose(1, 2), nq)


@fp32_convolutions
def mimi_decode(cfg: MimiCodecConfig, params: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes ``[B, Q, frames]`` -> wave ``[B, 1, T]``."""
    x = quantizer_decode(cfg, params["quantizer"], codes).transpose(1, 2)  # [B, H, T']
    x = causal_conv_transpose1d(x, params["upsample"]["w"], None, upsample_spec(cfg),
                                cfg.trim_right_ratio)
    x = codec_transformer(cfg, params["decoder_transformer"], x.transpose(1, 2)).transpose(1, 2)
    return _apply_plan(decoder_plan(cfg), params["decoder"], x, cfg.trim_right_ratio)


# ---------------------------------------------------------------------------
# User-facing wrapper
# ---------------------------------------------------------------------------


def tree_to(tree, device=None, dtype=None):
    """A nested dict / list of tensors moved to ``device`` / ``dtype``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device, dtype) for v in tree]
    return tree.to(device=device, dtype=dtype)


class MimiCodec:
    """The codec on one device (CUDA unless ``device="cpu"``):
    ``encode(wave [T]) -> [num_codebooks, F]`` numpy codes, batched
    ``encode_batch`` / ``decode``, and ``sample_rate``."""

    def __init__(self, config: MimiCodecConfig, params: dict,
                 num_codebooks: Optional[int] = None, device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device, torch.float32)
        self.num_codebooks = num_codebooks or config.num_quantizers
        self.sample_rate = config.sampling_rate
        self.frame_rate = config.frame_rate

    def set_num_codebooks(self, n: int) -> None:
        """Reference-API shim (``train.py:366``)."""
        self.num_codebooks = n

    @torch.no_grad()
    def encode(self, wave) -> np.ndarray:
        """``[T]`` float wave -> ``[num_codebooks, frames]`` int codes."""
        wave = np.asarray(wave, np.float32)
        if wave.ndim != 1:
            raise ValueError(f"expected mono [T] wave, got {wave.shape}")
        x = torch.from_numpy(wave).to(self.device)[None, None, :]
        return mimi_encode(self.config, self.params, x, self.num_codebooks)[0].cpu().numpy()

    @torch.no_grad()
    def encode_batch(self, waves: torch.Tensor) -> torch.Tensor:
        """``[B, 1, T]`` -> ``[B, num_codebooks, frames]`` on the device."""
        return mimi_encode(self.config, self.params, waves.to(self.device), self.num_codebooks)

    @torch.no_grad()
    def decode(self, codes) -> np.ndarray:
        """``[Q, frames]`` or ``[B, Q, frames]`` codes -> float wave."""
        c = torch.as_tensor(np.asarray(codes), device=self.device).long()
        if c.ndim == 2:
            return mimi_decode(self.config, self.params, c[None])[0, 0].cpu().numpy()
        return mimi_decode(self.config, self.params, c)[:, 0].cpu().numpy()


def load_mimi(path: Optional[str] = None, num_codebooks: int = 32,
              config: Optional[MimiCodecConfig] = None, device: DeviceLike = None) -> MimiCodec:
    """Mimi weights from a local safetensors file in the HF ``MimiModel`` key
    layout (or a directory holding ``model.safetensors``), from ``path`` or
    the ``CSM_TPU_MIMI_PATH`` environment variable; read with the port's own
    safetensors reader.  Nothing is downloaded: a missing file raises
    ``FileNotFoundError`` naming it."""
    from csm_tpu_torch.checkpoint.safetensors_io import load_file
    from csm_tpu_torch.codec.convert import mimi_params_from_state_dict

    cfg = config or MimiCodecConfig()
    if path is None:
        path = os.environ.get("CSM_TPU_MIMI_PATH")
    if path is None:
        raise FileNotFoundError(
            "Mimi weights not found: pass `path`, or set CSM_TPU_MIMI_PATH, to a "
            "safetensors file (or a directory with model.safetensors) in the HF "
            "MimiModel layout")
    if os.path.isdir(path):
        path = os.path.join(path, "model.safetensors")
    if not os.path.exists(path):
        raise FileNotFoundError(f"Mimi weights not found: {path} does not exist")
    params = mimi_params_from_state_dict(load_file(path), cfg)
    return MimiCodec(cfg, params, num_codebooks=num_codebooks, device=device)
