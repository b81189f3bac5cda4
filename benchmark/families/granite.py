"""The ``granite`` family: CSM with a Granite-4.0-H backbone (HF
``GraniteMoeHybrid`` without experts: Mamba-2 mixers beside position-free
GQA attention layers, μP multipliers) and CSM-1B's Llama decoder.  The
family module's parts are those ``families/csm.py`` lists, and
``ssm_work``: the bytes and operations of one launch of the port's mixer
step kernel, which the ``ssm_roofline`` metric reads.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import torch

from benchmark.families import csm as _csm
from benchmark.reference import granite as reference  # noqa: F401  (the family's reference)
from benchmark.shapes import is_norm, layer_params, leaves, stack_shapes

# The mixers' small parameters.  The published initialisation (Mamba-2's)
# draws, per head, dt log-uniform in [0.001, 0.1] (dt_bias its inverse
# softplus) and A uniform in [1, 16] (A_log = log A); these runs spread both
# evenly over those ranges, head by head in ascending order (head 0 the
# slowest, as the port's ``hybrid.init_params`` pairs them), the same in
# every layer.  ``weights.model_params`` fills a leaf with one constant, so
# :func:`mixer_constants` sets these two in place before anything reads the
# weights; D = 1, the conv bias 0, and the conv weights drawn N(0, 0.5) (the
# published init's uniform bound over four taps).  All stated in the
# configuration's ``assumed``.
DT_RANGE = (1e-3, 1e-1)
A_RANGE = (1.0, 16.0)
FILLS = {"A_log": 0.0, "dt_bias": 0.0, "D": 1.0, "conv_b": 0.0}
CONV_SCALE = 0.5

k2_work = _csm.k2_work  # the codebook loop is CSM-1B's


def config(model: dict):
    from csm_tpu_torch.config import CSMConfig

    return CSMConfig.from_dict(model)


def backbone_shapes(c) -> dict:
    """The hybrid backbone's parameters (the port's layout) under ``c``, a
    ``HybridConfig``."""
    Lm = sum(t == "mamba" for t in c.layer_types)
    La = len(c.layer_types) - Lm
    D, Fs, H = c.hidden_size, c.shared_intermediate_size, c.mamba_n_heads
    inner = c.mamba_expand * D
    C = inner + 2 * c.mamba_n_groups * c.mamba_d_state
    hd = D // c.num_attention_heads
    q, kv = c.num_attention_heads * hd, c.num_key_value_heads * hd
    return {
        "mamba": {"norm": (Lm, D), "in_proj": (Lm, D, inner + C + H),
                  "conv_w": (Lm, C, c.mamba_d_conv), "conv_b": (Lm, C), "dt_bias": (Lm, H),
                  "A_log": (Lm, H), "D": (Lm, H), "gate_norm": (Lm, inner),
                  "out_proj": (Lm, inner, D), "mlp_norm": (Lm, D), "w_gate": (Lm, D, Fs),
                  "w_up": (Lm, D, Fs), "w_down": (Lm, Fs, D)},
        "attn": {"attn_norm": (La, D), "wq": (La, D, q), "wk": (La, D, kv), "wv": (La, D, kv),
                 "wo": (La, q, D), "mlp_norm": (La, D), "w_gate": (La, D, Fs),
                 "w_up": (La, D, Fs), "w_down": (La, Fs, D)},
        "final_norm": (D,),
    }


def model_shapes(cfg) -> dict:
    D, Dd, Va = cfg.backbone.hidden_size, cfg.decoder.hidden_size, cfg.audio_vocab_size
    return {"backbone": backbone_shapes(cfg.backbone), "decoder": stack_shapes(cfg.decoder),
            "text_embeddings": (cfg.text_vocab_size, D),
            "audio_embeddings": (cfg.audio_vocab_size * cfg.audio_num_codebooks, D),
            "projection": (D, Dd), "codebook0_head": (D, Va),
            "audio_head": (cfg.audio_num_codebooks - 1, Dd, Va)}


def shapes(cfg) -> list:
    """Linear and embedding weights ``N(0, 0.02)``, conv weights ``N(0,
    0.5)``, norms 1 and the mixers' fills (:data:`FILLS`; ``dt_bias`` and
    ``A_log`` until :func:`mixer_constants` sets them), in sorted path
    order."""
    out = []
    for p, s in leaves(model_shapes(cfg)):
        name = p.rsplit(".", 1)[-1]
        if name in FILLS:
            out.append((p, s, None, FILLS[name]))
        elif is_norm(p):
            out.append((p, s, None, 1.0))
        else:
            out.append((p, s, CONV_SCALE if name == "conv_w" else 0.02, 0.0))
    return out


def head_constants(H: int):
    """``(dt_bias [H], A_log [H])`` in float64: dt spaced evenly in log over
    :data:`DT_RANGE`, A evenly over :data:`A_RANGE`, both ascending."""
    dt = torch.exp(torch.linspace(math.log(DT_RANGE[0]), math.log(DT_RANGE[1]), H,
                                  dtype=torch.float64))
    a = torch.linspace(A_RANGE[0], A_RANGE[1], H, dtype=torch.float64)
    return dt + torch.log(-torch.expm1(-dt)), torch.log(a)


def mixer_constants(params, cfg) -> None:
    """In place: every mixer's ``dt_bias`` and ``A_log`` per head
    (:func:`head_constants`), in the weights' dtype."""
    mp = params["backbone"]["mamba"]
    for name, v in zip(("dt_bias", "A_log"), head_constants(cfg.backbone.mamba_n_heads)):
        mp[name].copy_(v.to(mp[name].dtype).expand_as(mp[name]))


def bundles(params, cfg, tier: str) -> dict:
    """The mixers' per-head constants set in ``params`` (:func:`mixer_constants`,
    before the server or the reference reads them); then ``bf16``: the
    backbone at the param precision (its prefill and its steps through the
    mixer step kernel) and the fused int8 codebook loop with a bf16 head
    (K2, CSM-1B's ``head_bits=16`` bundle)."""
    from csm_tpu_torch.ops.fused_decoder import prepare_fused_decoder

    mixer_constants(params, cfg)
    if tier == "bf16":
        return dict(qdec=prepare_fused_decoder(params, cfg, head_bits=16), specdec=False)
    raise ValueError(f"unknown tier {tier!r}")


# ---------------------------------------------------------------------------
# Model FLOPs and the kernel's work, from shapes
# ---------------------------------------------------------------------------


def backbone_layer_params(c) -> int:
    """Parameters of the backbone's layers, norms and the mixers' small
    parameters included."""
    return sum(math.prod(s) for _, s in leaves({k: v for k, v in backbone_shapes(c).items()
                                                if k != "final_norm"}))


def _n_layers(c):
    Lm = sum(t == "mamba" for t in c.layer_types)
    return Lm, len(c.layer_types) - Lm


def scan_flops(c) -> float:
    """FLOPs of one position of every mixer's recurrence: per state element
    the decay's product, the input's multiply-add and the output's
    multiply-add (5)."""
    Lm, _ = _n_layers(c)
    return 5.0 * Lm * c.mamba_n_heads * c.mamba_d_head * c.mamba_d_state


def _attn_per_key(c) -> float:
    """FLOPs of one (query, key) pair over the attention layers: q·k and p·v."""
    _, La = _n_layers(c)
    return 4.0 * (c.hidden_size // c.num_attention_heads) * c.num_attention_heads * La


def prefill_flops(cfg, S: int, keys: int = None) -> float:
    """Model FLOPs of one prefill of ``S`` positions: 2·N·S over the
    backbone layers' parameters, the scan at every position, causal attention
    in the attention layers; ``keys``: the positions attended in all (a
    continuation of a cached prefix)."""
    c = cfg.backbone
    f = (2.0 * backbone_layer_params(c) + scan_flops(c)) * S + _attn_per_key(c) * S * S / 2
    if keys is not None and keys > S:
        f += _attn_per_key(c) * S * (keys - S)
    return f


def frame_flops(cfg, context: int) -> float:
    """Model FLOPs of one generated frame of one stream whose backbone step
    attends ``context`` keys: the backbone layers, one scan step, the c0 head
    and the projection once; the decoder as CSM-1B's (31 passes, its head,
    the projection of a codebook embedding, attention over the frame's
    codebook positions)."""
    c, dc = cfg.backbone, cfg.decoder
    D, Dd, Va = c.hidden_size, dc.hidden_size, cfg.audio_vocab_size
    f = 2.0 * (backbone_layer_params(c) + D * Va + D * Dd) + scan_flops(c)
    f += _attn_per_key(c) * context
    Ld, nqd = dc.num_hidden_layers, dc.num_attention_heads
    hdd = dc.hidden_size // nqd
    passes = cfg.audio_num_codebooks - 1
    f += passes * 2.0 * (layer_params(dc) + Dd * Va + D * Dd)
    f += sum(4 * hdd * nqd * Ld * (p + 1) for p in range(passes + 1))
    return f


def request_flops(cfg, S: int, frames: int, prefix: int = 0) -> float:
    """Model FLOPs of a request's prefill of ``S`` positions (its last
    position is the first frame's backbone pass) and ``frames`` frames, as
    ``families/csm.py`` counts them."""
    if frames == 0:
        return 0.0
    c = cfg.backbone
    bb_pass = 2.0 * backbone_layer_params(c) + scan_flops(c)
    f = prefill_flops(cfg, S, prefix + S) - bb_pass
    return f + sum(frame_flops(cfg, prefix + S + j) for j in range(frames))


def ssm_work(cfg, B: int):
    """``(bytes, flops)`` of one launch of the mixer step kernel at batch
    ``B``, all in bf16 (the served weights' dtype, which the port's states
    take) but the output: each stream's recurrent state read and written
    once, its ``in_proj`` output row and conv state (read and written) once,
    the layer's conv weights and bias and per-head parameters once, the
    gated output (f32) written once; the state update and output (5 FLOPs a
    state element) and the conv's four multiply-adds a channel."""
    c = cfg.backbone
    H, P, N, G = c.mamba_n_heads, c.mamba_d_head, c.mamba_d_state, c.mamba_n_groups
    inner = c.mamba_expand * c.hidden_size
    C = inner + 2 * G * N
    K = c.mamba_d_conv
    n_bytes = (2 * B * H * P * N * 2 + 2 * B * (inner + C + H) + 2 * 2 * B * (K - 1) * C
               + 2 * (C * K + C + 3 * H) + 4 * B * inner)
    n_flops = 5 * B * H * P * N + 2 * K * B * C
    return n_bytes, n_flops


def tiny(conf: dict) -> dict:
    """The configuration on ``CSMConfig.tiny_hybrid()`` and
    ``MimiCodecConfig.tiny()``, with ``embedding_multiplier`` and
    ``logits_scaling`` 1: at the twin's 64-wide hidden the published 12 and
    8 leave its c0 logits flat and ruled by the current frame's embedding
    (its layers add a sixth of it), so a fault in the recurrent state or
    the prefix would move no checked number."""
    from csm_tpu_torch.codec.mimi import MimiCodecConfig
    from csm_tpu_torch.config import CSMConfig, HybridConfig

    conf = copy.deepcopy(conf)
    conf["model"] = CSMConfig.tiny_hybrid(
        max_seq_len=256, backbone=HybridConfig.tiny(embedding_multiplier=1.0,
                                                     logits_scaling=1.0)).to_dict()
    codec = dataclasses.asdict(MimiCodecConfig.tiny(num_quantizers=32))
    codec["upsampling_ratios"] = list(codec["upsampling_ratios"])
    conf["codec"] = codec
    return conf
