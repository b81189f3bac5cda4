"""The ``csm`` family: Sesame's CSM with a Llama backbone and a Llama
decoder, what a configuration without a ``"family"`` key runs.

A family module gives the drivers and the weight maker all that depends on
the model's kind:

- ``config(model)``: the port's config object from the configuration's
  ``model`` dict;
- ``shapes(cfg)``: every parameter in the port's layout, in draw order, as
  ``(path, shape, scale or None, const)``: a drawn leaf is ``N(0, scale)``,
  a leaf with no scale is filled with ``const``;
- ``bundles(params, cfg, tier)``: the ``CSMServer`` keyword arguments of a
  served tier (the tier names are the family's);
- ``reference``: the plain reference module (``serve_weights``,
  ``served_logits``, ``lower_precision``, ``controls``,
  ``control_weights``; ``train_steps``, ``train_loss``, ``bf16_round``
  where the family trains);
- ``prefill_flops``, ``frame_flops``, ``request_flops`` and
  ``train_sequence_flops``: the model FLOPs, from shapes;
- ``k2_work``, ``bb_work`` and ``flash_train_work``: the ``(bytes, flops)``
  of one launch of each of the port's kernels that a roofline metric reads
  (``trace.Launches``, the train driver), from shapes;
- ``tiny(conf)``: the configuration's CPU twin for the tests.
"""

from __future__ import annotations

import copy
import dataclasses

from benchmark.reference import csm as reference  # noqa: F401  (the family's reference)
from benchmark.shapes import csm_shapes, is_norm, layer_params, leaves


def config(model: dict):
    from csm_tpu_torch.config import CSMConfig

    return CSMConfig.from_dict(model)


def shapes(cfg) -> list:
    """Linear and embedding weights ``N(0, 0.02)`` and norms 1, as the
    port's ``init_params``, in sorted path order."""
    return [(p, s, None if is_norm(p) else 0.02, 1.0) for p, s in leaves(csm_shapes(cfg))]


def bundles(params, cfg, tier: str) -> dict:
    """The configuration's tier and nothing more: ``int4`` is what
    ``CSMModel.quantize(bits=4)`` serves (the int4 backbone step and the fused
    int8 codebook loop with a bf16 head; no W8A16 bundle, which only batches
    above 32 use), ``exact`` what ``CSMModel.exact()`` serves."""
    from csm_tpu_torch.ops.bb_kernel import prepare_streamed_backbone
    from csm_tpu_torch.ops.fused_decoder import prepare_fused_decoder

    if tier == "int4":
        return dict(qsb=prepare_streamed_backbone(params, cfg, bits=4),
                    qdec=prepare_fused_decoder(params, cfg, head_bits=16), specdec=False)
    if tier == "exact":
        return dict(qsb=prepare_streamed_backbone(params, cfg, bits=16),
                    qdec=prepare_fused_decoder(params, cfg, head_bits=8), specdec=True)
    raise ValueError(f"unknown tier {tier!r}")


def request_flops(cfg, S: int, frames: int, prefix: int = 0) -> float:
    """Model FLOPs of a request's prefill of ``S`` positions and ``frames``
    frames: the prefill (whose last position is the first frame's backbone
    pass), attending also the ``prefix`` positions of a cached prefix, then
    each frame's work, frame ``j`` attending ``prefix + S + j`` keys.  The
    prefix's own prefill is not counted."""
    if frames == 0:
        return 0.0
    bb_pass = 2.0 * layer_params(cfg.backbone)
    f = prefill_flops(cfg, S, prefix + S) - bb_pass
    return f + sum(frame_flops(cfg, prefix + S + j) for j in range(frames))


def tiny(conf: dict) -> dict:
    """The configuration on ``CSMConfig.tiny()`` and ``MimiCodecConfig.tiny()``."""
    from csm_tpu_torch.codec.mimi import MimiCodecConfig
    from csm_tpu_torch.config import CSMConfig

    conf = copy.deepcopy(conf)
    conf["model"] = CSMConfig.tiny(max_seq_len=256).to_dict()
    codec = dataclasses.asdict(MimiCodecConfig.tiny(num_quantizers=32))
    codec["upsampling_ratios"] = list(codec["upsampling_ratios"])
    conf["codec"] = codec
    return conf


# What the kernels and frames need, from shapes alone: copied from
# ``chip_smoke.py`` (``fused_bound`` and the K1 / K1q / flash byte and operation
# counts) and ``csm_tpu_torch/utils/measure.py`` (``prefill_flops``).  Bytes:
# each input byte read once, each output byte written once.


def _stack(c):
    hd = c.hidden_size // c.num_attention_heads
    return (c.num_hidden_layers, c.hidden_size, c.intermediate_size, c.num_attention_heads,
            c.num_key_value_heads, hd)


def _family_cols(c):
    """Columns of the four weight families (``wqkv``, ``wo``, ``w_gu``,
    ``w_down``) and the rows each reads."""
    L, D, F, nq, nkv, hd = _stack(c)
    return {"wqkv": (D, (nq + 2 * nkv) * hd), "wo": (nq * hd, D), "w_gu": (D, 2 * F),
            "w_down": (F, D)}


def k2_work(cfg, B: int, head_bits: int = 16):
    """``(bytes, flops)`` of one launch of K2, the fused codebook loop
    (``chip_smoke.fused_bound``): 31 passes over the int8 decoder weights and
    their f32 scales, 31 head slices at their Va real columns (bf16, or int8
    with f32 scales), the embedding rows the draws fetch (bf16), the noise
    and the other inputs and outputs once."""
    dc = cfg.decoder
    L = dc.num_hidden_layers
    N, Va, Dd = cfg.audio_num_codebooks, cfg.audio_vocab_size, dc.hidden_size
    passes = N - 1
    fam = _family_cols(dc)
    elems = L * sum(k * n for k, n in fam.values())
    scales = 4 * L * sum(n for _, n in fam.values())
    w_bytes = passes * (elems + scales)
    h_bytes = passes * Dd * Va * (1 if head_bits == 8 else 2) + (passes * Va * 4 if head_bits == 8
                                                                 else 0)
    emb_bytes = passes * B * Dd * 2
    io_bytes = 4 * (N * B * Va + B * Va + B * Dd + 2 * B) + 8 * B * N
    n_flops = 2 * B * passes * (elems + Dd * Va)
    return w_bytes + h_bytes + emb_bytes + io_bytes, n_flops


def bb_work(cfg, B: int, W: int, usable: int, bits: int):
    """``(bytes, flops)`` of one backbone decode step (K1 at ``bits=16``,
    K1q-8 / K1q-4 at 8 / 4), ``chip_smoke.check_bb`` / ``check_bbq``: every
    weight once at the tier's precision (int4: two a byte, f32 column
    scales and row equilibration; int8: f32 column scales; bf16: f32 norm
    weights), the c0 head at its Va real columns (bf16, or int8 with f32
    scales), the bf16 K/V of the ``usable`` window slots (summed over the
    batch) the bias lets attention read, and the step's inputs (embedded
    frame, RoPE rows, the ``[B, W]`` bias) and outputs (normed hidden, c0
    logits, new K/V rows)."""
    bc = cfg.backbone
    L, D, F, nq, nkv, hd = _stack(bc)
    Va = cfg.audio_vocab_size
    fam = _family_cols(bc)
    elems = L * sum(k * n for k, n in fam.values())
    if bits == 16:
        w_bytes = 2 * elems + 4 * (2 * L * D + D) + 2 * D * Va
    else:
        w_bytes = elems * bits // 8 + 4 * L * sum(n for _, n in fam.values()) + 4 * D
        if bits == 4:
            w_bytes += 4 * L * sum(k for k, _ in fam.values())
        w_bytes += D * Va + 4 * Va
    kv_bytes = 2 * L * usable * nkv * hd * 2
    io_bytes = 4 * B * (D + 2 * hd + W + D + Va) + 2 * 2 * L * B * nkv * hd
    n_flops = 2 * B * (elems + D * Va) + 4 * hd * nq * L * (usable + B)
    return w_bytes + kv_bytes + io_bytes, n_flops


def flash_train_work(cfg, B: int, S: int):
    """``{"fwd", "dq", "dkv"}`` of ``(bytes, flops)`` for K3 with its
    log-sum-exp, K5a and K5b on a causal bf16 batch with every frame valid
    (``chip_smoke.check_flash_bwd``): each live (row, key <= row) pair per
    head; q, dO and out of live rows, k and v of valid keys, lse and delta
    of live rows, the validity flags (int32), the outputs whole."""
    L, D, F, nq, nkv, hd = _stack(cfg.backbone)
    pairs = B * S * (S + 1) // 2
    q_rows = B * S * nq * hd * 2
    kv_rows = B * S * nkv * hd * 2
    stats = B * S * nq * 4
    flags = B * S * 4
    return {
        "fwd": (q_rows + 2 * kv_rows + flags + q_rows + stats, 4 * hd * nq * pairs),
        "dq": (2 * q_rows + 2 * kv_rows + 2 * stats + flags + q_rows, 6 * hd * nq * pairs),
        "dkv": (2 * q_rows + 2 * kv_rows + 2 * stats + flags + 2 * kv_rows, 8 * hd * nq * pairs),
    }


def _attn_fwd(c, S: int) -> float:
    """Causal attention's forward FLOPs over ``S`` positions: qk and pv over
    the causal half-square, every layer (``prefill_flops``)."""
    L, D, F, nq, nkv, hd = _stack(c)
    return 2 * 2 * S * S * nq * hd * L / 2


def prefill_flops(cfg, S: int, keys: int = None) -> float:
    """Model FLOPs of one prefill of ``S`` positions
    (``utils/measure.prefill_flops``): 2·N·S over the backbone layers'
    parameters, norms included, plus causal attention.  ``keys`` (a prefill
    that continues a cached prefix): the positions attended in all, so each
    position also attends the ``keys - S`` cached ones."""
    f = 2.0 * layer_params(cfg.backbone) * S + _attn_fwd(cfg.backbone, S)
    if keys is not None and keys > S:
        L, D, F, nq, nkv, hd = _stack(cfg.backbone)
        f += 2 * 2 * S * (keys - S) * nq * hd * L
    return f


def frame_flops(cfg, context: int) -> float:
    """Model FLOPs of one generated frame of one stream whose backbone step
    attends ``context`` keys: the backbone layers, the c0 head and the
    projection once; the decoder layers, its head and the projection of a
    codebook embedding 31 times; attention over the live context in the
    backbone and over the frame's codebook positions in the decoder.  Counted
    the same whatever precision the weights are stored in."""
    bc, dc = cfg.backbone, cfg.decoder
    D, Dd, Va = bc.hidden_size, dc.hidden_size, cfg.audio_vocab_size
    L, _, _, nq, _, hd = _stack(bc)
    Ld, _, _, nqd, _, hdd = _stack(dc)
    passes = cfg.audio_num_codebooks - 1
    f = 2.0 * (layer_params(bc) + D * Va + D * Dd) + 4 * hd * nq * L * context
    f += passes * 2.0 * (layer_params(dc) + Dd * Va + D * Dd)
    f += sum(4 * hdd * nqd * Ld * (p + 1) for p in range(passes + 1))
    return f


def train_sequence_flops(cfg, S: int, n_decoder_frames: int) -> float:
    """Model FLOPs of one training sequence (forward and backward, 3x the
    forward): the backbone as the prefill counts it plus the c0 head at every
    position, and the decoder over ``n_decoder_frames`` frames of 33
    positions (layers, the 33 inputs' projection, 31 head slices, causal
    attention).  Recomputation is not counted."""
    bc, dc = cfg.backbone, cfg.decoder
    D, Dd, Va = bc.hidden_size, dc.hidden_size, cfg.audio_vocab_size
    P = cfg.audio_num_codebooks + 1
    fwd = prefill_flops(cfg, S) + 2.0 * D * Va * S
    fwd += n_decoder_frames * (2.0 * (layer_params(dc) + D * Dd) * P
                               + 2.0 * Dd * Va * (cfg.audio_num_codebooks - 1)
                               + _attn_fwd(dc, P))
    return 3.0 * fwd
