"""The yardstick: the card's peaks, each kernel's least time (its roofline
bound) from the bytes and operations its data needs, and the model FLOPs of
a generated frame, a prefill and a training sequence.

Copied from ``chip_smoke.py`` (``bound_ms``, ``fused_bound`` and the K1 /
K1q / flash byte and operation counts) and ``csm_tpu_torch/utils/measure.py``
(``prefill_flops``), and computed from shapes alone, so later changes to the
program cannot move it.  Bytes: each input byte read once, each output byte
written once; operations at the bf16 tensor-core rate.
"""

from __future__ import annotations

from benchmark.shapes import layer_params

# NVIDIA H100 SXM data sheet (dense, no sparsity), at its full 700 W.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def bound_s(n_bytes: float, n_flops: float, dtype: str = "bfloat16") -> float:
    """The least time of a call: the larger of its bytes over the memory's
    bandwidth and its operations over the peak rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / PEAK_FLOPS[dtype])


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


def prefill_flops(cfg, S: int) -> float:
    """Model FLOPs of one prefill (``utils/measure.prefill_flops``): 2·N·S
    over the backbone layers' parameters, norms included, plus causal
    attention."""
    return 2.0 * layer_params(cfg.backbone) * S + _attn_fwd(cfg.backbone, S)


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
