"""CSM model assembly: embeddings, heads, forward pass and training losses
(counterpart of ``csm_tpu/models/csm.py``).

- Separate text ``[text_vocab, D]`` and shared audio ``[32*2051, D]``
  embedding tables with the ``codebook * audio_vocab_size`` offset
  (``modeling_csm.py:222-225, 247-259``).
- Frame embedding = mask-weighted **sum** of the 33 token embeddings.
- Backbone loss: shifted CE on codebook-0 labels, fp32.
- Decoder loss: frames whose 32 audio labels are all present, conditioned on
  the backbone hidden at **t-1** (a valid frame at t=0 wraps to S-1, as the
  reference's negative indexing does), run through the decoder as
  ``[hidden; cb0..cb31]``, classified per codebook with ``audio_head`` and
  averaged over non-ignored targets.  The frame gather is padded/truncated
  to a static ``max_decoder_frames`` with zero-weight slots.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from csm_tpu_torch.config import CSMConfig
from csm_tpu_torch.models import llama
from csm_tpu_torch.models.llama import NEG_INF, KVCache, write_rows
from csm_tpu_torch.ops.attention import flash_eligible
from csm_tpu_torch.ops.rope import compute_rope_table, gather_rope


@dataclasses.dataclass
class CSMOutput:
    """Result structure mirroring the reference ``CSMOutput``."""

    last_hidden_state: Optional[torch.Tensor] = None  # [B, D] final position
    logits: Optional[torch.Tensor] = None  # [B, audio_vocab] c0 logits
    cache: Optional[KVCache] = None
    samples: Optional[torch.Tensor] = None  # [B, 32] from generate_frame
    loss: Optional[torch.Tensor] = None
    backbone_loss: Optional[torch.Tensor] = None
    decoder_loss: Optional[torch.Tensor] = None
    backbone_targets: Optional[torch.Tensor] = None
    decoder_targets: Optional[torch.Tensor] = None


def init_params(config: CSMConfig, seed: int = 0, dtype=torch.float32, device=None) -> dict:
    """Random parameters from ``seed``: linear/embedding weights
    ``N(0, 0.02)``, input-major linear weights, ``audio_head`` in the
    reference layout ``[num_codebooks-1, decoder_dim, audio_vocab]``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    D, Dd, Va = config.backbone.hidden_size, config.decoder.hidden_size, config.audio_vocab_size

    def normal(shape):
        return llama.normal_(shape, gen, device, dtype)

    return {
        "backbone": llama.init_params(config.backbone, gen, device, dtype),
        "decoder": llama.init_params(config.decoder, gen, device, dtype),
        "text_embeddings": normal((config.text_vocab_size, D)),
        "audio_embeddings": normal((config.audio_embedding_rows, D)),
        "projection": normal((D, Dd)),
        "codebook0_head": normal((D, Va)),
        "audio_head": normal((config.audio_num_codebooks - 1, Dd, Va)),
    }


def embed_audio(params: dict, config: CSMConfig, codebook: int, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding of one codebook's tokens, offset by ``codebook * audio_vocab``."""
    return params["audio_embeddings"][tokens.long() + codebook * config.audio_vocab_size]


def embed_frames(
    params: dict,
    config: CSMConfig,
    input_ids: torch.Tensor,  # [B, S, 33]
    attention_mask: Optional[torch.Tensor],  # [B, S, 33] or None
) -> torch.Tensor:
    """33-way masked embedding sum -> ``[B, S, D]`` (audio and text parts
    reduced separately, then added)."""
    N = config.audio_num_codebooks
    ids = input_ids.long()
    offsets = torch.arange(N, device=ids.device) * config.audio_vocab_size
    audio_emb = params["audio_embeddings"][ids[..., :N] + offsets]  # [B,S,N,D]
    text_emb = params["text_embeddings"][ids[..., N]]  # [B,S,D]
    if attention_mask is None:
        return audio_emb.sum(dim=2) + text_emb
    m = attention_mask.to(audio_emb.dtype)
    audio_sum = torch.einsum("bsnd,bsn->bsd", audio_emb, m[..., :N])
    return audio_sum + text_emb * m[..., N, None]


def _masked_ce(
    logits: torch.Tensor,  # [N, V]
    targets: torch.Tensor,  # [N], -100 = ignore
    weight: Optional[torch.Tensor] = None,  # [N] extra 0/1 weight
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean fp32 cross-entropy over non-ignored targets; 0.0 (not NaN) when
    there is none.  Returns ``(loss, count)``."""
    valid = targets != -100
    if weight is not None:
        valid = valid & (weight > 0)
    safe = torch.where(valid, targets, torch.zeros_like(targets)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, safe[:, None])[:, 0]
    n = valid.sum()
    total = torch.where(valid, nll, torch.zeros_like(nll)).sum()
    loss = torch.where(n > 0, total / n.clamp(min=1), torch.zeros_like(total))
    return loss, n


def _select_decoder_frames(valid: torch.Tensor, max_frames: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat indices of up to ``max_frames`` valid frames, earliest first;
    padded slots get weight 0."""
    flat = valid.reshape(-1)
    n = flat.shape[0]
    key = torch.where(flat, 0, n) + torch.arange(n, device=flat.device)
    idx = torch.argsort(key)[:max_frames]
    return idx, flat[idx]


def backbone_forward(
    params: dict,
    config: CSMConfig,
    input_ids: torch.Tensor,  # [B, S, 33]
    attention_mask: Optional[torch.Tensor],
    *,
    cache: Optional[KVCache] = None,
    flash_prefill: bool = False,
    qbb: Optional[dict] = None,
    use_flash: bool = True,
    remat: bool = False,
    remat_policy: str = "nothing",
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Embed-sum + backbone stack -> hidden ``[B, S, D]``.

    Frame validity is ``any(mask) > 0`` over the 33 tokens.  Positions are
    sequential frame indices from the cache index (left padding is
    numbered, then masked out of attention).  ``flash_prefill``: the cached call is a
    prefill at cache index 0, so eligible shapes take the flash kernel.
    ``qbb``: int8 layer weights (:mod:`csm_tpu_torch.ops.quant`) for W8A16
    products.  ``use_flash=False`` forces the plain attention path of the
    uncached pass; ``remat`` / ``remat_policy`` checkpoint its layers
    (:func:`csm_tpu_torch.models.llama.forward`)."""
    B, S, _ = input_ids.shape
    dev = input_ids.device
    bcfg = config.backbone
    h = embed_frames(params, config, input_ids, attention_mask)
    if attention_mask is not None:
        frame_valid = attention_mask.sum(dim=-1) > 0
    else:
        frame_valid = torch.ones((B, S), dtype=torch.bool, device=dev)
    rope = compute_rope_table(bcfg, config.max_seq_len, dev)
    weight = params["backbone"]["layers"]["wq"]

    if cache is None:
        positions = torch.arange(S, device=dev).expand(B, S)
        if use_flash and flash_eligible(S, bcfg, weight):
            bias, flash_valid = None, frame_valid
        else:
            bias, flash_valid = llama.make_causal_bias(frame_valid, S), None
        hidden, _ = llama.forward(
            params["backbone"], bcfg, h, rope_table=rope, positions=positions,
            attn_bias=bias, flash_key_valid=flash_valid, qlayers=qbb, remat=remat,
            remat_policy=remat_policy,
        )
        return hidden, None

    # Cached path: record this chunk's validity in the window (in place),
    # then attend over the whole static window.
    start = cache.index
    base = torch.as_tensor(start, device=dev).reshape(-1, 1)
    positions = (base + torch.arange(S, device=dev)).expand(B, S)
    write_rows(cache.valid, frame_valid, start)
    if flash_prefill and flash_eligible(S, bcfg, weight):
        bias, flash_valid = None, cache.valid
    else:
        bias, flash_valid = llama.make_causal_bias(cache.valid, S, q_offset=start), None
    return llama.forward(
        params["backbone"], bcfg, h, rope_table=rope, positions=positions,
        attn_bias=bias, cache=cache, flash_key_valid=flash_valid, qlayers=qbb,
    )


def decoder_forward_full(params: dict, config: CSMConfig, decoder_inputs: torch.Tensor) -> torch.Tensor:
    """Uncached decoder on ``[F, 33, Dd]`` inputs, positions 0..32."""
    rope = compute_rope_table(config.decoder, config.decoder_rope_positions, decoder_inputs.device)
    return llama.forward_uncached(params["decoder"], config.decoder, decoder_inputs, rope_table=rope)


def forward_decode_streamed(
    params: dict,
    qsb: dict,
    config: CSMConfig,
    input_ids: torch.Tensor,  # [B, 1, 33]
    attention_mask: Optional[torch.Tensor],
    cache: KVCache,
) -> CSMOutput:
    """One-frame decode step through a backbone kernel
    (:func:`csm_tpu_torch.ops.bb_kernel.bb_decode_step`, exact, int8 or int4
    by the bundle): embed-sum, then 16 layers + final norm + c0 head in the
    kernel, which returns the new K/V rows; they are scattered into the
    cache here, in place."""
    from csm_tpu_torch.ops.bb_kernel import bb_decode_step

    B = input_ids.shape[0]
    dev = input_ids.device
    h0 = embed_frames(params, config, input_ids, attention_mask)[:, 0, :]
    start = cache.index
    W = cache.max_len
    starts = torch.as_tensor(start, device=dev).long().expand(B)
    # Clipped positions: a finished stream that keeps stepping past the
    # table stays finite.
    cos, sin = gather_rope(compute_rope_table(config.backbone, config.max_seq_len, dev), starts)
    bias_w = torch.where(cache.valid, 0.0, NEG_INF).float()

    nh, c0_logits, nk, nv = bb_decode_step(qsb, config, h0.float(), cos, sin, bias_w, cache.k, cache.v)

    if isinstance(start, int):
        s = min(max(start, 0), W - 1)
        cache.k[:, :, s] = nk.to(cache.k.dtype)
        cache.v[:, :, s] = nv.to(cache.v.dtype)
    else:
        b = torch.arange(B, device=dev)
        s = starts.clamp(0, W - 1)
        cache.k[:, b, s] = nk.to(cache.k.dtype)
        cache.v[:, b, s] = nv.to(cache.v.dtype)
    # A frame whose 33-wide mask is all zero is recorded invalid, as on the
    # plain path.
    if attention_mask is not None:
        one = (attention_mask.sum(dim=2) > 0).reshape(B, 1)
    else:
        one = torch.ones((B, 1), dtype=torch.bool, device=dev)
    write_rows(cache.valid, one, start)
    return CSMOutput(
        last_hidden_state=nh.to(params["projection"].dtype),
        logits=c0_logits,
        cache=dataclasses.replace(cache, index=start + 1),
    )


def forward(
    params: dict,
    config: CSMConfig,
    input_ids: torch.Tensor,  # [B, S, 33]
    attention_mask: Optional[torch.Tensor] = None,
    labels: Optional[torch.Tensor] = None,  # [B, S, 33], -100 = ignore
    *,
    cache: Optional[KVCache] = None,
    max_decoder_frames: Optional[int] = None,
    return_all_logits: bool = False,
    last_index: Optional[int] = None,
    flash_prefill: bool = False,
    qbb: Optional[dict] = None,
    qsb: Optional[dict] = None,
    use_flash: bool = True,
    remat: bool = False,
    remat_policy: str = "nothing",
) -> CSMOutput:
    """Full forward with optional training losses.

    ``last_index``: the position reported as the "final" hidden/logits (the
    last real frame of a right-padded prompt); defaults to the last row.
    ``qsb``: a :func:`~csm_tpu_torch.ops.bb_kernel.prepare_streamed_backbone`
    bundle; single-frame cached steps of up to its tier's cap
    (``MAX_VALIDATED_B_EXACT`` for the exact bundle, ``MAX_VALIDATED_B`` for
    the int8 and int4 ones) then go through that tier's backbone kernel.  ``qbb``: int8
    layer weights for the plain backbone's W8A16 products.  ``use_flash``,
    ``remat``, ``remat_policy``: see :func:`backbone_forward` (the training
    step sets them)."""
    from csm_tpu_torch.ops.bb_kernel import MAX_VALIDATED_B, MAX_VALIDATED_B_EXACT

    B, S, _ = input_ids.shape
    N = config.audio_num_codebooks
    Va = config.audio_vocab_size
    if (
        qsb is not None and cache is not None and S == 1
        and B <= (MAX_VALIDATED_B if "s" in qsb else MAX_VALIDATED_B_EXACT)
        and labels is None and not return_all_logits
    ):
        return forward_decode_streamed(params, qsb, config, input_ids, attention_mask, cache)

    hidden, new_cache = backbone_forward(
        params, config, input_ids, attention_mask, cache=cache,
        flash_prefill=flash_prefill, qbb=qbb, use_flash=use_flash, remat=remat,
        remat_policy=remat_policy,
    )
    head = params["codebook0_head"]
    last_h = hidden[:, -1, :] if last_index is None else hidden[:, last_index, :]
    c0_logits_last = last_h @ head

    loss = backbone_loss = decoder_loss = None
    backbone_targets = decoder_targets = None
    c0_all = hidden @ head if (labels is not None or return_all_logits) else None

    if labels is not None:
        labels = labels.long()
        backbone_loss, backbone_targets = _masked_ce(
            c0_all[:, :-1, :].reshape(-1, Va), labels[:, 1:, 0].reshape(-1)
        )
        if max_decoder_frames is None:
            max_decoder_frames = B * S
        audio_labels = labels[..., :N]
        valid = (audio_labels != -100).all(dim=-1)  # [B, S]
        idx, weight = _select_decoder_frames(valid, max_decoder_frames)
        b_idx, t_idx = idx // S, idx % S
        # Hidden at t-1 predicted frame t; t=0 wraps to S-1 as the
        # reference's negative index does.
        prev_h = hidden[b_idx, (t_idx - 1) % S]
        frame_codebooks = input_ids[b_idx, t_idx, :N].long()
        frame_labels = audio_labels[b_idx, t_idx]
        proj = params["projection"]
        offsets = torch.arange(N, device=idx.device) * Va
        cb_emb = params["audio_embeddings"][frame_codebooks + offsets]  # [F, N, D]
        dec_in = torch.cat([(prev_h @ proj)[:, None, :], cb_emb @ proj], dim=1)
        dec_hidden = decoder_forward_full(params, config, dec_in)
        cb_logits = torch.einsum(
            "fcd,cdv->fcv", dec_hidden[:, 1:N, :].float(), params["audio_head"].float()
        )
        targets = frame_labels[:, 1:]
        w = weight[:, None].expand_as(targets)
        decoder_loss, decoder_targets = _masked_ce(
            cb_logits.reshape(-1, Va), targets.reshape(-1), w.reshape(-1)
        )
        loss = backbone_loss + decoder_loss

    return CSMOutput(
        last_hidden_state=last_h,
        logits=c0_all if return_all_logits else c0_logits_last,
        cache=new_cache,
        loss=loss,
        backbone_loss=backbone_loss,
        decoder_loss=decoder_loss,
        backbone_targets=backbone_targets,
        decoder_targets=decoder_targets,
    )
