"""The exact tier's speculative codebook loop (counterpart of
``csm_tpu/ops/specdec.py``): the int8 fused kernel drafts all codebooks of a
frame, one teacher-forced pass of the plain decoder in the param dtype
verifies them, and the frame is re-drafted with the verified prefix forced
until every codebook is verified.

The verify pass computes, at every position ``i``, the plain decoder's
logits given the draft prefix ``< i`` and draws from them with the frame's
noise row ``i``; for a verified prefix that is the plain loop's own state.
The first mismatch ``m`` yields the exact token at ``m``, so each round
extends the verified prefix by at least one, at most 31 rounds run, and the
output is the verify pass's alone.  Equality with the incremental plain loop
then rests on the teacher-forced ``T = N`` pass and the ``T = 1`` steps
rounding alike, which the CPU tests check; on the card the contract is the
fixed point: ``verify_codebooks(output) == output``.
"""

from __future__ import annotations

from typing import Optional

import torch

from csm_tpu_torch.config import CSMConfig
from csm_tpu_torch.models import llama
from csm_tpu_torch.ops.fused_decoder import (
    bf16_round, decode_frame_fused, row_params, sample_row,
)
from csm_tpu_torch.ops.rope import compute_rope_table
from csm_tpu_torch.utils.profiling import span

# Largest batch the speculative tier serves (the JAX package's cap); larger
# batches take the plain loop in generation.decode_frame, equally exact.
MAX_SPECDEC_B = 8


def verify_codebooks(
    params: dict,
    config: CSMConfig,
    last_h: torch.Tensor,  # [B, D] backbone hidden
    tokens: torch.Tensor,  # [B, N] draft; column 0 (c0) is exact already
    gumbel: torch.Tensor,  # [N, B, Va]: the frame's noise table
    temp_v: torch.Tensor,  # [B, 1] f32
    topk_v: torch.Tensor,  # [B, 1] int
    greedy: bool,
) -> torch.Tensor:
    """One teacher-forced pass of the plain decoder over the frame: for
    every codebook ``i >= 1``, the plain path's token given the draft prefix
    ``< i``; ``[B, N]`` int64 with column 0 passed through.  Inputs
    ``[proj(last_h), proj(embed(c_0)), ..., proj(embed(c_{N-2}))]``, each
    product of the incremental loop's shape (one for the prefill pair, one
    ``[B, D]`` product per later codebook: a batched product may sum in
    another order and move a bf16 input), at positions
    0..N-1 run through the decoder stack once, attending over the same
    static window of ``decoder_rope_positions`` slots the incremental loop
    uses (so every softmax and probability product sums over the same
    length); position ``i`` classifies with ``audio_head[i-1]``."""
    N = config.audio_num_codebooks
    Va = config.audio_vocab_size
    proj = params["projection"]
    dtype = proj.dtype
    offsets = torch.arange(N - 1, device=tokens.device) * Va
    emb = params["audio_embeddings"][tokens[:, :N - 1].long() + offsets]  # [B, N-1, D]
    prefill = torch.stack([last_h.to(dtype), emb[:, 0]], dim=1) @ proj
    x = torch.cat([prefill, *((emb[:, i] @ proj)[:, None] for i in range(1, N - 1))], dim=1)
    B, dev = x.shape[0], x.device
    P = config.decoder_rope_positions
    rope = compute_rope_table(config.decoder, P, dev)
    cache = llama.KVCache.create(config.decoder, B, P, dtype=dtype, device=dev)
    llama.write_rows(cache.valid, torch.ones((B, N), dtype=torch.bool, device=dev), 0)
    h, _ = llama.forward(
        params["decoder"], config.decoder, x, rope_table=rope,
        positions=torch.arange(N, device=dev).expand(B, N),
        attn_bias=llama.make_causal_bias(cache.valid, N), cache=cache,
    )
    lg = bf16_round(torch.einsum("bcd,cdv->cbv", h[:, 1:N], params["audio_head"]))
    # All codebooks' rows in one draw (rows are independent).
    B = lg.shape[1]
    mid = sample_row(lg.reshape((N - 1) * B, Va), gumbel[1:].reshape((N - 1) * B, Va),
                     temp_v.repeat(N - 1, 1), topk_v.repeat(N - 1, 1), greedy)
    return torch.cat([tokens[:, :1].long(), mid.reshape(N - 1, B).T], dim=1)


def decode_frame_specdec(
    params: dict,
    qdec: dict,
    config: CSMConfig,
    last_h: torch.Tensor,  # [B, D]
    c0_logits: torch.Tensor,  # [B, Va]
    gumbel: torch.Tensor,  # [N, B, Va]
    temperature,
    topk,
    greedy: bool,
    *,
    greedy_rows: Optional[torch.Tensor] = None,
    return_rounds: bool = False,
):
    """One frame's codebooks ``[B, N]`` int64 by draft (fused kernel) ->
    verify (one plain teacher-forced pass) -> re-draft rounds, a host loop
    of at most N - 1 rounds.  Same arguments as
    :func:`~csm_tpu_torch.ops.fused_decoder.decode_frame_fused`;
    ``return_rounds`` also returns the number of rounds."""
    B, dev = last_h.shape[0], last_h.device
    N = config.audio_num_codebooks
    temp, k, gumbel = row_params(B, config.audio_vocab_size, temperature, topk, gumbel,
                                 greedy_rows)
    temp_v, topk_v = temp.reshape(B, 1), k.reshape(B, 1)
    c0 = sample_row(bf16_round(c0_logits), gumbel[0], temp_v, topk_v, greedy)

    col = torch.arange(N, device=dev).expand(B, N)
    tokens = torch.zeros((B, N), dtype=torch.long, device=dev)
    tokens[:, 0] = c0
    verified = torch.ones((B,), dtype=torch.long, device=dev)
    rounds = 0
    while bool((verified < N).any()):
        with span("csm.spec.round", round=rounds):
            forced = torch.where(col < verified[:, None], tokens, torch.full_like(tokens, -1))
            draft = decode_frame_fused(params, qdec, config, last_h, c0_logits, gumbel, temp, k,
                                       greedy, forced=forced)
            exact = verify_codebooks(params, config, last_h, draft, gumbel, temp_v, topk_v,
                                     greedy)
            match = (exact == draft) | (col < verified[:, None])
            vk = torch.cumprod(match.long(), dim=1).sum(dim=1)  # first mismatch, or N
            tokens = torch.where(col == vk[:, None], exact, draft)
            verified = torch.clamp(vk + 1, max=N)
        rounds += 1
    return (tokens, rounds) if return_rounds else tokens
