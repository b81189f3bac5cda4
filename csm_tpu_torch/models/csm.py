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

Data- and sequence-parallel training (``forward(mesh=mesh)``): every rank
holds the full global batch and computes its rows (``data``) and frames
(``seq``) of it.  RoPE positions are global; the backbone CE pairs each
local frame's logits with the global next frame's label; the decoder frames
are chosen over the global validity and each is computed on the rank that
holds its conditioning hidden state (frame 0's wrap to ``S - 1`` on the last
``seq`` rank).  Loss sums and target counts are all-reduced, so every rank
returns the global masked means, with the gradient of its own share of them:
summed over the ranks, the gradient of the one-device loss on the global
batch.  The sums run over the ``data`` x ``seq`` ranks at this rank's
``model`` index, never over ``model``: every model rank computes the same
loss.

Tensor parallelism (a mesh with ``model > 1`` and parameters cut by
:func:`csm_tpu_torch.parallel.shard_params`): the stacks run column- and
row-parallel products (:mod:`csm_tpu_torch.models.llama`); the embedding
tables are vocab-sharded, so each lookup takes this rank's rows (zeros for
ids outside them) and sums the gathered rows over ``model`` before any
arithmetic on them (:func:`lookup`): each id hits exactly one rank, so the
rows, and the 33-way masked sum after them, are the one-process values bit
for bit.  The heads and ``projection`` stay replicated.  In a cached pass
(generation) only the ``model`` axis splits the work: the ``data`` x
``seq`` ranks each run the whole batch.  The kernel bundles (``qbb``,
``qsb``) hold whole weights and raise under a model mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from csm_tpu_torch.config import CSMConfig, is_hybrid
from csm_tpu_torch.models import hybrid, llama
from csm_tpu_torch.models.llama import NEG_INF, KVCache, write_rows
from csm_tpu_torch.ops.attention import flash_eligible, sp_flash_eligible
from csm_tpu_torch.ops.rope import compute_rope_table, gather_rope
from csm_tpu_torch.parallel.collectives import all_gather_frames, all_reduce_sum, reduce_from_model
from csm_tpu_torch.parallel.mesh import batch_sharding


BUNDLES_UNDER_TP = (
    "the kernel bundles (qdec, qbb, qsb, specdec; CSMModel.exact() / quantize()) hold whole "
    "weights and do not run under a model mesh: generate on the plain tier (no bundles)")


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

    backbone = (hybrid.init_params if is_hybrid(config) else llama.init_params)(
        config.backbone, gen, device, dtype)
    return {
        "backbone": backbone,
        "decoder": llama.init_params(config.decoder, gen, device, dtype),
        "text_embeddings": normal((config.text_vocab_size, D)),
        "audio_embeddings": normal((config.audio_embedding_rows, D)),
        "projection": normal((D, Dd)),
        "codebook0_head": normal((D, Va)),
        "audio_head": normal((config.audio_num_codebooks - 1, Dd, Va)),
    }


def new_cache(config: CSMConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None,
              num_kv_heads: Optional[int] = None):
    """An empty backbone cache of ``max_len`` slots for ``batch`` streams:
    a :class:`~csm_tpu_torch.models.hybrid.HybridCache` for a hybrid
    backbone, else a :class:`KVCache` (``num_kv_heads``: this rank's under
    tensor parallelism)."""
    if is_hybrid(config):
        return hybrid.HybridCache.create(config.backbone, batch, max_len, dtype=dtype,
                                         device=device)
    return KVCache.create(config.backbone, batch, max_len, dtype=dtype, device=device,
                          num_kv_heads=num_kv_heads)


def lookup(table: torch.Tensor, ids: torch.Tensor, rows: int, mesh=None) -> torch.Tensor:
    """``table[ids]`` of an embedding table of ``rows`` rows, whole or this
    rank's block of its rows over the mesh's ``model`` axis: ids outside the
    block give zeros, and the rows are summed over the axis (exact: each id
    hits one rank)."""
    n = table.shape[0]
    if n == rows:
        return table[ids]
    group = None if mesh is None else mesh.group("model")
    if group is None:
        raise ValueError(f"a table of {n} of {rows} rows is a shard of a model axis: pass the "
                         "mesh it was cut for")
    local = ids - mesh.index("model") * n
    inside = (local >= 0) & (local < n)
    got = table[local.clamp(0, n - 1)]
    got = torch.where(inside[..., None], got, torch.zeros((), dtype=got.dtype, device=got.device))
    return reduce_from_model(got, group)


def embed_audio(params: dict, config: CSMConfig, codebook: int, tokens: torch.Tensor,
                mesh=None) -> torch.Tensor:
    """Embedding of one codebook's tokens, offset by ``codebook * audio_vocab``."""
    return lookup(params["audio_embeddings"], tokens.long() + codebook * config.audio_vocab_size,
                  config.audio_embedding_rows, mesh)


def embed_frames(
    params: dict,
    config: CSMConfig,
    input_ids: torch.Tensor,  # [B, S, 33]
    attention_mask: Optional[torch.Tensor],  # [B, S, 33] or None
    mesh=None,
) -> torch.Tensor:
    """33-way masked embedding sum -> ``[B, S, D]`` (audio and text parts
    reduced separately, then added); vocab-sharded tables are looked up by
    :func:`lookup` before the sum."""
    N = config.audio_num_codebooks
    ids = input_ids.long()
    offsets = torch.arange(N, device=ids.device) * config.audio_vocab_size
    audio_emb = lookup(params["audio_embeddings"], ids[..., :N] + offsets,
                       config.audio_embedding_rows, mesh)  # [B,S,N,D]
    text_emb = lookup(params["text_embeddings"], ids[..., N], config.text_vocab_size,
                      mesh)  # [B,S,D]
    if attention_mask is None:
        return audio_emb.sum(dim=2) + text_emb
    m = attention_mask.to(audio_emb.dtype)
    audio_sum = torch.einsum("bsnd,bsn->bsd", audio_emb, m[..., :N])
    return audio_sum + text_emb * m[..., N, None]


def _ce_sum(logits: torch.Tensor, targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sum of fp32 cross-entropy, count)`` of ``[N, V]`` logits over the
    non-ignored ``[N]`` targets (-100 = ignore)."""
    valid = targets != -100
    safe = torch.where(valid, targets, torch.zeros_like(targets)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, safe[:, None])[:, 0]
    return torch.where(valid, nll, torch.zeros_like(nll)).sum(), valid.sum()


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
    mesh=None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Embed-sum + backbone stack -> hidden ``[B, S, D]``.

    Frame validity is ``any(mask) > 0`` over the 33 tokens.  Positions are
    sequential frame indices from the cache index (left padding is
    numbered, then masked out of attention).  ``flash_prefill``: the cached call is a
    prefill at cache index 0, so eligible shapes take the flash kernel.
    ``qbb``: int8 layer weights (:mod:`csm_tpu_torch.ops.quant`) for W8A16
    products.  ``use_flash=False`` forces the plain attention path of the
    uncached pass; ``remat`` / ``remat_policy`` checkpoint its layers
    (:func:`csm_tpu_torch.models.llama.forward`).  ``mesh``: a
    :class:`~csm_tpu_torch.parallel.Mesh`; the uncached pass then takes the
    global batch and returns this rank's block of hidden ``[B / data,
    S / seq, D]``, and sharded weights run over its ``model`` axis (module
    docstring)."""
    if mesh is not None and qbb is not None:
        raise ValueError("a mesh runs the unquantized pass only")
    if is_hybrid(config):
        return _hybrid_backbone(params, config, input_ids, attention_mask, cache, flash_prefill,
                                qbb, mesh)
    if cache is None:
        return _backbone_uncached(params, config, input_ids, attention_mask, mesh, qbb,
                                  use_flash, remat, remat_policy), None

    # Cached path: record this chunk's validity in the window (in place),
    # then attend over the whole static window.
    B, S, _ = input_ids.shape
    dev = input_ids.device
    bcfg = config.backbone
    h, frame_valid = _embed(params, config, input_ids, attention_mask, mesh)
    rope = compute_rope_table(bcfg, config.max_seq_len, dev)
    start = cache.index
    base = torch.as_tensor(start, device=dev).reshape(-1, 1)
    positions = (base + torch.arange(S, device=dev)).expand(B, S)
    write_rows(cache.valid, frame_valid, start)
    if flash_prefill and flash_eligible(S, bcfg, params["backbone"]["layers"]):
        bias, flash_valid = None, cache.valid
    else:
        bias, flash_valid = llama.make_causal_bias(cache.valid, S, q_offset=start), None
    return llama.forward(
        params["backbone"], bcfg, h, rope_table=rope, positions=positions,
        attn_bias=bias, cache=cache, flash_key_valid=flash_valid, qlayers=qbb, mesh=mesh,
    )


def _hybrid_backbone(params, config, input_ids, attention_mask, cache, flash_prefill, qbb,
                     mesh):
    """The hybrid backbone (:mod:`csm_tpu_torch.models.hybrid`) over the
    embedded frames; cached, this chunk's validity is recorded in the window
    and its attention layers attend the window (the flash kernel for an
    eligible prefill), as the Llama path does."""
    if mesh is not None or qbb is not None:
        raise ValueError("a hybrid backbone runs on one device, without a qbb bundle")
    B, S, _ = input_ids.shape
    bcfg = config.backbone
    h, frame_valid = _embed(params, config, input_ids, attention_mask, None)
    if cache is None:
        bias = llama.make_causal_bias(frame_valid, S)
        hidden, _ = hybrid.forward(params["backbone"], bcfg, h, valid=frame_valid,
                                   attn_bias=bias)
        return hidden, None
    start = cache.index
    write_rows(cache.valid, frame_valid, start)
    if flash_prefill and flash_eligible(S, bcfg, params["backbone"]["attn"]):
        bias, flash_valid = None, cache.valid
    else:
        bias, flash_valid = llama.make_causal_bias(cache.valid, S, q_offset=start), None
    if S == 1:
        return hybrid.step(params["backbone"], bcfg, h, attn_bias=bias, cache=cache)
    if flash_valid is not None and isinstance(start, int) and start == 0:
        return hybrid.prefill(params["backbone"], bcfg, h, valid=frame_valid, cache=cache)
    return hybrid.forward(params["backbone"], bcfg, h, valid=frame_valid, attn_bias=bias,
                          cache=cache, flash_key_valid=flash_valid)


def _group(mesh, axis: str):
    """The mesh's process group on ``axis``; None (the identity) without a
    mesh."""
    return None if mesh is None else mesh.group(axis)


def _embed(params, config, input_ids, attention_mask, mesh):
    """``(embedded frames [B, S, D], frame validity [B, S])``: a frame is
    valid when any of its 33 tokens is."""
    h = embed_frames(params, config, input_ids, attention_mask, mesh)
    if attention_mask is not None:
        return h, attention_mask.sum(dim=-1) > 0
    return h, torch.ones(input_ids.shape[:2], dtype=torch.bool, device=input_ids.device)


def _backbone_uncached(params, config, input_ids, attention_mask, mesh, qbb, use_flash, remat,
                       remat_policy) -> torch.Tensor:
    """The uncached pass over this rank's block of a global batch (the
    whole batch without a mesh): its rows and frames embedded at their
    global positions; attention over the keys of the whole sequence,
    gathered over ``seq``."""
    B, S, _ = input_ids.shape
    rows, frames = batch_sharding(mesh, B, S)
    ids = input_ids[rows, frames]
    mask = None if attention_mask is None else attention_mask[rows, frames]
    h, frame_valid = _embed(params, config, ids, mask, mesh)
    Bl, Sl = frame_valid.shape
    dev = ids.device
    bcfg = config.backbone
    rope = compute_rope_table(bcfg, config.max_seq_len, dev)
    positions = (frames.start + torch.arange(Sl, device=dev)).expand(Bl, Sl)
    layers = params["backbone"]["layers"]
    seq_mesh = mesh if mesh is not None and mesh.size("seq") > 1 else None
    if seq_mesh is None:
        flash = use_flash and flash_eligible(Sl, bcfg, layers)
    else:
        flash = use_flash and sp_flash_eligible(
            mesh, B, S, *llama.local_heads(layers, bcfg), bcfg.head_dim, layers["wq"].dtype)
    if flash:
        bias, flash_valid = None, frame_valid
    else:
        keys_valid = all_gather_frames(frame_valid.to(torch.int32), _group(seq_mesh, "seq"))
        bias = llama.make_causal_bias(keys_valid.bool(), Sl, q_offset=frames.start)
        flash_valid = None
    hidden, _ = llama.forward(
        params["backbone"], bcfg, h, rope_table=rope, positions=positions, attn_bias=bias,
        flash_key_valid=flash_valid, qlayers=qbb, remat=remat, remat_policy=remat_policy,
        mesh=mesh, seq_sharded=seq_mesh is not None,
    )
    return hidden


def decoder_forward_full(params: dict, config: CSMConfig, decoder_inputs: torch.Tensor,
                         mesh=None) -> torch.Tensor:
    """Uncached decoder on ``[F, 33, Dd]`` inputs, positions 0..32."""
    rope = compute_rope_table(config.decoder, config.decoder_rope_positions, decoder_inputs.device)
    return llama.forward_uncached(params["decoder"], config.decoder, decoder_inputs, rope_table=rope,
                                  mesh=mesh)


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
    mesh=None,
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
    step sets them).  ``mesh``: a :class:`~csm_tpu_torch.parallel.Mesh`.
    In the uncached pass its ``data`` x ``seq`` ranks split the batch: the
    arguments are then the global batch, hidden-side outputs are this rank's
    block and the losses are the global ones.  Parameters cut by
    ``shard_params`` run over its ``model`` axis in every pass; a cached pass
    uses that axis only (module docstring)."""
    from csm_tpu_torch.ops.bb_kernel import MAX_VALIDATED_B, MAX_VALIDATED_B_EXACT

    B, S, _ = input_ids.shape
    if (cache is None and last_index is not None and mesh is not None
            and mesh.size("data") * mesh.size("seq") > 1):
        raise ValueError("last_index names a frame of the whole batch: a mesh that splits "
                         "the batch takes none")
    if mesh is not None and mesh.size("model") > 1 and (qsb is not None or qbb is not None):
        raise ValueError(BUNDLES_UNDER_TP)
    if qsb is not None and is_hybrid(config):
        raise ValueError("the backbone step kernels (qsb) run Llama backbones: a hybrid "
                         "backbone steps through its own mixer kernel")
    if (
        qsb is not None and cache is not None and S == 1
        and B <= (MAX_VALIDATED_B if "s" in qsb else MAX_VALIDATED_B_EXACT)
        and labels is None and not return_all_logits
    ):
        return forward_decode_streamed(params, qsb, config, input_ids, attention_mask, cache)

    hidden, new_cache = backbone_forward(
        params, config, input_ids, attention_mask, cache=cache,
        flash_prefill=flash_prefill, qbb=qbb, use_flash=use_flash, remat=remat,
        remat_policy=remat_policy, mesh=mesh,
    )
    head = params["codebook0_head"]

    def c0_head(x):
        if is_hybrid(config):
            return (x @ head) / config.backbone.logits_scaling
        return x @ head

    last_h = hidden[:, -1, :] if last_index is None else hidden[:, last_index, :]
    c0_logits_last = c0_head(last_h)

    loss = backbone_loss = decoder_loss = None
    backbone_targets = decoder_targets = None
    c0_all = c0_head(hidden) if (labels is not None or return_all_logits) else None

    if labels is not None:
        backbone_loss, backbone_targets, decoder_loss, decoder_targets = _losses(
            params, config, hidden, c0_all, input_ids, labels.long(), max_decoder_frames, mesh)
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


def _decoder_logits(params: dict, config: CSMConfig, prev_h: torch.Tensor,
                    frame_codebooks: torch.Tensor, mesh=None) -> torch.Tensor:
    """fp32 logits ``[F, N-1, Va]`` of codebooks 1..N-1 for ``F`` frames:
    the decoder over ``[prev_h; cb0..cbN-1]`` projected, then ``audio_head``."""
    N, Va = config.audio_num_codebooks, config.audio_vocab_size
    proj = params["projection"]
    offsets = torch.arange(N, device=prev_h.device) * Va
    cb_emb = lookup(params["audio_embeddings"], frame_codebooks.long() + offsets,
                    config.audio_embedding_rows, mesh)  # [F, N, D]
    dec_in = torch.cat([(prev_h @ proj)[:, None, :], cb_emb @ proj], dim=1)
    dec_hidden = decoder_forward_full(params, config, dec_in, mesh)
    return torch.einsum("fcd,cdv->fcv", dec_hidden[:, 1:N, :].float(),
                        params["audio_head"].float())


def _losses(params, config, hidden, c0, input_ids, labels, max_decoder_frames, mesh):
    """The two losses of a global batch from this rank's block (``hidden``,
    ``c0`` = its codebook-0 logits; the whole batch without a mesh):
    ``(backbone_loss, backbone_targets, decoder_loss, decoder_targets)``,
    each loss the global masked mean (0 without targets) in value and the
    gradient of this rank's share of it."""
    B, S = labels.shape[:2]
    N, Va = config.audio_num_codebooks, config.audio_vocab_size
    rows, frames = batch_sharding(mesh, B, S)
    Sl = hidden.shape[1]
    # Backbone: local frame t against the global label of t + 1; the last
    # global frame has no target.
    tgt = labels[rows, frames.start + 1:frames.stop + 1, 0]
    tgt = torch.nn.functional.pad(tgt, (0, Sl - tgt.shape[1]), value=-100)
    bb_sum, bb_n = _ce_sum(c0.reshape(-1, Va), tgt.reshape(-1))

    # Decoder: up to max_decoder_frames valid frames over the global
    # validity, earliest first; this rank computes those whose t-1 it holds
    # (hidden at t-1 predicts frame t; t = 0 wraps to S-1, as the
    # reference's negative index does).
    if max_decoder_frames is None:
        max_decoder_frames = B * S
    valid = (labels[..., :N] != -100).all(dim=-1)
    idx, weight = _select_decoder_frames(valid, max_decoder_frames)
    b_idx, t_idx = idx // S, idx % S
    p_idx = (t_idx - 1) % S
    mine = (weight & (b_idx >= rows.start) & (b_idx < rows.stop)
            & (p_idx >= frames.start) & (p_idx < frames.stop))
    b_idx, t_idx, p_idx = b_idx[mine], t_idx[mine], p_idx[mine]
    prev_h = hidden[b_idx - rows.start, p_idx - frames.start]
    cb_logits = _decoder_logits(params, config, prev_h, input_ids[b_idx, t_idx, :N], mesh)
    dec_sum, dec_n = _ce_sum(cb_logits.reshape(-1, Va), labels[b_idx, t_idx, 1:N].reshape(-1))

    sums = all_reduce_sum(torch.stack([bb_sum.detach(), bb_n.float(), dec_sum.detach(),
                                       dec_n.float()]), _group(mesh, "batch"))

    def mean(local, total, n):
        # Value total / n (0 without targets), gradient of local / n.
        n = n.clamp(min=1)
        part = local / n
        return total / n + (part - part.detach())

    return (mean(bb_sum, sums[0], sums[1]), sums[1].long(),
            mean(dec_sum, sums[2], sums[3]), sums[3].long())
