"""Autoregressive generation (counterpart of ``csm_tpu/generation.py``):
KV-cached backbone decode plus intra-frame decoder sampling (reference
``modeling_csm.py:484-702``).

Each frame: one backbone decode step (through a backbone kernel when a
``qsb`` bundle is given), c0 sampled from ``codebook0_head``, the decoder
prefilled with ``[proj(h); proj(embed(c0))]`` at positions 0..1 and stepped
for codebooks 1..30, codebook 31 classified from the last state with no
trailing step, and the next ``[B, 1, 33]`` input built.  The codebook loop is
plain PyTorch, the fused int8 kernel (``qdec``), or the speculative tier
(``qdec`` with ``specdec``); all draw from one noise table per frame.  Eager
PyTorch with the JAX package's static shapes: a prompt right-padded to a
bucket, a backbone cache window of ``min(max_seq_len, S + max_new_frames)``
rounded up to 128 slots, a 33-slot decoder cache per frame.

Stopping (``modeling_csm.py:662-663``): ``stop_mode="batch"`` stops when a
frame is all zero in every stream (not appended); ``stop_mode="stream"``
freezes each stream at its own all-zero frame.

Tensor parallelism (``mesh=``, parameters cut by
:func:`csm_tpu_torch.parallel.shard_params`): the backbone and decoder run
over the mesh's ``model`` axis, their caches hold this rank's KV heads, and
every rank of the axis draws the same tokens (greedy, or the same Gumbel
noise from generators seeded alike), so the ranks never diverge and no token
is broadcast.  The ``data`` x ``seq`` ranks each generate the whole batch.
The kernel bundles hold whole weights: under a model mesh they raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from csm_tpu_torch.config import CSMConfig, is_hybrid
from csm_tpu_torch.models import csm, llama
from csm_tpu_torch.models.llama import KVCache
from csm_tpu_torch.ops.fused_decoder import MAX_CHUNKED_B, build_frame_gumbel, decode_frame_fused
from csm_tpu_torch.ops.rope import compute_rope_table
from csm_tpu_torch.ops.sampling import sample_topk
from csm_tpu_torch.ops.specdec import MAX_SPECDEC_B, decode_frame_specdec
from csm_tpu_torch.utils.profiling import span

# One generator for the whole batch, or one per stream (each stream's draws
# then depend on its own generator alone: a request's tokens do not depend on
# the rest of the batch).
Generators = Union[None, torch.Generator, Sequence[torch.Generator]]


def _refuse_bundles(mesh, *bundles) -> None:
    """Raise when a kernel bundle (or ``specdec=True``) is given under a
    model mesh."""
    if mesh is not None and mesh.size("model") > 1 and any(
            b is not None and b is not False for b in bundles):
        raise ValueError(csm.BUNDLES_UNDER_TP)


def _decoder_step(
    params: dict,
    config: CSMConfig,
    x: torch.Tensor,  # [B, S, Dd] projected inputs
    cache: KVCache,
    mesh=None,
) -> Tuple[torch.Tensor, KVCache]:
    """One cached decoder forward over ``x`` at positions ``cache.index ..``;
    returns the last position's hidden ``[B, Dd]`` and the advanced cache."""
    B, S, _ = x.shape
    dev = x.device
    start = cache.index
    rope = compute_rope_table(config.decoder, config.decoder_rope_positions, dev)
    positions = (start + torch.arange(S, device=dev)).expand(B, S)
    llama.write_rows(cache.valid, torch.ones((B, S), dtype=torch.bool, device=dev), start)
    bias = llama.make_causal_bias(cache.valid, S, q_offset=start)
    h, cache = llama.forward(
        params["decoder"], config.decoder, x, rope_table=rope, positions=positions,
        attn_bias=bias, cache=cache, mesh=mesh,
    )
    return h[:, -1, :], cache


def decode_frame(
    params: dict,
    config: CSMConfig,
    last_h: torch.Tensor,  # [B, D] backbone hidden at the final position
    c0_logits: torch.Tensor,  # [B, audio_vocab]
    *,
    temperature=1.0,
    topk=50,
    greedy: bool = False,
    generator: Generators = None,
    qdec: Optional[dict] = None,
    specdec: bool = False,
    greedy_rows: Optional[torch.Tensor] = None,
    mesh=None,
) -> torch.Tensor:
    """Sample all 32 codebooks of one frame; returns ``[B, 32]`` int64.

    The frame's Gumbel noise table ``[32, B, Va]`` is drawn once from
    ``generator`` (row i for codebook i; a list of ``B`` generators draws
    each stream's rows from its own), whichever tier runs.
    ``temperature`` / ``topk`` may be per-row ``[B]`` tensors, and
    ``greedy_rows [B]`` makes the marked rows exactly argmax (top-1 with
    their noise zeroed) inside a sampled batch.  ``qdec``: a
    :func:`~csm_tpu_torch.ops.fused_decoder.prepare_fused_decoder` bundle;
    batches of up to ``MAX_CHUNKED_B`` then run the fused int8 kernel, or,
    with ``specdec``, up to ``MAX_SPECDEC_B`` run the speculative tier
    (exact: its tokens are the plain loop's).  Other batches take the plain
    loop.  ``mesh``: the decoder's weights are cut over its ``model`` axis
    (module docstring)."""
    _refuse_bundles(mesh, qdec, specdec)
    B = last_h.shape[0]
    N = config.audio_num_codebooks
    Va = config.audio_vocab_size
    proj = params["projection"]
    gumbel = build_frame_gumbel(config, generator, B, greedy, last_h.device)
    args = (params, qdec, config, last_h, c0_logits, gumbel, temperature, topk, greedy)
    if greedy:
        greedy_rows = None
    if qdec is not None and specdec and B <= MAX_SPECDEC_B:
        return decode_frame_specdec(*args, greedy_rows=greedy_rows)
    if qdec is not None and not specdec and B <= MAX_CHUNKED_B:
        return decode_frame_fused(*args, greedy_rows=greedy_rows)

    def draw(logits, i):
        return sample_topk(logits, topk, temperature, greedy, noise=gumbel[i],
                           greedy_rows=greedy_rows)

    c0 = draw(c0_logits, 0)
    c0_embed = csm.embed_audio(params, config, 0, c0, mesh)
    dec_cache = KVCache.create(
        config.decoder, B, config.decoder_rope_positions, dtype=last_h.dtype, device=last_h.device,
        num_kv_heads=llama.local_heads(params["decoder"]["layers"], config.decoder)[1],
    )
    prefill = torch.stack([last_h, c0_embed], dim=1) @ proj  # [B, 2, Dd]
    h_last, dec_cache = _decoder_step(params, config, prefill, dec_cache, mesh)

    out = [c0]
    # Codebooks 1..N-2 each also advance the decoder; N-1 is classified from
    # the last state without a trailing step.
    for i in range(1, N - 1):
        ci = draw(h_last @ params["audio_head"][i - 1], i)
        out.append(ci)
        ci_embed = csm.embed_audio(params, config, i, ci, mesh)
        h_last, dec_cache = _decoder_step(params, config, (ci_embed @ proj)[:, None, :], dec_cache,
                                          mesh)
    out.append(draw(h_last @ params["audio_head"][N - 2], N - 1))
    return torch.stack(out, dim=1)


def generate_frame(
    params: dict,
    config: CSMConfig,
    input_ids: torch.Tensor,  # [B, S, 33]
    attention_mask: Optional[torch.Tensor],
    *,
    cache: Optional[KVCache] = None,
    temperature=1.0,
    topk=50,
    greedy: bool = False,
    generator: Generators = None,
    true_len: Optional[int] = None,
    flash_prefill: bool = False,
    qdec: Optional[dict] = None,
    qbb: Optional[dict] = None,
    qsb: Optional[dict] = None,
    specdec: bool = False,
    greedy_rows: Optional[torch.Tensor] = None,
    mesh=None,
) -> csm.CSMOutput:
    """One frame's 32 codebooks (reference ``generate_frame``).

    ``true_len``: the real frame count of a right-padded prompt; the cache
    index (an int or a per-stream ``[B]`` tensor) is pinned at its start
    plus ``true_len``, so later steps overwrite the bucket padding (a
    hybrid backbone's recurrent states never take the padding in).
    ``qbb`` / ``qsb`` select the backbone step's tier, ``qdec`` /
    ``specdec`` the codebook loop's; ``temperature`` / ``topk`` may be
    per-row and ``greedy_rows`` marks deterministic rows
    (:func:`decode_frame`).  ``mesh``: parameters cut over its ``model``
    axis (module docstring)."""
    B, S = input_ids.shape[:2]
    with span("csm.gen.prefill" if S > 1 else "csm.gen.backbone", device=True, S=S, B=B):
        out = csm.forward(
            params, config, input_ids, attention_mask, cache=cache,
            last_index=None if true_len is None else true_len - 1,
            flash_prefill=flash_prefill, qbb=qbb, qsb=qsb, mesh=mesh,
        )
    new_cache = out.cache
    if new_cache is not None and true_len is not None:
        start = cache.index if cache is not None else 0
        new_cache = dataclasses.replace(new_cache, index=start + true_len)
    with span("csm.gen.codebooks", device=True, B=B):
        samples = decode_frame(
            params, config, out.last_hidden_state, out.logits,
            temperature=temperature, topk=topk, greedy=greedy, generator=generator,
            qdec=qdec, specdec=specdec, greedy_rows=greedy_rows, mesh=mesh,
        )
    return csm.CSMOutput(
        last_hidden_state=out.last_hidden_state, logits=out.logits,
        cache=new_cache, samples=samples,
    )


def _next_frame_inputs(config: CSMConfig, new_frame: torch.Tensor):
    """Next step's ``[B, 1, 33]`` inputs: the 32 sampled tokens and a zero
    text column; mask 1 on audio, 0 on text."""
    B = new_frame.shape[0]
    N = config.audio_num_codebooks
    ids = torch.zeros((B, 1, config.frame_width), dtype=torch.long, device=new_frame.device)
    ids[:, 0, :N] = new_frame
    mask = torch.zeros((B, 1, config.frame_width), dtype=torch.float32, device=new_frame.device)
    mask[:, :, :N] = 1.0
    return ids, mask


@torch.no_grad()
def generate_compiled(
    params: dict,
    config: CSMConfig,
    input_ids: torch.Tensor,  # [B, S_bucket, 33] right-padded prompt
    attention_mask: torch.Tensor,  # [B, S_bucket, 33]
    true_len: int,
    *,
    max_new_frames: int,
    temperature=1.0,
    topk: int = 50,
    greedy: bool = False,
    stop_on_all_zeros: bool = True,
    stop_mode: str = "batch",
    cache_len: Optional[int] = None,
    generator: Generators = None,
    qdec: Optional[dict] = None,
    qbb: Optional[dict] = None,
    qsb: Optional[dict] = None,
    specdec: bool = False,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill plus a loop of frame steps with static shapes.  Returns
    ``(frames [B, max_new_frames, 32], n_frames [B])``; rows past a stream's
    ``n_frames`` are zero.  The prefill's backbone stays in the param dtype;
    ``qbb`` / ``qsb`` serve the later frames' backbone steps, ``qdec`` /
    ``specdec`` every frame's codebook loop.  ``mesh``: parameters cut over
    its ``model`` axis (module docstring)."""
    _refuse_bundles(mesh, qdec, qbb, qsb, specdec)
    if stop_mode not in ("batch", "stream"):
        raise ValueError(f"stop_mode must be 'batch' or 'stream', got {stop_mode!r}")
    B, S, _ = input_ids.shape
    dev = input_ids.device
    N = config.audio_num_codebooks
    if cache_len is None:
        # Rounded to a multiple of 128 as in the JAX package; the extra
        # slots stay invalid.
        cache_len = min(config.max_seq_len, S + max_new_frames)
        cache_len = ((cache_len + 127) // 128) * 128
    dtype = params["backbone"]["final_norm"].dtype
    kv_heads = None if is_hybrid(config) else llama.local_heads(params["backbone"]["layers"],
                                                                config.backbone)[1]
    cache = csm.new_cache(config, B, cache_len, dtype=dtype, device=dev, num_kv_heads=kv_heads)
    sample_kw = dict(temperature=temperature, topk=topk, greedy=greedy, generator=generator,
                     qdec=qdec, specdec=specdec, mesh=mesh)
    out = generate_frame(
        params, config, input_ids, attention_mask, cache=cache,
        true_len=true_len, flash_prefill=True, **sample_kw,
    )

    frames = torch.zeros((B, max_new_frames, N), dtype=torch.long, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    n_frames = torch.zeros((B,), dtype=torch.long, device=dev)

    def process(new_frame, done, n_frames, step):
        frame_zero = (new_frame == 0).all(dim=1)
        if not stop_on_all_zeros:
            append, new_done = ~done, done
        elif stop_mode == "batch":
            # Stop, without appending, only when EVERY stream is all zero.
            stop_now = frame_zero.all()
            append = ~stop_now & ~done
            new_done = done | stop_now
        else:
            append = ~done & ~frame_zero
            new_done = done | frame_zero
        frames[:, step] = torch.where(append[:, None], new_frame, torch.zeros_like(new_frame))
        return new_done, n_frames + append.long()

    done, n_frames = process(out.samples, done, n_frames, 0)
    prev, cache = out.samples, out.cache
    for step in range(1, max_new_frames):
        if stop_on_all_zeros and bool(done.all()):
            break
        ids, mask = _next_frame_inputs(config, prev)
        out = generate_frame(params, config, ids, mask, cache=cache, qbb=qbb, qsb=qsb,
                             **sample_kw)
        done, n_frames = process(out.samples, done, n_frames, step)
        prev, cache = out.samples, out.cache
    return frames, n_frames


def _bucket(n: int, buckets=(32, 64, 128, 256, 512, 1024, 2048)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n


def _pad_to_bucket(ids: np.ndarray, mask: np.ndarray, cap: Optional[int] = None):
    """Right-pad ``[B, S, 33]`` ids/mask to the next prompt bucket (zero
    ids, zero mask: masked frames never attend), the bucket clamped to
    ``cap`` if given.  Returns ``(ids, mask, S, Sb)``; generation and the
    serving paths share it so their padding rules cannot drift apart."""
    B, S, W = ids.shape
    Sb = _bucket(S)
    if cap is not None:
        Sb = min(Sb, cap)
    if Sb > S:
        ids = np.concatenate([ids, np.zeros((B, Sb - S, W), ids.dtype)], axis=1)
        mask = np.concatenate([mask, np.zeros((B, Sb - S, W), mask.dtype)], axis=1)
    return ids, mask, S, Sb


def generate(
    params: dict,
    config: CSMConfig,
    input_ids,
    attention_mask,
    max_new_frames: int = 100,
    temperature: float = 1.0,
    topk: int = 50,
    use_cache: bool = True,  # accepted for API parity; always cached
    stop_on_all_zeros: bool = True,
    *,
    generator: Generators = None,
    greedy: bool = False,
    stop_mode: str = "batch",
    qdec: Optional[dict] = None,
    qbb: Optional[dict] = None,
    qsb: Optional[dict] = None,
    specdec: bool = False,
    mesh=None,
) -> np.ndarray:
    """Reference-compatible ``generate``: ``[B, n_frames, 32]`` int64 numpy
    tokens (possibly ``[B, 0, 32]``), computed on the params' device.
    ``generator``: one for the batch, or a list of ``B`` (per-stream draws,
    as the server makes them).  ``mesh``: parameters cut over its ``model``
    axis (module docstring)."""
    del use_cache
    dev = params["projection"].device
    ids = np.asarray(input_ids.cpu() if isinstance(input_ids, torch.Tensor) else input_ids)
    mask = np.asarray(
        attention_mask.cpu() if isinstance(attention_mask, torch.Tensor) else attention_mask,
        np.float32,
    )
    ids, mask, S, _ = _pad_to_bucket(ids.astype(np.int64), mask)
    frames, n_frames = generate_compiled(
        params, config, torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev), S,
        max_new_frames=max_new_frames, temperature=temperature, topk=topk, greedy=greedy,
        stop_on_all_zeros=stop_on_all_zeros, stop_mode=stop_mode, generator=generator,
        qdec=qdec, qbb=qbb, qsb=qsb, specdec=specdec, mesh=mesh,
    )
    n_frames = n_frames.cpu()
    n = int(n_frames.max()) if stop_mode == "stream" else int(n_frames[0])
    return frames[:, :n].cpu().numpy()
