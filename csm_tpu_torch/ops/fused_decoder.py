"""The fused codebook loop: the CUDA kernel ``csrc/fused_decoder.cu``
(counterpart of ``csm_tpu/ops/fused_decoder.py::fused_decode_codebooks``)
and its plain PyTorch version, with the bundle, sampling and noise they share.

One call samples all codebooks of a frame for ``B <= 32`` streams: c0 from
the backbone's logits, then the decoder prefill and one decoder pass per
codebook, with int8 per-output-channel weights (W8A16, RMSNorm weights folded
into the products), the head applied per codebook (bf16, or int8 with
``head_bits=8``), top-k over bf16 bit patterns (the plain version by
bisection, the kernel by a radix select that finds the same k-th value) and
Gumbel-max draws from a given noise table.  A ``forced`` prefix pins tokens (the
speculative tier's re-drafts).  The plain version repeats the kernel's
arithmetic op for op in PyTorch; it is what a CPU tensor gets.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from csm_tpu_torch.config import CSMConfig
from csm_tpu_torch.ops import _build
from csm_tpu_torch.ops.quant import qmm, quantize_per_channel
from csm_tpu_torch.ops.rope import compute_rope_table
from csm_tpu_torch.ops.sampling import gumbel_noise
from csm_tpu_torch.utils.profiling import span

NEG_INF = -1e9
KERNEL = "fused_decoder"
# Largest batch one kernel call serves (the JAX package's MAX_CHUNKED_B);
# larger batches take the plain PyTorch loop in generation.decode_frame.
MAX_CHUNKED_B = 32
_HEAD_KINDS = {torch.bfloat16: 0, torch.int8: 1, torch.float32: 2}


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to the bf16 grid (nearest, ties to even)."""
    return x.float().to(torch.bfloat16).float()


def prepare_fused_decoder(params: dict, config: CSMConfig, head_bits: int = 16) -> dict:
    """The kernel's bundle: per layer int8 ``wqkv = [wq|wk|wv]`` and ``w_gu =
    [w_gate|w_up]`` with the RMSNorm weights folded in before quantization,
    ``wo``, ``w_down`` (``"w"``, with f32 scales ``[L, 1, N]`` in ``"s"``);
    the decoder RoPE tables; ``proj_emb = audio_embeddings @ projection`` in
    the param dtype; the head ``[N-1, Dd, Va_pad]`` with the final norm folded
    in, padded to a multiple of 128 columns, in the param dtype or (with
    ``head_bits=8``) int8 with ``head_scale [N-1, 1, Va_pad]``."""
    if head_bits not in (8, 16):
        raise ValueError(f"head_bits must be 8 or 16, got {head_bits}")
    dec = params["decoder"]["layers"]
    attn_nw = dec["attn_norm"].float()[:, :, None]
    mlp_nw = dec["mlp_norm"].float()[:, :, None]
    out = {"w": {}, "s": {}}

    def family(name, parts, fold=None):
        qs = [quantize_per_channel(dec[p].float() * (fold if fold is not None else 1.0))
              for p in parts]
        out["w"][name] = torch.cat([q for q, _ in qs], dim=-1).contiguous()
        out["s"][name] = torch.cat([s for _, s in qs], dim=-1).contiguous()

    family("wqkv", ("wq", "wk", "wv"), attn_nw)
    family("wo", ("wo",))
    family("w_gu", ("w_gate", "w_up"), mlp_nw)
    family("w_down", ("w_down",))
    dev = params["projection"].device
    out["cos"], out["sin"] = compute_rope_table(config.decoder, config.decoder_rope_positions, dev)
    out["proj_emb"] = (params["audio_embeddings"] @ params["projection"]).contiguous()
    Va = config.audio_vocab_size
    Va_pad = -(-Va // 128) * 128
    fnw = params["decoder"]["final_norm"].float()[None, :, None]
    head = params["audio_head"].float() * fnw
    if head_bits == 8:
        hq, hs = quantize_per_channel(head)
        out["audio_head"] = F.pad(hq, (0, Va_pad - Va)).contiguous()
        out["head_scale"] = F.pad(hs, (0, Va_pad - Va), value=1.0).contiguous()
    else:
        out["audio_head"] = F.pad(head.to(params["audio_head"].dtype), (0, Va_pad - Va)).contiguous()
    return out


# ---------------------------------------------------------------------------
# Sampling and noise
# ---------------------------------------------------------------------------


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Smallest index among each row's maxima, ``[B]`` int64."""
    m = x.max(dim=-1, keepdim=True).values
    idx = torch.arange(x.shape[-1], device=x.device).expand_as(x)
    return torch.where(x == m, idx, torch.full_like(idx, 2 ** 30)).min(dim=-1).values


def sample_row(
    logits: torch.Tensor,  # [B, V] f32, bf16-valued
    gumbel: torch.Tensor,  # [B, V] f32
    temperature,  # scalar or [B, 1]
    topk,  # int or [B, 1]
    greedy: bool,
) -> torch.Tensor:
    """One Gumbel-top-k draw per row, ``[B]`` int64 (the JAX package's
    ``_sample_row``): the k-th largest logit found exactly by a 16-step
    bisection over order-preserving keys of the float bit patterns (exact on
    bf16-rounded logits), ties at the k-th value kept, first-index argmax of
    ``filtered / max(temperature, 1e-6) + gumbel``.  Greedy: first-index
    argmax of the logits."""
    if greedy:
        return first_argmax(logits)
    dev = logits.device
    t = torch.as_tensor(temperature, dtype=torch.float32, device=dev)
    t = t.reshape(-1, 1) if t.ndim else t
    scaled = logits / torch.clamp(t, min=1e-6)
    u = logits.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    ukey = torch.where(u >> 31 > 0, ~u & 0xFFFFFFFF, u | 0x80000000)
    k = torch.as_tensor(topk, device=dev).long().reshape(-1, 1)
    kth = torch.zeros((logits.shape[0], 1), dtype=torch.long, device=dev)
    for b in range(16):
        cand = kth | (1 << (31 - b))
        cnt = (ukey >= cand).sum(dim=-1, keepdim=True)
        kth = torch.where(cnt >= k, cand, kth)
    filtered = torch.where(ukey >= kth, scaled, torch.full_like(scaled, NEG_INF))
    return first_argmax(filtered + gumbel)


def build_frame_gumbel(
    config: CSMConfig, generator, B: int, greedy: bool, device
) -> torch.Tensor:
    """One frame's noise table ``[N, B, Va]``: row ``i`` is codebook ``i``'s,
    drawn once and shared by every tier (zero when greedy).  ``generator`` is
    one ``torch.Generator`` (or None) for the whole table, or a list of ``B``:
    stream ``b``'s ``[N, Va]`` noise then comes from generator ``b`` alone, so
    its draws do not depend on the rest of the batch."""
    N, Va = config.audio_num_codebooks, config.audio_vocab_size
    if greedy:
        return torch.zeros((N, B, Va), dtype=torch.float32, device=device)
    if isinstance(generator, (list, tuple)):
        if len(generator) != B:
            raise ValueError(f"{len(generator)} generators for a batch of {B}")
        return torch.stack([gumbel_noise((N, Va), g, device) for g in generator], dim=1)
    return gumbel_noise((N, B, Va), generator, device)


def row_params(B: int, Va: int, temperature, topk, gumbel: torch.Tensor,
               greedy_rows: Optional[torch.Tensor] = None):
    """Per-row ``temperature [B]`` f32, ``topk [B]`` int32 in [1, Va] and the
    noise table.  ``greedy_rows [B]`` makes the marked rows deterministic:
    top-1 with their noise zeroed, which is the greedy argmax."""
    dev = gumbel.device
    temp = torch.as_tensor(temperature, dtype=torch.float32, device=dev).reshape(-1).expand(B)
    k = torch.as_tensor(topk, device=dev).long().reshape(-1).expand(B).clamp(1, Va)
    if greedy_rows is not None:
        gr = torch.as_tensor(greedy_rows, device=dev).reshape(B).bool()
        k = torch.where(gr, torch.ones_like(k), k)
        gumbel = gumbel * (~gr).float()[None, :, None]
    return temp.contiguous(), k.to(torch.int32).contiguous(), gumbel


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def rms_scale(x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm's per-row scale ``rsqrt(mean(x^2) + eps)``, applied to the
    outputs of products whose weights carry the norm weight."""
    return torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x [B, T, H, hd]`` by ``cos/sin [T, hd]``, f32, rotate-half."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None, :] + rotated * sin[:, None, :]


def _decoder_pass(qdec, config, h, pos0: int, kv_k, kv_v, acc, act):
    """One pass of the decoder over ``h [B, T, Dd]`` (f32) at positions
    ``pos0..``, writing the bf16 K/V scratch ``[L, B, P, nkv, hd]`` in
    place; returns each stream's last row, final-normed, ``[B, Dd]``."""
    dcfg = config.decoder
    eps = dcfg.rms_norm_eps
    nq, nkv, hd, Fi = (dcfg.num_attention_heads, dcfg.num_key_value_heads, dcfg.head_dim,
                       dcfg.intermediate_size)
    B, T, _ = h.shape
    g = nq // nkv
    w, s = qdec["w"], qdec["s"]
    cos, sin = qdec["cos"][pos0:pos0 + T], qdec["sin"][pos0:pos0 + T]
    n_keys = pos0 + T
    qpos = pos0 + torch.arange(T, device=h.device)[:, None]
    causal = torch.arange(n_keys, device=h.device)[None, :] <= qpos  # [T, n_keys]
    for l in range(w["wqkv"].shape[0]):
        qkv = qmm(h, w["wqkv"][l], s["wqkv"][l], acc, act) * rms_scale(h, eps)
        q = _rope(qkv[..., :nq * hd].reshape(B, T, nq, hd), cos, sin)
        k = _rope(qkv[..., nq * hd:(nq + nkv) * hd].reshape(B, T, nkv, hd), cos, sin)
        v = qkv[..., (nq + nkv) * hd:].reshape(B, T, nkv, hd)
        kv_k[l, :, pos0:pos0 + T] = k.to(torch.bfloat16)
        kv_v[l, :, pos0:pos0 + T] = v.to(torch.bfloat16)
        keys = kv_k[l, :, :n_keys].to(acc)  # [B, n_keys, nkv, hd]
        vals = kv_v[l, :, :n_keys].to(acc)
        qg = q.to(act).to(acc).reshape(B, T, nkv, g, hd)
        scores = torch.einsum("btngh,bsnh->bngts", qg, keys).float() * (1.0 / hd ** 0.5)
        scores = torch.where(causal, scores, torch.full_like(scores, NEG_INF))
        e = torch.exp(scores - scores.max(dim=-1, keepdim=True).values)
        probs = (e / e.sum(dim=-1, keepdim=True)).to(torch.bfloat16).to(acc)
        attn = torch.einsum("bngts,bsnh->btngh", probs, vals).float().reshape(B, T, nq * hd)
        h = h + qmm(attn, w["wo"][l], s["wo"][l], acc, act)
        gu = qmm(h, w["w_gu"][l], s["w_gu"][l], acc, act) * rms_scale(h, eps)
        gt, up = gu[..., :Fi], gu[..., Fi:]
        h = h + qmm(gt * torch.sigmoid(gt) * up, w["w_down"][l], s["w_down"][l], acc, act)
    h_last = h[:, -1]
    return h_last * rms_scale(h_last, eps)


def _head_logits(qdec, config, h_last, i: int, acc, act) -> torch.Tensor:
    """Codebook ``i``'s logits ``[B, Va_pad]`` from head slice ``i - 1``:
    bf16-rounded, padded columns ``NEG_INF``."""
    head = qdec["audio_head"][i - 1]
    if "head_scale" in qdec:
        lg = qmm(h_last, head, qdec["head_scale"][i - 1], acc, act)
    else:
        x = h_last.to(act if head.dtype == torch.bfloat16 else head.dtype)
        lg = (x.to(acc) @ head.to(acc)).float()
    lg = bf16_round(lg)
    col = torch.arange(lg.shape[-1], device=lg.device)
    return torch.where(col < config.audio_vocab_size, lg, torch.full_like(lg, NEG_INF))


def decode_codebooks_reference(
    qdec: dict,
    config: CSMConfig,
    x0: torch.Tensor,  # [B, Dd] f32: proj(last_h)
    c0_logits: torch.Tensor,  # [B, Va] f32
    gumbel: torch.Tensor,  # [N, B, Va] f32
    temperature: torch.Tensor,  # [B] f32
    topk: torch.Tensor,  # [B] int, in [1, Va]
    greedy: bool,
    forced: torch.Tensor,  # [B, N] int, -1 = draw
    acc: torch.dtype = torch.float32,
    act: torch.dtype = torch.bfloat16,
):
    """The plain version of the kernel, batched: returns ``(samples [B, N]
    int64, logits [N, B, Va_pad] f32, draws [B, N] int64)``, where row 0 of
    the logits is the masked c0 input and ``draws`` are the picks before
    ``forced`` overrides them.  ``acc`` is the type the products sum in;
    ``act`` the type activations are rounded to before each product and
    the attention dots (bf16; f32 gives a faulty version that a check of the
    kernel must tell apart)."""
    N = config.audio_num_codebooks
    Va = config.audio_vocab_size
    dcfg = config.decoder
    B, dev = x0.shape[0], x0.device
    Va_pad = qdec["audio_head"].shape[-1]
    temp_v, topk_v = temperature.reshape(B, 1), topk.reshape(B, 1)
    gum = F.pad(gumbel.float(), (0, Va_pad - Va))
    emb = qdec["proj_emb"]
    L = qdec["w"]["wqkv"].shape[0]
    shape = (L, B, N, dcfg.num_key_value_heads, dcfg.head_dim)
    kv_k = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    kv_v = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    forced = forced.long()

    samples, draws, logits = [], [], []

    def take(lg, i):
        d = sample_row(lg, gum[i], temp_v, topk_v, greedy)
        c = torch.where(forced[:, i] >= 0, forced[:, i], d)
        logits.append(lg)
        draws.append(d)
        samples.append(c)
        return c

    lg0 = F.pad(bf16_round(c0_logits), (0, Va_pad - Va), value=NEG_INF)
    c = take(lg0, 0)
    h = torch.stack([x0.float(), emb[c].float()], dim=1)  # [B, 2, Dd]
    h_last = _decoder_pass(qdec, config, h, 0, kv_k, kv_v, acc, act)
    for i in range(1, N):
        c = take(_head_logits(qdec, config, h_last, i, acc, act), i)
        if i < N - 1:
            h_last = _decoder_pass(qdec, config, emb[c + i * Va].float()[:, None], i + 1,
                                   kv_k, kv_v, acc, act)
    return torch.stack(samples, 1), torch.stack(logits), torch.stack(draws, 1)


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------

_F, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SHAPES = ([_I] * 11, _LL)
# The C functions of csrc/fused_decoder.cu: (argtypes, restype).
SIGNATURES = {
    "fused_decode": ([_F] * 25 + [_LL] * 2 + [_I] * 14 + [ctypes.c_float, _F], _I),
    "fd_scratch_bytes": _SHAPES,
    "fd_item_count": _SHAPES,
    "fd_error_string": ([_I], ctypes.c_char_p),
}
# Int64 slots a work item takes in the item trace (csrc/bb_step.cuh
# ``TRACE_SLOTS``): its stage, start, end of its waits, marks inside it (0
# where it has none), end.
TRACE_SLOTS = 8
# Stages of a pass in the traces besides its layers' five each: the input,
# the final norm, the head, the draws (csrc/fused_decoder.cu ``PASS_EXTRA``).
PASS_EXTRA = 4
# The scratch's int32 words that hold the last launch's counters
# (csrc/fused_decoder.cu ``SYNC_OUT``, four words from there).
SYNC_OUT = 4
SYNC_NAMES = ("grid_barriers", "items", "closed_waits", "slot_waits")
# Logits a thread of the kernel's draw holds (csrc/fused_decoder.cu
# ``DRAW_VPT``): the head takes at most 256 times as many columns.
DRAW_VPT = 16
# Return codes from this one on are arguments the kernel refuses
# (csrc/bb_step.cuh ``Refused``).
_REFUSED = 10001


def _lib():
    return _build.load(KERNEL, SIGNATURES)


def stage_count(N: int, L: int) -> int:
    """Stamps a ``stage_ns`` buffer takes: block 0's start, then the end of
    each stage of the frame's list (the c0 draws; per position the input, per
    layer QKV, attention, o-proj, gate-up and down, then the final norm, the
    head and the draws)."""
    return 2 + N * (5 * L + PASS_EXTRA)


def _check_shapes(B, N, D, Fi, nq, nkv, hd, Va_pad, head_kind):
    """ValueError naming the limit the kernel does not take."""
    if not 1 <= B <= MAX_CHUNKED_B:
        raise ValueError(f"fused_decode_codebooks kernel: unsupported B={B}, outside "
                         f"1..{MAX_CHUNKED_B}")
    if not 2 <= N <= 64:
        raise ValueError(f"fused_decode_codebooks kernel: {N} codebooks, outside 2..64 positions")
    if nkv <= 0 or nq % nkv or nq // nkv > 8:
        raise ValueError(f"fused_decode_codebooks kernel: heads {nq}/{nkv} (a GQA group of at "
                         "most 8)")
    if hd not in (16, 32, 64, 128):
        raise ValueError(f"fused_decode_codebooks kernel: head_dim {hd} (16, 32, 64 or 128: "
                         "heads tile 128 columns)")
    if D % 128 or Va_pad % 128 or Fi % 128:
        raise ValueError(f"fused_decode_codebooks kernel: D={D}, F={Fi} and the head's {Va_pad} "
                         "columns must be multiples of 128")
    if Va_pad > DRAW_VPT * 256:
        raise ValueError(f"fused_decode_codebooks kernel: {Va_pad} head columns, more than "
                         f"{DRAW_VPT * 256} (a draw's 256 threads hold {DRAW_VPT} logits each)")
    if (nq * hd) % 128:
        raise ValueError(f"fused_decode_codebooks kernel: nq*hd={nq * hd} must be a multiple of "
                         "128 (whole weight chunks)")
    if head_kind is None:
        raise ValueError("fused_decode_codebooks kernel: the head must be bf16, int8 or f32")


# Scratch kept across calls of the same shapes and head on the same device:
# one byte buffer the kernel lays out (residual, operands, logits, K/V rows,
# split partials, per-item flags, tickets, counters), zeroed once here, and
# the launch epoch.  Flags are stamped with the epoch, tickets and counters
# re-arm themselves, so nothing is cleared between launches.  Calls on one
# device are ordered by its stream, which the scratch assumes.
_SCRATCH: dict = {}
_last: list = []


def last_sync_counts() -> dict:
    """The last launch's own counts: ``grid_barriers`` (the kernel has none),
    ``items``, ``closed_waits`` (items whose waits found a flag still closed)
    and ``slot_waits`` (the weight producers' waits for a free ring slot).
    Reads the card, so it waits for the launch; nothing on the serving path
    calls it."""
    if not _last:
        raise RuntimeError("fused_decode_codebooks has not launched its kernel")
    words = _last[0][4 * SYNC_OUT:8 * SYNC_OUT].view(torch.int32).tolist()
    return {k: int(v) & 0xFFFFFFFF for k, v in zip(SYNC_NAMES, words)}


def item_count(qdec: dict, config: CSMConfig, B: int) -> int:
    """Work items of one frame at batch ``B``, as the kernel counts them: an
    ``item_ns`` trace takes :data:`TRACE_SLOTS` int64 for each."""
    n = _lib().fd_item_count(*_shape_args(qdec, config, B))
    if n < 0:
        raise ValueError(f"item_count: {_lib().fd_error_string(-n).decode()}")
    return n


def _shape_args(qdec: dict, config: CSMConfig, B: int):
    """``(B, N, D, L, nq, nkv, hd, F, Va, Va_pad, head_kind)`` as the C side
    takes them."""
    dcfg = config.decoder
    head = qdec["audio_head"]
    return (B, config.audio_num_codebooks, dcfg.hidden_size, qdec["w"]["wqkv"].shape[0],
            dcfg.num_attention_heads, dcfg.num_key_value_heads, dcfg.head_dim,
            dcfg.intermediate_size, config.audio_vocab_size, head.shape[-1],
            _HEAD_KINDS.get(head.dtype, -1))


def fused_decode_codebooks(
    qdec: dict,
    config: CSMConfig,
    x0: torch.Tensor,
    c0_logits: torch.Tensor,
    gumbel: torch.Tensor,
    temperature: torch.Tensor,
    topk: torch.Tensor,
    greedy: bool,
    forced: Optional[torch.Tensor] = None,
    return_logits: bool = False,
    stage_ns: Optional[torch.Tensor] = None,
    item_ns: Optional[torch.Tensor] = None,
):
    """All codebooks of one frame, ``[B, N]`` int64.  CPU tensors take the
    plain version; CUDA tensors launch the kernel (and raise on what it does
    not take).  ``temperature [B]``, ``topk [B]`` in [1, Va]; ``forced [B, N]``
    pins tokens (-1 draws).  ``return_logits`` also returns the logits
    ``[N, B, Va_pad]`` and the draws before forcing ``[B, N]``.  ``stage_ns``
    (int64 on the kernel's device, :func:`stage_count` elements) receives
    block 0's clock in ns at its start and as it leaves each stage of the
    frame's list; ``item_ns`` (int64, :data:`TRACE_SLOTS` per item of
    :func:`item_count`) each work item's stage, start, end of its waits, marks
    inside it and end.  :func:`last_sync_counts` reads the launch's counters.
    ``fused_decode_codebooks.launches`` counts kernel launches."""
    B, dev = x0.shape[0], x0.device
    N = config.audio_num_codebooks
    if forced is None:
        forced = torch.full((B, N), -1, dtype=torch.long, device=dev)
    if dev.type == "cpu" and stage_ns is None and item_ns is None:
        samples, logits, draws = decode_codebooks_reference(
            qdec, config, x0, c0_logits, gumbel, temperature, topk, greedy, forced)
        return (samples, logits, draws) if return_logits else samples
    if dev.type != "cuda":
        raise ValueError(f"fused_decode_codebooks: unsupported device {dev} (stage_ns and "
                         "item_ns need the kernel)")
    shapes = _shape_args(qdec, config, B)
    _, _, D, L, nq, nkv, hd, Fi, Va, Va_pad, head_kind = shapes
    emb = qdec["proj_emb"]
    _check_shapes(B, N, D, Fi, nq, nkv, hd, Va_pad, None if head_kind < 0 else head_kind)
    if emb.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_decode_codebooks kernel: embeddings {emb.dtype} (bf16 or f32)")
    if stage_ns is not None and (stage_ns.device != dev or stage_ns.dtype != torch.int64
                                 or stage_ns.numel() < stage_count(N, L)):
        raise ValueError(f"stage_ns: an int64 tensor on the kernel's device of at least "
                         f"{stage_count(N, L)} elements")
    if item_ns is not None and (item_ns.device != dev or item_ns.dtype != torch.int64):
        raise ValueError(f"item_ns: an int64 tensor on the kernel's device, {TRACE_SLOTS} per "
                         "work item")
    f32, i32 = torch.float32, torch.int32

    def c(x, dtype):
        return x.to(device=dev, dtype=dtype).contiguous()

    temp, k, frc = c(temperature, f32), c(topk, i32), c(forced, i32)
    x0, c0 = c(x0, f32), c(bf16_round(c0_logits), f32)
    gum = c(gumbel, f32)
    w, s = qdec["w"], qdec["s"]
    head = qdec["audio_head"]
    hs = qdec.get("head_scale", torch.ones((1,), dtype=f32, device=dev))
    lib = _lib()
    key = (dev, *shapes)
    sc = _SCRATCH.get(key)
    if sc is None:
        n = lib.fd_scratch_bytes(*shapes)
        if n < 0:
            raise ValueError(f"fused_decode_codebooks kernel: {lib.fd_error_string(-n).decode()}")
        sc = _SCRATCH[key] = [torch.zeros((n,), dtype=torch.uint8, device=dev), 0]
    sc[1] = (sc[1] + 1) & 0xFFFFFFFF
    epoch = sc[1] - (1 << 32) if sc[1] >= 1 << 31 else sc[1]
    samples = torch.empty((B, N), dtype=i32, device=dev)
    out_logits = torch.empty((N, B, Va_pad), dtype=f32, device=dev) if return_logits else None
    out_draws = torch.empty((B, N), dtype=i32, device=dev) if return_logits else None

    def ptr(x):
        return None if x is None else x.data_ptr()

    with span("csm.k2.launch", B=B):
        rc = lib.fused_decode(
            temp.data_ptr(), k.data_ptr(), frc.data_ptr(), x0.data_ptr(), c0.data_ptr(),
            w["wqkv"].data_ptr(), w["wo"].data_ptr(), w["w_gu"].data_ptr(), w["w_down"].data_ptr(),
            s["wqkv"].data_ptr(), s["wo"].data_ptr(), s["w_gu"].data_ptr(), s["w_down"].data_ptr(),
            qdec["cos"].data_ptr(), qdec["sin"].data_ptr(), head.data_ptr(), hs.data_ptr(),
            gum.data_ptr(), emb.data_ptr(), samples.data_ptr(), ptr(out_logits), ptr(out_draws),
            sc[0].data_ptr(), ptr(stage_ns), ptr(item_ns), sc[0].numel(),
            0 if item_ns is None else item_ns.numel(),
            B, N, Va, Va_pad, D, L, nq, nkv, hd, Fi, int(greedy), head_kind,
            int(emb.dtype == torch.bfloat16), epoch, float(config.decoder.rms_norm_eps),
            _build.stream_handle(dev),
        )
    if rc >= _REFUSED:
        raise ValueError(f"fused_decode_codebooks kernel (B={B}): {lib.fd_error_string(rc).decode()}")
    if rc != 0:
        raise RuntimeError(f"fused_decode_codebooks launch failed: {lib.fd_error_string(rc).decode()}")
    _last[:] = [sc[0]]
    fused_decode_codebooks.launches += 1
    samples = samples.long()
    if return_logits:
        return samples, out_logits, out_draws.long()
    return samples


fused_decode_codebooks.launches = 0


def decode_frame_fused(
    params: dict,
    qdec: dict,
    config: CSMConfig,
    last_h: torch.Tensor,  # [B, D]
    c0_logits: torch.Tensor,  # [B, Va]
    gumbel: torch.Tensor,  # [N, B, Va]: this frame's noise table
    temperature,
    topk,
    greedy: bool,
    *,
    greedy_rows: Optional[torch.Tensor] = None,  # [B] bool
    forced: Optional[torch.Tensor] = None,  # [B, N], -1 = draw
) -> torch.Tensor:
    """One frame's codebooks ``[B, N]`` through :func:`fused_decode_codebooks`.
    ``temperature`` / ``topk`` may be per-row; ``greedy_rows`` as in
    :func:`row_params`."""
    temp, k, gumbel = row_params(last_h.shape[0], config.audio_vocab_size, temperature, topk,
                                 gumbel, greedy_rows)
    x0 = (last_h @ params["projection"]).float()
    return fused_decode_codebooks(qdec, config, x0, c0_logits.float(), gumbel, temp, k, greedy,
                                  forced=forced)
