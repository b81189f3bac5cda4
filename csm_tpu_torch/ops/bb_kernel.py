"""The backbone decode step (counterpart of
``csm_tpu/ops/bb_kernel.py::bb_decode_step``) in three tiers, each a CUDA
kernel beside its plain PyTorch version, each one persistent launch a step
on the machinery of ``csrc/bb_step.cuh``:

- ``bits=16``, the exact tier (``csrc/bb_decode.cu``, ``B <= 8``): every bf16
  rounding sits where the plain bf16 path (:mod:`csm_tpu_torch.models.llama`)
  rounds, so its tokens are the plain path's;
- ``bits=8``, the int8 tier (``csrc/bb_decode_q.cu``, ``B <= 32``): W8A16 with
  int8 per-output-channel weights, the RMSNorm weights folded in (RMSNorm's
  per-row scale multiplies the products' outputs) and an f32 residual;
- ``bits=4``, the int4 tier (same source, ``B <= 32``): W4A16 with the layer
  weights row-packed int4, a per-column scale and a per-row equilibration
  ``u`` applied to each product's activation before its bf16 rounding; the
  c0 head stays int8.

One step runs the frame's embedding sum through the 16 backbone layers, the
final norm and the codebook-0 head.  It returns the normed hidden, the c0
logits and the new K/V rows, and never writes the cache:
:func:`csm_tpu_torch.models.csm.forward_decode_streamed` scatters the rows.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from csm_tpu_torch.config import CSMConfig
from csm_tpu_torch.ops import _build
from csm_tpu_torch.ops.fused_decoder import bf16_round, rms_scale
from csm_tpu_torch.ops.quant import qmm, quantize_per_channel
from csm_tpu_torch.ops.rope import apply_rope
from csm_tpu_torch.utils.profiling import span

NEG_INF = -1e9
KERNEL = "bb_decode"
KERNEL_Q = "bb_decode_q"
# Largest batches routed through the kernels (the JAX tiers' validated caps);
# larger batches take the plain path.
MAX_VALIDATED_B_EXACT = 8
MAX_VALIDATED_B = 32


def pack_int4_rows(q: torch.Tensor) -> torch.Tensor:
    """Pack nibble values ``[-8, 7]`` of ``[..., K, N]`` into int8 bytes
    ``[..., K/2, N]``: byte row ``i`` is ``(q[2i+1] << 4) | (q[2i] & 0xF)``."""
    lo = q[..., 0::2, :].to(torch.int32) & 0xF
    hi = (q[..., 1::2, :].to(torch.int32) & 0xF) << 4
    return (lo | hi).to(torch.uint8).view(torch.int8)


def unpack_int4_rows(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4_rows`: int8 ``[..., K/2, N]`` to int8
    ``[..., K, N]`` with the nibbles sign-extended."""
    b = p.view(torch.uint8).to(torch.int32)
    lo = b & 0xF
    lo = lo - 16 * (lo >> 3)
    hi = b >> 4
    hi = hi - 16 * (hi >> 3)
    out = torch.stack([lo, hi], dim=-2)  # [..., K/2, 2, N]
    return out.reshape(*p.shape[:-2], 2 * p.shape[-2], p.shape[-1]).to(torch.int8)


def quantize_int4_equilibrated(w: torch.Tensor):
    """Symmetric int4 quantization of ``[..., K, N]`` with per-row
    equilibration, ``w ~ diag(u) unpack(q) diag(s)``: each row divided by its
    largest magnitude ``u``, then a per-column scale onto the grid ``[-7,
    7]`` (half to even).  ``u`` is exact algebra: the product applies it to
    its activation.  Divides as the JAX package's function does.  Returns
    ``(q packed int8 [..., K/2, N], s f32 [..., 1, N], u f32 [..., 1, K])``."""
    wf = w.float()
    u = wf.abs().amax(dim=-1, keepdim=True)  # [..., K, 1]
    u = torch.where(u > 0, u, torch.ones_like(u))
    wn = wf / u
    amax = wn.abs().amax(dim=-2, keepdim=True)  # [..., 1, N]
    s = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wn / s), -7, 7).to(torch.int8)
    return pack_int4_rows(q), s, u.transpose(-1, -2)


def prepare_streamed_backbone(params: dict, config: CSMConfig, bits: int = 16) -> dict:
    """A tier's weight bundle, heads in the standard layout (the TPU
    kernel's rotary-half column permutation is a TPU layout and is left out).

    ``bits=16``: per layer bf16 ``wqkv = [wq|wk|wv]``, ``w_gu =
    [w_gate|w_up]``, ``wo``, ``w_down``, the c0 head padded to a multiple of
    128 columns, and the norm weights in f32.  No norm is folded into a
    weight, so the weights keep their values.

    ``bits=8``: the same four families with the RMSNorm weights folded into
    ``wqkv`` and ``w_gu``, int8 per output channel (``"w"``, scales ``[L, 1,
    N]`` in ``"s"``); the c0 head with the final norm folded in, int8 and
    padded (scale 1 on the padding); ``final_norm`` in f32.

    ``bits=4``: the families of ``bits=8`` through
    :func:`quantize_int4_equilibrated` (``"w"`` packed ``[L, K/2, N]``,
    ``"s"`` ``[L, 1, N]``, ``"u"`` ``[L, 1, K]``; the fused q/k/v and
    gate/up share one ``u`` over their concatenated columns); the head as at
    ``bits=8``."""
    if bits not in (4, 8, 16):
        raise ValueError(f"bits must be 4, 8, or 16, got {bits}")
    bl = params["backbone"]["layers"]
    bf = torch.bfloat16
    Va = config.audio_vocab_size
    Va_pad = -(-Va // 128) * 128
    if bits in (4, 8):
        attn_nw = bl["attn_norm"].float()[:, :, None]
        mlp_nw = bl["mlp_norm"].float()[:, :, None]
        fam = {
            "wqkv": torch.cat([bl[n].float() * attn_nw for n in ("wq", "wk", "wv")], dim=-1),
            "wo": bl["wo"].float(),
            "w_gu": torch.cat([bl[n].float() * mlp_nw for n in ("w_gate", "w_up")], dim=-1),
            "w_down": bl["w_down"].float(),
        }
        out = {"w": {}, "s": {}}
        if bits == 4:
            out["u"] = {}
        for name, w in fam.items():
            if bits == 4:
                q, sc, u = quantize_int4_equilibrated(w)
                out["u"][name] = u.contiguous()
            else:
                q, sc = quantize_per_channel(w)
            out["w"][name], out["s"][name] = q.contiguous(), sc.contiguous()
        fnw = params["backbone"]["final_norm"].float()
        hq, hs = quantize_per_channel(params["codebook0_head"].float() * fnw[:, None])
        out["w"]["head"] = F.pad(hq, (0, Va_pad - Va)).contiguous()
        out["s"]["head"] = F.pad(hs, (0, Va_pad - Va), value=1.0).contiguous()
        out["final_norm"] = fnw.contiguous()
        return out
    return {
        "wqkv": torch.cat([bl["wq"], bl["wk"], bl["wv"]], dim=-1).to(bf).contiguous(),
        "w_gu": torch.cat([bl["w_gate"], bl["w_up"]], dim=-1).to(bf).contiguous(),
        "wo": bl["wo"].to(bf).contiguous(),
        "w_down": bl["w_down"].to(bf).contiguous(),
        "head": F.pad(params["codebook0_head"].to(bf), (0, Va_pad - Va)).contiguous(),
        "attn_nw": bl["attn_norm"].float().contiguous(),
        "mlp_nw": bl["mlp_norm"].float().contiguous(),
        "final_norm": params["backbone"]["final_norm"].float().contiguous(),
    }


def _mm(x: torch.Tensor, w: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """bf16-valued operands, products and sums in ``acc``, returned as f32."""
    return (x.to(acc) @ w.to(acc)).float()


# The plain version's bf16 rounding points, in the order a layer meets them.
ROUNDING_POINTS = (
    "norm", "norm_weight", "qkv", "rope", "probs", "attn", "o_proj", "residual",
    "gate_up", "sigmoid", "silu", "gated", "down", "logits",
)


def _rounder(unrounded: frozenset):
    """``r(x, point)``: ``x`` rounded to bf16 unless ``point`` is left out."""
    bad = set(unrounded) - set(ROUNDING_POINTS)
    if bad:
        raise ValueError(f"unknown rounding points {sorted(bad)}")
    return lambda x, point: x if point in unrounded else bf16_round(x)


def _rmsnorm(h: torch.Tensor, w: torch.Tensor, eps: float, r) -> torch.Tensor:
    """The plain bf16 path's RMSNorm on a bf16-valued f32 residual: two
    rounding points, after the normalisation and after the weight."""
    var = (h * h).mean(dim=-1, keepdim=True)
    return r(r(h * torch.rsqrt(var + eps), "norm") * w, "norm_weight")


def bb_layer_reference(
    qsb: dict,
    config: CSMConfig,
    l: int,
    h: torch.Tensor,  # [B, D] f32, bf16-valued residual entering layer l
    cos: torch.Tensor,
    sin: torch.Tensor,
    bias_w: torch.Tensor,
    k_cache: torch.Tensor,  # [B, W, nkv, hd]: layer l's window
    v_cache: torch.Tensor,
    acc: torch.dtype = torch.float32,
    unrounded: frozenset = frozenset(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer of :func:`bb_decode_step_reference`: returns the residual
    leaving layer ``l`` and its new K/V rows (bf16-valued f32)."""
    bcfg = config.backbone
    Fi = bcfg.intermediate_size
    nq, nkv, hd = bcfg.num_attention_heads, bcfg.num_key_value_heads, bcfg.head_dim
    eps = bcfg.rms_norm_eps
    g = nq // nkv
    B = h.shape[0]
    scale = 1.0 / float(hd) ** 0.5
    ok = torch.cat([bias_w >= 0, torch.ones((B, 1), dtype=torch.bool, device=h.device)], dim=1)

    r = _rounder(unrounded)
    xn = _rmsnorm(h, qsb["attn_nw"][l], eps, r)
    qkv = r(_mm(xn, qsb["wqkv"][l], acc), "qkv")
    q = qkv[:, : nq * hd].reshape(B, nq, hd)
    k = qkv[:, nq * hd: (nq + nkv) * hd].reshape(B, nkv, hd)
    v = qkv[:, (nq + nkv) * hd:].reshape(B, nkv, hd)
    q = r(apply_rope(q, cos, sin), "rope")
    k = r(apply_rope(k, cos, sin), "rope")
    keys = torch.cat([k_cache.to(acc), k[:, None].to(acc)], dim=1)  # [B, W+1, nkv, hd]
    vals = torch.cat([v_cache.to(acc), v[:, None].to(acc)], dim=1)
    scores = torch.einsum("bngh,btnh->bngt", q.reshape(B, nkv, g, hd).to(acc), keys).float()
    scores = torch.where(ok[:, None, None], scores * scale, torch.full_like(scores, NEG_INF))
    probs = r(torch.softmax(scores, dim=-1), "probs")
    attn = torch.einsum("bngt,btnh->bngh", probs.to(acc), vals).float()
    attn = r(attn, "attn").reshape(B, nq * hd)
    h = r(h + r(_mm(attn, qsb["wo"][l], acc), "o_proj"), "residual")

    xn = _rmsnorm(h, qsb["mlp_nw"][l], eps, r)
    gu = r(_mm(xn, qsb["w_gu"][l], acc), "gate_up")
    gt, up = gu[:, :Fi], gu[:, Fi:]
    gated = r(r(gt * r(torch.sigmoid(gt), "sigmoid"), "silu") * up, "gated")
    h = r(h + r(_mm(gated, qsb["w_down"][l], acc), "down"), "residual")
    return h, k, v


def bb_decode_step_reference(
    qsb: dict,
    config: CSMConfig,
    h0: torch.Tensor,  # [B, D] f32, bf16-valued
    cos: torch.Tensor,  # [B, hd] f32
    sin: torch.Tensor,  # [B, hd] f32
    bias_w: torch.Tensor,  # [B, W] f32: 0 usable, NEG_INF masked
    k_cache: torch.Tensor,  # [L, B, W, nkv, hd] bf16
    v_cache: torch.Tensor,
    acc: torch.dtype = torch.float32,
    unrounded: frozenset = frozenset(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version, op for op at the kernel's rounding points, over
    the bundle's layers.  ``acc`` is the type products are summed in (f32
    as in the kernel; f64 gives a second, equally rounded evaluation).
    ``unrounded`` names rounding points (:data:`ROUNDING_POINTS`) to leave
    out: a faulty version that a check of the kernel must be able to tell
    apart.  Returns ``(normed_h [B, D] f32, c0_logits [B, Va] f32,
    new_k [L, B, nkv, hd] bf16, new_v)``."""
    h = h0.float()
    new_k, new_v = [], []
    for l in range(qsb["wqkv"].shape[0]):
        h, k, v = bb_layer_reference(
            qsb, config, l, h, cos, sin, bias_w, k_cache[l], v_cache[l], acc, unrounded
        )
        new_k.append(k)
        new_v.append(v)
    r = _rounder(unrounded)
    nh = _rmsnorm(h, qsb["final_norm"], config.backbone.rms_norm_eps, r)
    logits = r(_mm(nh, qsb["head"], acc), "logits")[:, : config.audio_vocab_size]
    bf = torch.bfloat16
    return nh, logits, torch.stack(new_k).to(bf), torch.stack(new_v).to(bf)


def bb_decode_step(
    qsb: dict,
    config: CSMConfig,
    h0: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    bias_w: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    stage_ns: Optional[torch.Tensor] = None,
    item_ns: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One backbone decode step.  A ``bits=4`` bundle (it carries ``"u"``)
    goes to :func:`bb_decode_step_q4`, a ``bits=8`` bundle (scales, ``"s"``)
    to :func:`bb_decode_step_q`.  A ``bits=16`` bundle: CPU tensors take the
    plain version; CUDA tensors launch ``csrc/bb_decode.cu``, one persistent
    kernel (and raise on what it does not take); ``stage_ns`` and ``item_ns``
    receive its traces (see :func:`_launch`).  ``bb_decode_step.launches``
    counts the exact kernel's launches."""
    if "u" in qsb:
        return bb_decode_step_q4(qsb, config, h0, cos, sin, bias_w, k_cache, v_cache, stage_ns,
                                 item_ns)
    if "s" in qsb:
        return bb_decode_step_q(qsb, config, h0, cos, sin, bias_w, k_cache, v_cache, stage_ns,
                                item_ns)
    if h0.device.type == "cpu" and stage_ns is None and item_ns is None:
        return bb_decode_step_reference(qsb, config, h0, cos, sin, bias_w, k_cache, v_cache)
    if h0.device.type != "cuda":
        raise ValueError(f"bb_decode_step: unsupported device {h0.device} (stage_ns needs the "
                         "kernel)")
    out = _launch(qsb, config, h0, cos, sin, bias_w, k_cache, v_cache, "bb_decode_step",
                  stage_ns, item_ns)
    bb_decode_step.launches += 1
    return out


bb_decode_step.launches = 0


# ---------------------------------------------------------------------------
# The int8 and int4 tiers (bits=8, bits=4)
# ---------------------------------------------------------------------------


def bbq_layer_reference(
    qsb: dict,
    config: CSMConfig,
    l: int,
    h: torch.Tensor,  # [B, D] f32 residual entering layer l
    cos: torch.Tensor,
    sin: torch.Tensor,
    bias_w: torch.Tensor,
    k_cache: torch.Tensor,  # [B, W, nkv, hd]: layer l's window
    v_cache: torch.Tensor,
    acc: torch.dtype = torch.float32,
    act: torch.dtype = torch.bfloat16,
    prescale: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer of :func:`bb_decode_step_q_reference`: the residual leaving
    layer ``l`` and its new K/V rows (bf16)."""
    bcfg = config.backbone
    nq, nkv, hd = bcfg.num_attention_heads, bcfg.num_key_value_heads, bcfg.head_dim
    Fi, eps = bcfg.intermediate_size, bcfg.rms_norm_eps
    B, bf = h.shape[0], torch.bfloat16
    s, u = qsb["s"], qsb.get("u")

    def w(name):
        return qsb["w"][name][l] if u is None else unpack_int4_rows(qsb["w"][name][l])

    def pre(x, name):
        """The product's activation: times the int4 tier's ``u`` before its
        rounding (left out with ``prescale=False``, a faulty version)."""
        return x if u is None or not prescale else x * u[name][l]

    ok = torch.cat([bias_w >= 0, torch.ones((B, 1), dtype=torch.bool, device=h.device)], dim=1)
    qkv = qmm(pre(h, "wqkv"), w("wqkv"), s["wqkv"][l], acc, act) * rms_scale(h, eps)
    q = apply_rope(qkv[:, :nq * hd].reshape(B, nq, hd), cos, sin)
    k = apply_rope(qkv[:, nq * hd:(nq + nkv) * hd].reshape(B, nkv, hd), cos, sin).to(bf)
    v = qkv[:, (nq + nkv) * hd:].reshape(B, nkv, hd).to(bf)
    keys = torch.cat([k_cache, k[:, None]], dim=1).to(acc)  # [B, W+1, nkv, hd]
    vals = torch.cat([v_cache, v[:, None]], dim=1).to(acc)
    qg = q.to(act).to(acc).reshape(B, nkv, nq // nkv, hd)
    scores = torch.einsum("bngh,btnh->bngt", qg, keys).float() * (1.0 / float(hd) ** 0.5)
    scores = torch.where(ok[:, None, None], scores, torch.full_like(scores, NEG_INF))
    e = torch.exp(scores - scores.max(dim=-1, keepdim=True).values)
    probs = (e / e.sum(dim=-1, keepdim=True)).to(bf).to(acc)
    attn = torch.einsum("bngt,btnh->bngh", probs, vals).float().reshape(B, nq * hd)
    h = h + qmm(pre(attn, "wo"), w("wo"), s["wo"][l], acc, act)
    gu = qmm(pre(h, "w_gu"), w("w_gu"), s["w_gu"][l], acc, act) * rms_scale(h, eps)
    gt, up = gu[:, :Fi], gu[:, Fi:]
    gated = pre(gt * torch.sigmoid(gt) * up, "w_down")
    h = h + qmm(gated, w("w_down"), s["w_down"][l], acc, act)
    return h, k, v


def bb_decode_step_q_reference(
    qsb: dict,
    config: CSMConfig,
    h0: torch.Tensor,  # [B, D] f32
    cos: torch.Tensor,  # [B, hd] f32
    sin: torch.Tensor,
    bias_w: torch.Tensor,  # [B, W] f32: 0 usable, NEG_INF masked
    k_cache: torch.Tensor,  # [L, B, W, nkv, hd] bf16
    v_cache: torch.Tensor,
    acc: torch.dtype = torch.float32,
    act: torch.dtype = torch.bfloat16,
    prescale: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the int8 and int4 steps, the JAX emulator's int8
    and int4 arithmetic op for op in the standard head layout: an f32
    residual; each pre-norm product on bf16(h) (int4: bf16(h u)) times
    RMSNorm's per-row scale; RoPE in f32; attention with bf16 q, K/V and
    probabilities, f32 scores and softmax; SwiGLU in f32; the o and down
    products on bf16(attn) and bf16(gated) (int4: times ``u`` first); the
    int8 head on bf16(h).  ``acc`` is the type products sum in; ``act`` the
    type activations are rounded to before each product and the score dot
    (bf16; f32 gives a faulty version that a check of the kernel must tell
    apart); ``prescale=False`` leaves the int4 ``u`` out (another faulty
    version).  Returns ``(normed_h [B, D] f32, c0_logits [B, Va] f32, new_k
    [L, B, nkv, hd] bf16, new_v)``."""
    h = h0.float()
    new_k, new_v = [], []
    for l in range(qsb["w"]["wqkv"].shape[0]):
        h, k, v = bbq_layer_reference(qsb, config, l, h, cos, sin, bias_w, k_cache[l],
                                      v_cache[l], acc, act, prescale)
        new_k.append(k)
        new_v.append(v)
    rs = rms_scale(h, config.backbone.rms_norm_eps)
    nh = h * rs * qsb["final_norm"]
    logits = bf16_round(qmm(h, qsb["w"]["head"], qsb["s"]["head"], acc, act) * rs)
    return nh, logits[:, :config.audio_vocab_size], torch.stack(new_k), torch.stack(new_v)


# ---------------------------------------------------------------------------
# The kernels' launch (every tier)
# ---------------------------------------------------------------------------


_F = ctypes.c_void_p
_TAIL = [ctypes.c_longlong] * 2 + [ctypes.c_int] * 10 + [ctypes.c_float, _F]
# The C functions of csrc/bb_decode.cu and csrc/bb_decode_q.cu: (argtypes,
# restype).
SIGNATURES = {
    "bb_decode_step": ([_F] * 21 + _TAIL, ctypes.c_int),
    "bb_scratch_bytes": ([ctypes.c_int] * 8, ctypes.c_longlong),
    "bb_item_count": ([ctypes.c_int] * 8, ctypes.c_longlong),
    "bb_error_string": ([ctypes.c_int], ctypes.c_char_p),
}
_Q_SHAPES = ([ctypes.c_int] * 9, ctypes.c_longlong)
SIGNATURES_Q = {
    "bb_decode_q_step": ([_F] * 24 + _TAIL, ctypes.c_int),
    "bb_decode_q4_step": ([_F] * 28 + _TAIL, ctypes.c_int),
    "bbq_scratch_bytes": _Q_SHAPES,
    "bbq_item_count": _Q_SHAPES,
    "bbq_error_string": ([ctypes.c_int], ctypes.c_char_p),
}

# Int64 slots a work item takes in the kernels' item trace (the C side
# refuses a shorter buffer): its stage (numbered as ``stage_ns``), start,
# end of its waits, four marks inside it (0 where it has none), end.
TRACE_SLOTS = 8
# Return codes from this one on are arguments the kernels refuse (shapes, a
# window too long for their shared memory, a short buffer):
# csrc/bb_step.cuh ``Refused``.
_REFUSED = 10001


def _lib():
    return _build.load(KERNEL, SIGNATURES)


def _lib_q():
    return _build.load(KERNEL_Q, SIGNATURES_Q)


def _bits(qsb: dict) -> int:
    """The tier of a bundle: 4 (it carries ``"u"``), 8 (scales) or 16."""
    return 4 if "u" in qsb else 8 if "s" in qsb else 16


# Scratch kept across calls of the same tier and shapes on the same device:
# one byte buffer the kernel lays out (residual, operands, split partials,
# per-item flags and tickets), zeroed once here, and the launch epoch.
# Flags are stamped with the epoch and tickets re-arm themselves, so nothing
# is cleared between launches.  Calls on one device are ordered by its
# stream, which the scratch assumes.
_SCRATCH: dict = {}


def stage_count(L: int) -> int:
    """Stamps a ``stage_ns`` buffer takes: block 0's start, then the end of
    each stage (init; per layer QKV, attention, o-proj, gate-up, down; the
    head; the final norm)."""
    return 5 * L + 4


def _shape_args(qsb: dict, config: CSMConfig, B: int):
    """``(B, D, nq, nkv, hd, F, n_head, L)`` as the C side takes them."""
    bc = config.backbone
    w = qsb if _bits(qsb) == 16 else qsb["w"]
    return (B, bc.hidden_size, bc.num_attention_heads, bc.num_key_value_heads, bc.head_dim,
            bc.intermediate_size, w["head"].shape[1], w["wqkv"].shape[0])


def item_count(qsb: dict, config: CSMConfig, B: int) -> int:
    """Work items of one step of bundle ``qsb`` (any tier) at batch ``B``, as
    the kernel counts them: an ``item_ns`` trace takes :data:`TRACE_SLOTS`
    int64 for each."""
    bits = _bits(qsb)
    lib = _lib() if bits == 16 else _lib_q()
    if bits == 16:
        n, err = lib.bb_item_count(*_shape_args(qsb, config, B)), lib.bb_error_string
    else:
        n, err = lib.bbq_item_count(*_shape_args(qsb, config, B), bits), lib.bbq_error_string
    if n < 0:
        raise ValueError(f"item_count: {err(-n).decode()}")
    return n


def _check_shapes(name, bits, B, D, Fi, nq, nkv, hd, n_head):
    """ValueError naming the limit the tier's kernel does not take (the
    window's limit, which depends on the card's shared memory, comes back
    from the launch)."""
    b_max = MAX_VALIDATED_B_EXACT if bits == 16 else MAX_VALIDATED_B
    kr = {16: 64, 8: 128, 4: 256}[bits]  # K rows of a 16 KB weight chunk
    if not 1 <= B <= b_max:
        raise ValueError(f"{name} kernel: unsupported B={B}, outside 1..{b_max}")
    if nkv <= 0 or nq % nkv or nq // nkv > 8:
        raise ValueError(f"{name} kernel: heads {nq}/{nkv} (a GQA group of at most 8)")
    if hd not in (16, 32, 64, 128):
        raise ValueError(f"{name} kernel: head_dim {hd} (16, 32, 64 or 128: heads tile 128 columns)")
    if D % 128 or n_head % 128 or Fi % 64:
        raise ValueError(f"{name} kernel: D={D} and the head's {n_head} columns must be multiples "
                         f"of 128, F={Fi} of 64")
    if D % kr or (nq * hd) % kr or Fi % kr:
        raise ValueError(f"{name} kernel: D={D}, nq*hd={nq * hd} and F={Fi} must be multiples of "
                         f"{kr} (whole weight chunks)")
    if B * (D // 128) > 1024:
        raise ValueError(f"{name} kernel: B={B} x D/128={D // 128} tile sums of squares > 1024")


def _launch(qsb, config, h0, cos, sin, bias_w, k_cache, v_cache, name: str, stage_ns=None,
            item_ns=None):
    """Launch the step of the bundle's tier (``csrc/bb_decode.cu`` for
    ``bits=16``, ``csrc/bb_decode_q.cu`` for 8 and 4) on CUDA tensors; raises
    on what the kernel does not take.  ``stage_ns`` (int64,
    :func:`stage_count` elements, on the device) receives block 0's trace;
    ``item_ns`` (int64, :data:`TRACE_SLOTS` per item of :func:`item_count`)
    each work item's stage, start, end of its waits, four marks inside it and
    end."""
    bits = _bits(qsb)
    bcfg = config.backbone
    B, D, nq, nkv, hd, Fi, n_head, L = _shape_args(qsb, config, h0.shape[0])
    W = k_cache.shape[2]
    _check_shapes(name, bits, B, D, Fi, nq, nkv, hd, n_head)
    if k_cache.dtype != torch.bfloat16 or v_cache.dtype != torch.bfloat16:
        raise ValueError(f"{name} kernel takes a bf16 KV cache")
    if tuple(k_cache.shape) != (L, B, W, nkv, hd) or v_cache.shape != k_cache.shape:
        raise ValueError(f"{name} kernel: cache shape {tuple(k_cache.shape)}")
    if bits == 4 and tuple(qsb["w"]["wqkv"].shape[1:]) != (D // 2, (nq + 2 * nkv) * hd):
        raise ValueError(f"{name} kernel: packed wqkv shape {tuple(qsb['w']['wqkv'].shape)}")
    dev = h0.device
    if stage_ns is not None and (stage_ns.device != dev or stage_ns.dtype != torch.int64
                                 or stage_ns.numel() < stage_count(L)):
        raise ValueError(f"stage_ns: an int64 tensor on the kernel's device of at least "
                         f"{stage_count(L)} elements")
    if item_ns is not None and (item_ns.device != dev or item_ns.dtype != torch.int64):
        raise ValueError(f"item_ns: an int64 tensor on the kernel's device, {TRACE_SLOTS} per "
                         "work item")
    f32, bf = torch.float32, torch.bfloat16

    def f(x):
        return x.to(device=dev, dtype=f32).contiguous()

    h0, cos, sin, bias_w = f(h0), f(cos), f(sin), f(bias_w)
    k_cache, v_cache = k_cache.contiguous(), v_cache.contiguous()
    lib = _lib() if bits == 16 else _lib_q()
    err = lib.bb_error_string if bits == 16 else lib.bbq_error_string
    key = (dev, bits, L, B, D, Fi, nq, nkv, hd, n_head)
    sc = _SCRATCH.get(key)
    if sc is None:
        shapes = (B, D, nq, nkv, hd, Fi, n_head, L)
        n = lib.bb_scratch_bytes(*shapes) if bits == 16 else lib.bbq_scratch_bytes(*shapes, bits)
        if n < 0:
            raise RuntimeError(f"{name}: {err(-n).decode()}")
        sc = _SCRATCH[key] = [torch.zeros((n,), dtype=torch.uint8, device=dev), 0]
    sc[1] = (sc[1] + 1) & 0xFFFFFFFF
    epoch = sc[1] - (1 << 32) if sc[1] >= 1 << 31 else sc[1]
    nh = torch.empty((B, D), dtype=f32, device=dev)
    logits = torch.empty((B, n_head), dtype=f32, device=dev)
    new_k = torch.empty((L, B, nkv, hd), dtype=bf, device=dev)
    new_v = torch.empty_like(new_k)
    fams = ("wqkv", "wo", "w_gu", "w_down")
    ptrs = [h0.data_ptr(), cos.data_ptr(), sin.data_ptr(), bias_w.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr()]
    if bits == 16:
        ptrs += [qsb[k].data_ptr() for k in (*fams, "head", "attn_nw", "mlp_nw")]
    else:
        w, s = qsb["w"], qsb["s"]
        ptrs += [w[k].data_ptr() for k in (*fams, "head")] + [s[k].data_ptr() for k in (*fams, "head")]
        if bits == 4:
            ptrs += [qsb["u"][k].data_ptr() for k in fams]
    ptrs += [qsb["final_norm"].data_ptr(), nh.data_ptr(), logits.data_ptr(), new_k.data_ptr(),
             new_v.data_ptr(), sc[0].data_ptr(), None if stage_ns is None else stage_ns.data_ptr(),
             None if item_ns is None else item_ns.data_ptr()]
    fn = (lib.bb_decode_step if bits == 16 else lib.bb_decode_q4_step if bits == 4
          else lib.bb_decode_q_step)
    with span("csm.bb.launch", B=B):
        rc = fn(*ptrs, sc[0].numel(), 0 if item_ns is None else item_ns.numel(), L, B, D, Fi,
                nq, nkv, hd, W, n_head, epoch, float(bcfg.rms_norm_eps),
                _build.stream_handle(dev))
    if rc >= _REFUSED:
        raise ValueError(f"{name} kernel (B={B}, W={W}): {err(rc).decode()}")
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {err(rc).decode()}")
    return nh, logits[:, :config.audio_vocab_size], new_k, new_v


def bb_decode_step_q(
    qsb: dict,
    config: CSMConfig,
    h0: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    bias_w: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    stage_ns: Optional[torch.Tensor] = None,
    item_ns: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One int8 backbone decode step.  CPU tensors take the plain version;
    CUDA tensors launch ``csrc/bb_decode_q.cu``, one persistent kernel (and
    raise on what it does not take); ``stage_ns`` and ``item_ns`` receive its
    traces (see :func:`_launch`).  ``bb_decode_step_q.launches`` counts kernel
    launches."""
    if "u" in qsb:
        raise ValueError("bb_decode_step_q takes an int8 bundle; int4 goes to bb_decode_step_q4")
    if h0.device.type == "cpu" and stage_ns is None and item_ns is None:
        return bb_decode_step_q_reference(qsb, config, h0, cos, sin, bias_w, k_cache, v_cache)
    if h0.device.type != "cuda":
        raise ValueError(f"bb_decode_step_q: unsupported device {h0.device} (stage_ns needs the "
                         "kernel)")
    out = _launch(qsb, config, h0, cos, sin, bias_w, k_cache, v_cache, "bb_decode_step_q",
                  stage_ns, item_ns)
    bb_decode_step_q.launches += 1
    return out


bb_decode_step_q.launches = 0


def bb_decode_step_q4(
    qsb: dict,
    config: CSMConfig,
    h0: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    bias_w: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    stage_ns: Optional[torch.Tensor] = None,
    item_ns: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One int4 backbone decode step (a ``bits=4`` bundle).  CPU tensors take
    the plain version (:func:`bb_decode_step_q_reference`, which reads the
    bundle's ``"u"``); CUDA tensors launch the int4 step of
    ``csrc/bb_decode_q.cu`` (and raise on what it does not take); ``stage_ns``
    as for :func:`bb_decode_step_q`.
    ``bb_decode_step_q4.launches`` counts kernel launches."""
    if "u" not in qsb:
        raise ValueError("bb_decode_step_q4 takes an int4 bundle (with \"u\")")
    if h0.device.type == "cpu" and stage_ns is None and item_ns is None:
        return bb_decode_step_q_reference(qsb, config, h0, cos, sin, bias_w, k_cache, v_cache)
    if h0.device.type != "cuda":
        raise ValueError(f"bb_decode_step_q4: unsupported device {h0.device} (stage_ns needs the "
                         "kernel)")
    out = _launch(qsb, config, h0, cos, sin, bias_w, k_cache, v_cache, "bb_decode_step_q4",
                  stage_ns, item_ns)
    bb_decode_step_q4.launches += 1
    return out


bb_decode_step_q4.launches = 0
