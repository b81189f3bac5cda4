"""GQA flash attention, forward and backward: the CUDA kernels
``csrc/flash_fwd.cu`` (K3, counterpart of
``csm_tpu/ops/flash_attention.py::_flash_kernel``) and ``csrc/flash_bwd.cu``
(K5a ``_flash_bwd_dq_kernel``, K5b ``_flash_bwd_dkv_kernel``), their plain
PyTorch versions, and the differentiable op that joins them.

On bf16 operands K3 and K5b run on the tensor cores (wgmma tiles fed by
TMA); on fp32 operands, and K5a on both, the kernels run on the CUDA cores
(wgmma has no fp32 operands).  The dispatch is by the operands' type.

Layout ``[B, S, heads, head_dim]`` as in the JAX package.  Queries start at
absolute position ``q_offset`` (0 for the prefill and one-device training;
``seq_rank * S_local`` for a shard of sequence-parallel training, whose keys
are the whole gathered sequence); keys are masked by ``key_valid [B, T]``
and, when ``causal``, by causality, with the finite ``NEG_INF`` so
that a query with no valid key (left padding) stays finite.  Such dead rows
are garbage by contract: the forward kernel gives them uniform weight over the
keys it visits, the plain version over all ``T`` keys; their log-sum-exp
rounds to exactly ``NEG_INF`` and the backward gives them exactly zero
gradient (their cotangent is zero in the training loss).

The backward is the FlashAttention-2 recompute scheme: the forward also
returns the per-row log-sum-exp ``lse [B, nq, S]`` in fp32, and the backward
recomputes ``p = exp(s - lse)`` block by block, with ``delta = rowsum(dO *
O)`` a plain fp32 reduction, as the JAX package computes it in XLA.
:func:`flash_attention` is differentiable in ``q``, ``k`` and ``v`` through
the op ``torch.ops.csm_tpu_torch.flash_attn`` (a ``torch.library`` custom op,
so that selective checkpointing can name it and keep its output: the
``"dots"`` remat policy of :mod:`csm_tpu_torch.models.llama`).

Under a ``q_offset`` every kernel walks the same key tiles from key 0 as the
unsharded launch, so a shard's forward output, log-sum-exp and dq rows are
bitwise equal to the unsharded kernel's rows (dead rows' output aside: it is
uniform over the keys visited, garbage by contract); dk / dv of a shard are
its share of the sum.  :func:`flash_attention_sp` is the attention of
sequence-parallel training: it gathers K / V over the mesh's ``seq`` group
and runs one causal call with this rank's offset.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from csm_tpu_torch.ops import _build

NEG_INF = -1e9
KERNEL = "flash_fwd"
BWD_KERNEL = "flash_bwd"
# What the kernels are instantiated for: operand types, head dims, query
# heads per kv head.
DTYPES = (torch.bfloat16, torch.float32)
HEAD_DIMS = (16, 32, 64)
GROUPS = (1, 2, 4)


def _scores(q, k, key_valid, causal: bool, q_offset: int = 0):
    """fp32 scores ``[B, nkv, g, S, T]`` with masked entries set to
    ``NEG_INF`` (query row ``s`` at position ``q_offset + s``); ``q`` grouped
    as ``[B, nkv, g, S, hd]``."""
    B, S, nq, hd = q.shape
    T, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    ok = key_valid.bool()[:, None, :].expand(B, S, T)
    if causal:
        dev = q.device
        pos = q_offset + torch.arange(S, device=dev)
        ok = ok & (torch.arange(T, device=dev)[None, :] <= pos[:, None])
    qg = q.reshape(B, S, nkv, g, hd).permute(0, 2, 3, 1, 4)
    scores = torch.einsum("bngsh,btnh->bngst", qg.float(), k.float())
    scores = scores * (1.0 / float(hd) ** 0.5)
    return torch.where(ok[:, None, None], scores, torch.full_like(scores, NEG_INF)), qg


def flash_attention_reference(
    q: torch.Tensor,  # [B, S, nq, hd]
    k: torch.Tensor,  # [B, T, nkv, hd]
    v: torch.Tensor,  # [B, T, nkv, hd]
    key_valid: torch.Tensor,  # [B, T] bool/int
    causal: bool = True,
    return_lse: bool = False,
    q_offset: int = 0,
):
    """The plain version: fp32 scores and softmax over the whole window,
    masked scores set to ``NEG_INF``, probabilities cast to ``v``'s dtype.
    Returns ``[B, S, nq, hd]`` in ``q``'s dtype and, with ``return_lse``,
    also ``lse = m + log(l)`` ``[B, nq, S]`` in fp32.  ``q_offset``: the
    absolute position of query row 0 (causal only)."""
    _check_offset(causal, q_offset)
    B, S, nq, hd = q.shape
    scores, _ = _scores(q, k, key_valid, causal, q_offset)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bngst,btnh->bngsh", probs, v)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, nq, hd).to(q.dtype)
    if not return_lse:
        return out
    m = scores.amax(dim=-1, keepdim=True)
    lse = (m + torch.log(torch.exp(scores - m).sum(dim=-1, keepdim=True)))[..., 0]
    return out, lse.reshape(B, nq, S)


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_valid: torch.Tensor,
    out: torch.Tensor,  # [B, S, nq, hd], the forward's output
    lse: torch.Tensor,  # [B, nq, S] fp32
    dout: torch.Tensor,  # [B, S, nq, hd]
    causal: bool = True,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain FlashAttention-2 backward, rounding where the kernels do:
    ``p = exp(s - lse)`` (0 on dead rows, ``lse <= NEG_INF / 2``),
    ``dP = dO.V^T`` and ``delta = rowsum(dO * O)`` in fp32, ``dS = p (dP -
    delta) scale`` and ``P~ = p`` cast to the operands' type before their
    products, all sums in fp32.  Returns ``(dq, dk, dv)`` in the operands'
    types."""
    _check_offset(causal, q_offset)
    return _bwd_plain(q, k, v, key_valid, dout, lse, _delta(out, dout), causal, q_offset)


def _delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``rowsum(dO * O)`` in fp32, ``[B, nq, S]``."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _bwd_plain(q, k, v, key_valid, dout, lse, delta, causal: bool, q_offset: int = 0):
    B, S, nq, hd = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    scale = 1.0 / float(hd) ** 0.5
    scores, qg = _scores(q, k, key_valid, causal, q_offset)  # [B,nkv,g,S,T]
    lse_g = lse.float().reshape(B, nkv, g, S)[..., None]
    p = torch.where(lse_g <= NEG_INF / 2, torch.zeros_like(scores), torch.exp(scores - lse_g))
    dog = dout.reshape(B, S, nkv, g, hd).permute(0, 2, 3, 1, 4)  # [B,nkv,g,S,hd]
    dp = torch.einsum("bngsh,btnh->bngst", dog.float(), v.float())
    ds = (p * (dp - delta.float().reshape(B, nkv, g, S)[..., None]) * scale).to(q.dtype).float()
    pt = p.to(dout.dtype).float()
    dq = torch.einsum("bngst,btnh->bngsh", ds, k.float())
    dk = torch.einsum("bngst,bngsh->btnh", ds, qg.float())
    dv = torch.einsum("bngst,bngsh->btnh", pt, dog.float())
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, S, nq, hd).to(q.dtype)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_offset(causal: bool, q_offset: int) -> None:
    """``q_offset`` is a position (``>= 0``) and only causal attention has
    one, as the JAX package asserts."""
    if q_offset < 0 or (q_offset and not causal):
        raise ValueError(f"q_offset must be >= 0 and only given with causal=True; got "
                         f"{q_offset} with causal={causal}")


_P, _I = ctypes.c_void_p, ctypes.c_int
# The C functions of csrc/flash_fwd.cu and csrc/flash_bwd.cu: (argtypes, restype).
FWD_SIGNATURES = {
    "flash_fwd": ([_P] * 6 + [_I] * 9 + [_P], _I),
    "flash_error_string": ([_I], ctypes.c_char_p),
}
BWD_SIGNATURES = {
    "flash_bwd_dq": ([_P] * 8 + [_I] * 9 + [_P], _I),
    "flash_bwd_dkv": ([_P] * 9 + [_I] * 9 + [_P], _I),
    "flash_bwd_error_string": ([_I], ctypes.c_char_p),
}


def _fwd_lib():
    return _build.load(KERNEL, FWD_SIGNATURES)


def _bwd_lib():
    return _build.load(BWD_KERNEL, BWD_SIGNATURES)


def _check_kernel_shapes(name: str, q, k, v, key_valid, *same_as_q) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    B, S, nq, hd = q.shape
    T, nkv = k.shape[1], k.shape[2]
    if not (
        q.dtype == k.dtype == v.dtype and q.dtype in DTYPES and v.shape == k.shape
        and hd in HEAD_DIMS and nq % nkv == 0 and nq // nkv in GROUPS
        and tuple(key_valid.shape) == (B, T)
        and all(t.shape == q.shape and t.dtype == q.dtype for t in same_as_q)
    ):
        raise ValueError(
            f"{name} kernel takes {DTYPES}, head_dim {HEAD_DIMS}, groups "
            f"{GROUPS}: got q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} {k.dtype}"
        )


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as TMA reads the bf16 kernels' tiles."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_valid: torch.Tensor,
    causal: bool = True,
    with_lse: bool = False,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K3: the forward, ``(out, lse or None)``, query row 0 at position
    ``q_offset``.  CPU tensors take the plain version; CUDA tensors launch
    the kernel (and raise on a shape or type it does not take: see
    ``DTYPES``, ``HEAD_DIMS`` and ``GROUPS``).  ``flash_fwd.launches`` counts
    kernel launches."""
    _check_offset(causal, q_offset)
    if q.device.type == "cpu":
        if with_lse:
            return flash_attention_reference(q, k, v, key_valid, causal, return_lse=True,
                                             q_offset=q_offset)
        return flash_attention_reference(q, k, v, key_valid, causal, q_offset=q_offset), None
    _check_kernel_shapes("flash_attention", q, k, v, key_valid)
    B, S, nq, hd = q.shape
    T, nkv = k.shape[1], k.shape[2]
    q, k, v = _contiguous(q), _contiguous(k), _contiguous(v)
    valid = key_valid.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B, nq, S), dtype=torch.float32, device=q.device) if with_lse else None
    lib = _fwd_lib()
    rc = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, B, S, T, nq, nkv, hd,
        int(q.dtype == torch.float32), int(causal), q_offset, _build.stream_handle(q.device),
    )
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: {lib.flash_error_string(rc).decode()}")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def _bwd_args(q, k, v, key_valid, dout, lse, delta):
    _check_kernel_shapes("flash_bwd", q, k, v, key_valid, dout)
    B, S, nq, hd = q.shape
    T, nkv = k.shape[1], k.shape[2]
    if lse.shape != (B, nq, S) or delta.shape != (B, nq, S):
        raise ValueError(f"flash_bwd: lse / delta must be [B, nq, S] = {(B, nq, S)}")
    tensors = [_contiguous(t) for t in (q, k, v)]
    tensors.append(key_valid.to(device=q.device, dtype=torch.int32).contiguous())
    tensors.append(_contiguous(dout))
    tensors += [t.to(torch.float32).contiguous() for t in (lse, delta)]
    return tensors, (B, S, T, nq, nkv, hd, int(q.dtype == torch.float32))


def flash_bwd_dq(q, k, v, key_valid, dout, lse, delta, causal: bool = True,
                 q_offset: int = 0) -> torch.Tensor:
    """K5a: ``dq`` (``lse`` and ``delta`` ``[B, nq, S]`` fp32).  CPU tensors
    take the plain version.  ``flash_bwd_dq.launches`` counts kernel
    launches."""
    _check_offset(causal, q_offset)
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, key_valid, dout, lse, delta, causal, q_offset)[0]
    tensors, dims = _bwd_args(q, k, v, key_valid, dout, lse, delta)
    dq = torch.empty_like(tensors[0])
    lib = _bwd_lib()
    rc = lib.flash_bwd_dq(*(t.data_ptr() for t in tensors), dq.data_ptr(), *dims, int(causal),
                          q_offset, _build.stream_handle(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dq launch failed: {lib.flash_bwd_error_string(rc).decode()}")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, key_valid, dout, lse, delta, causal: bool = True,
                  q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5b: ``(dk, dv)`` over all ``T`` keys; under a ``q_offset`` the key
    blocks that no row of this shard can see are written as zeros.  CPU
    tensors take the plain version.  ``flash_bwd_dkv.launches`` counts kernel
    launches."""
    _check_offset(causal, q_offset)
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, key_valid, dout, lse, delta, causal, q_offset)[1:]
    tensors, dims = _bwd_args(q, k, v, key_valid, dout, lse, delta)
    dk = torch.empty_like(tensors[1])
    dv = torch.empty_like(tensors[2])
    lib = _bwd_lib()
    rc = lib.flash_bwd_dkv(*(t.data_ptr() for t in tensors), dk.data_ptr(), dv.data_ptr(), *dims,
                           int(causal), q_offset, _build.stream_handle(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dkv launch failed: {lib.flash_bwd_error_string(rc).decode()}")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_bwd(q, k, v, key_valid, out, lse, dout, causal: bool = True, q_offset: int = 0):
    """The backward, ``(dq, dk, dv)``: ``delta`` as an fp32 reduction, then
    the two kernels (their plain versions on CPU tensors)."""
    delta = _delta(out, dout)
    dq = flash_bwd_dq(q, k, v, key_valid, dout, lse, delta, causal, q_offset)
    dk, dv = flash_bwd_dkv(q, k, v, key_valid, dout, lse, delta, causal, q_offset)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# The differentiable op
# ---------------------------------------------------------------------------


@torch.library.custom_op("csm_tpu_torch::flash_attn", mutates_args=())
def flash_attn_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor,
                  causal: bool, q_offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of the forward; differentiable in ``q``, ``k``, ``v``."""
    return flash_fwd(q, k, v, key_valid, causal, with_lse=True, q_offset=q_offset)


@flash_attn_op.register_fake
def _(q, k, v, key_valid, causal, q_offset):
    B, S, nq, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, nq, S), dtype=torch.float32)


def _setup_context(ctx, inputs, output):
    q, k, v, key_valid, causal, q_offset = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, key_valid, out, lse)
    ctx.causal, ctx.q_offset = causal, q_offset
    ctx.mark_non_differentiable(lse)


def _backward(ctx, dout, _dlse):
    q, k, v, key_valid, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_bwd(q, k, v, key_valid, out, lse, dout, ctx.causal, ctx.q_offset)
    return dq, dk, dv, None, None, None


flash_attn_op.register_autograd(_backward, setup_context=_setup_context)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_valid: torch.Tensor,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """Flash attention, ``[B, S, nq, hd]`` in ``q``'s dtype, query row 0 at
    position ``q_offset`` (causal only).  When a gradient is wanted the
    forward keeps its log-sum-exp and the backward runs the two backward
    kernels; otherwise the forward alone runs, with no log-sum-exp.  CPU
    tensors take the plain versions."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return flash_attn_op(q, k, v, key_valid.to(torch.int32), causal, q_offset)[0]
    return flash_fwd(q, k, v, key_valid, causal, q_offset=q_offset)[0]


def flash_attention_sp(
    q: torch.Tensor,  # [B, S_local, nq, hd]: this rank's query frames
    k: torch.Tensor,  # [B, S_local, nkv, hd]
    v: torch.Tensor,  # [B, S_local, nkv, hd]
    key_valid: torch.Tensor,  # [B, S_local] bool/int
    mesh,  # csm_tpu_torch.parallel.Mesh
) -> torch.Tensor:
    """Causal attention over a frame axis sharded across the mesh's ``seq``
    group (counterpart of the JAX package's ``flash_attention_sp``).

    K, V and ``key_valid`` are all-gathered along the frame axis (the
    gather is differentiable: its backward reduce-scatters each rank's
    full-length dK / dV to their owners, summing), then one causal call runs
    with ``q_offset = seq_rank * S_local``.  Each query row does the same
    work as in the unsharded kernel, so the output equals the unsharded
    call's rows bitwise; dK / dV are summed across ranks in another order
    than the unsharded kernel's query-tile loop."""
    from csm_tpu_torch.parallel.collectives import gather_frames

    group = mesh.group("seq")
    k_full = gather_frames(k, group)
    v_full = gather_frames(v, group)
    with torch.no_grad():
        valid_full = gather_frames(key_valid.to(torch.int32), group)
    return flash_attention(q, k_full, v_full, valid_full, causal=True,
                           q_offset=mesh.index("seq") * q.shape[1])
