"""Functional Llama transformer stack (counterpart of
``csm_tpu/models/llama.py``).

One parametric stack instantiated twice by CSM: the backbone (16L / 2048h /
32Q-8KV heads) and the intra-frame decoder (4L / 1024h / 8Q-2KV heads).
HF ``LlamaModel`` semantics with ``inputs_embeds`` fed directly: RMSNorm
(fp32 statistics), GQA attention with llama3-scaled RoPE, SiLU-gated MLP, no
biases, pre-norm residual blocks and a final norm.

Parameters keep the JAX package's layout: per-layer weights stacked on a
leading ``L`` axis, linear weights input-major ``[in, out]``.  The KV cache is
a static ``[L, B, max_len, nkv, hd]`` window with a per-key validity mask and
a scalar or per-stream ``[B]`` write index.  Unlike the JAX package (whose
arrays are immutable) cache writes here happen **in place**: the cache
tensors passed in are the ones updated.

Every rounding point of the bf16 path sits where the JAX path puts it (the
exact backbone kernel, :mod:`csm_tpu_torch.ops.bb_kernel`, depends on that):
each matmul output, ``normed.to(dtype) * weight``, RoPE computed in fp32 and
cast, fp32 scores and softmax with probabilities cast to the value dtype,
and ``g * sigmoid(g)`` rounded after the sigmoid and after each product.

Training memory (``forward(remat=True)``): each layer runs under
``torch.utils.checkpoint``, so its activations are recomputed in the
backward instead of stored.  ``remat_policy="nothing"`` keeps only the
layer's input; ``"dots"`` also keeps every 2-D matmul output (``aten.mm``,
the projections and the MLP) and the flash op's output and log-sum-exp, as
the JAX package's ``dots_with_no_batch_dims_saveable`` plus its named flash
output, so the backward re-runs neither the projections nor the flash
forward.

Sequence parallelism (``forward(mesh=..., seq_sharded=True)``): each rank
holds its frames of the sequence; attention gathers K / V over the mesh's
``seq`` group, through :func:`~csm_tpu_torch.ops.flash_attention.
flash_attention_sp` with this rank's query offset or, when the caller gives
a bias instead of flash key validity, through the plain attention over the
gathered K / V.

Tensor parallelism (``forward(mesh=...)`` with weights cut by
:func:`csm_tpu_torch.parallel.shard_params`): Q / K / V and gate / up are
column-parallel products (their input passes :func:`~csm_tpu_torch.parallel.
collectives.copy_to_model`), attention runs over the rank's local heads, and
``wo`` / ``w_down`` are row-parallel products: each rank's partial product
in fp32, added over the ``model`` group by :func:`~csm_tpu_torch.parallel.
collectives.reduce_from_model` and rounded once, where one process rounds
its whole product once (:func:`_row_product`).  The local head counts and FFN width come from the weights'
shapes, ``head_dim`` from the global config (``LlamaConfig.head_dim`` is
derived from the global head count); a block whose weights are whole runs
without collectives.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from csm_tpu_torch.config import LlamaConfig
from csm_tpu_torch.ops.flash_attention import flash_attention, flash_attention_sp
from csm_tpu_torch.parallel.collectives import copy_to_model, gather_frames, reduce_from_model
from csm_tpu_torch.ops.quant import qmm
from csm_tpu_torch.ops.rope import apply_rope, gather_rope
from csm_tpu_torch.utils.profiling import span

# Finite, so a fully-masked query row softmaxes to uniform instead of NaN.
NEG_INF = -1e9

Index = Union[int, torch.Tensor]  # scalar write index, or per-stream [B]


def normal_(shape, generator: torch.Generator, device, dtype) -> torch.Tensor:
    """``N(0, 0.02)`` drawn in fp32 on ``device`` from ``generator``."""
    w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return (w * 0.02).to(dtype)


def init_params(
    config: LlamaConfig, generator: torch.Generator, device, dtype=torch.float32
) -> dict:
    """Stacked Llama parameters: linear weights ``N(0, 0.02)``, norms 1."""
    L, D, F = config.num_hidden_layers, config.hidden_size, config.intermediate_size
    hd, nq, nkv = config.head_dim, config.num_attention_heads, config.num_key_value_heads

    def normal(shape):
        return normal_(shape, generator, device, dtype)

    ones = dict(device=device, dtype=dtype)
    return {
        "layers": {
            "attn_norm": torch.ones((L, D), **ones),
            "wq": normal((L, D, nq * hd)),
            "wk": normal((L, D, nkv * hd)),
            "wv": normal((L, D, nkv * hd)),
            "wo": normal((L, nq * hd, D)),
            "mlp_norm": torch.ones((L, D), **ones),
            "w_gate": normal((L, D, F)),
            "w_up": normal((L, D, F)),
            "w_down": normal((L, F, D)),
        },
        "final_norm": torch.ones((D,), **ones),
    }


@dataclasses.dataclass
class KVCache:
    """Static-shape KV cache.  ``k``/``v``: ``[L, B, max_len, nkv, hd]``;
    ``valid``: ``[B, max_len]`` bool (0 for unwritten slots and padding
    frames); ``index``: next write position, an ``int`` or a ``[B]`` long
    tensor (per-stream windows)."""

    k: torch.Tensor
    v: torch.Tensor
    valid: torch.Tensor
    index: Index = 0

    @classmethod
    def create(cls, config: LlamaConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None,
               num_kv_heads: Optional[int] = None) -> "KVCache":
        """An empty cache; ``num_kv_heads``: this rank's KV heads under
        tensor parallelism (:func:`local_heads`), the config's by default."""
        shape = (config.num_hidden_layers, batch, max_len,
                 num_kv_heads or config.num_key_value_heads, config.head_dim)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            valid=torch.zeros((batch, max_len), dtype=torch.bool, device=device),
            index=0,
        )

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def batch(self) -> int:
        return self.valid.shape[0]

    @property
    def state_bytes(self) -> int:
        """Bytes of one stream's recurrent state: none in a Llama stack."""
        return 0

    def clone(self) -> "KVCache":
        """A copy: a registered prefix's cache stays as it was."""
        idx = self.index.clone() if isinstance(self.index, torch.Tensor) else self.index
        return KVCache(self.k.clone(), self.v.clone(), self.valid.clone(), idx)

    def put(self, slot: int, src: "KVCache") -> None:
        """In place: stream ``slot`` becomes ``src``'s stream 0 (K/V rows and
        validity; the index is the caller's)."""
        self.k[:, slot] = src.k[:, 0]
        self.v[:, slot] = src.v[:, 0]
        self.valid[slot] = src.valid[0]


def write_rows(buf: torch.Tensor, rows: torch.Tensor, start: Index) -> None:
    """In place: ``buf[b, start_b : start_b + S] = rows[b]`` for ``buf
    [B, T, ...]`` and ``rows [B, S, ...]``.  The start is clamped so the
    rows fit, as ``lax.dynamic_update_slice`` clamps it."""
    T, S = buf.shape[1], rows.shape[1]
    rows = rows.to(buf.dtype)
    if isinstance(start, int):
        s = min(max(start, 0), T - S)
        buf[:, s:s + S] = rows
        return
    s = start.to(buf.device).long().clamp(0, T - S)
    pos = s[:, None] + torch.arange(S, device=buf.device)
    b = torch.arange(buf.shape[0], device=buf.device)[:, None]
    buf[b, pos] = rows


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with fp32 statistics, cast, then multiply by the weight."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


def attention(
    q: torch.Tensor,  # [B, S, nq, hd]
    k: torch.Tensor,  # [B, T, nkv, hd]
    v: torch.Tensor,  # [B, T, nkv, hd]
    bias: torch.Tensor,  # [B, 1, 1, S, T] additive (0 or NEG_INF)
) -> torch.Tensor:
    """GQA attention with fp32 scores and softmax; masked scores are SET to
    the finite ``NEG_INF`` so a fully masked row attends uniformly.
    Returns ``[B, S, nq*hd]`` in ``v``'s dtype."""
    B, S, nq, hd = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    qg = q.reshape(B, S, nkv, g, hd).permute(0, 2, 3, 1, 4)  # [B,nkv,g,S,hd]
    kk = k.permute(0, 2, 1, 3)  # [B,nkv,T,hd]
    vv = v.permute(0, 2, 1, 3)
    scores = torch.einsum("bngsh,bnth->bngst", qg.float(), kk.float())
    scores = scores * (1.0 / float(hd) ** 0.5)
    scores = torch.where(bias < 0, torch.full_like(scores, NEG_INF), scores)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bngst,bnth->bngsh", probs, vv)  # [B,nkv,g,S,hd]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, nq * hd)


def local_heads(layers: dict, config: LlamaConfig) -> Tuple[int, int]:
    """``(query heads, KV heads)`` of a stack whose (stacked or per-layer)
    weights are ``layers``: the config's, or this rank's share under tensor
    parallelism, read off the weights' shapes."""
    hd = config.head_dim
    return layers["wq"].shape[-1] // hd, layers["wk"].shape[-1] // hd


def model_groups(layers: dict, config: LlamaConfig, mesh) -> Tuple[object, object]:
    """``(attention group, MLP group)``: the mesh's ``model`` group for each
    block whose weights in ``layers`` are this rank's shard, None for a block
    with whole weights.  Shards without a model group raise."""
    nq, _ = local_heads(layers, config)
    parts = (nq != config.num_attention_heads,
             layers["w_gate"].shape[-1] != config.intermediate_size)
    group = None if mesh is None else mesh.group("model")
    if any(parts) and group is None:
        raise ValueError("the weights are shards of a model axis (their shapes are not the "
                         "config's): pass the mesh they were cut for")
    return tuple(group if p else None for p in parts)


def _row_product(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """``x @ w`` for a row-parallel shard ``w`` (its rows are this rank's
    part of ``x``'s features): the partial product in fp32 (products of
    bf16 values are exact there), summed over ``group``, rounded once to
    ``x``'s dtype; a plain product without a group."""
    if group is None:
        return x @ w
    return reduce_from_model(x.float() @ w.float(), group).to(x.dtype)


def _layer(
    h: torch.Tensor,
    lp: dict,
    cos: torch.Tensor,
    sin: torch.Tensor,
    bias: Optional[torch.Tensor],
    config: LlamaConfig,
    cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_index: Index = 0,
    flash_key_valid: Optional[torch.Tensor] = None,
    qlayer: Optional[dict] = None,
    sp_mesh=None,
    groups: Tuple[object, object] = (None, None),
) -> torch.Tensor:
    """One pre-norm block.  With ``cache_kv`` (this layer's ``[B, max_len,
    nkv, hd]`` views) the new K/V rows are written in place at
    ``cache_index`` and attention spans the whole window.
    ``flash_key_valid`` selects the flash kernel (queries start at absolute
    position 0: prefill or the uncached forward).  ``qlayer``: this layer's
    int8 weights (:mod:`csm_tpu_torch.ops.quant`); the products then run
    W8A16, Q/K/V and gate/up fused, each output cast to ``h``'s dtype.
    ``sp_mesh``: ``h`` is this rank's frames of a sequence sharded over the
    mesh's ``seq`` axis; K / V are gathered over it (``bias`` then spans
    the gathered keys).  ``groups``: the ``model`` groups of the attention
    and the MLP block (:func:`model_groups`), None for a whole block."""
    B, S, _ = h.shape
    hd = config.head_dim
    attn_group, mlp_group = groups
    if qlayer is not None:
        nq, nkv, F = config.num_attention_heads, config.num_key_value_heads, config.intermediate_size
    else:
        (nq, nkv), F = local_heads(lp, config), lp["w_gate"].shape[-1]

    if qlayer is not None:
        def mm(x, name, group=None):
            return qmm(x, qlayer["w"][name], qlayer["s"][name]).to(h.dtype)
    else:
        def mm(x, name, group=None):
            return _row_product(x, lp[name], group)

    x = copy_to_model(rmsnorm(h, lp["attn_norm"], config.rms_norm_eps), attn_group)
    if qlayer is not None:
        qkv = mm(x, "wqkv")
        q = qkv[..., :nq * hd].reshape(B, S, nq, hd)
        k = qkv[..., nq * hd:(nq + nkv) * hd].reshape(B, S, nkv, hd)
        v = qkv[..., (nq + nkv) * hd:].reshape(B, S, nkv, hd)
    else:
        q = mm(x, "wq").reshape(B, S, nq, hd)
        k = mm(x, "wk").reshape(B, S, nkv, hd)
        v = mm(x, "wv").reshape(B, S, nkv, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache_kv is not None:
        ck, cv = cache_kv
        write_rows(ck, k, cache_index)
        write_rows(cv, v, cache_index)
        k, v = ck, cv
    k, v = k.to(q.dtype), v.to(q.dtype)
    if sp_mesh is not None and flash_key_valid is not None:
        attn = flash_attention_sp(q, k, v, flash_key_valid, sp_mesh).reshape(B, S, nq * hd)
    elif sp_mesh is not None:
        group = sp_mesh.group("seq")
        attn = attention(q, gather_frames(k, group), gather_frames(v, group), bias)
    elif flash_key_valid is not None:
        attn = flash_attention(q, k, v, flash_key_valid).reshape(B, S, nq * hd)
    else:
        attn = attention(q, k, v, bias)

    h = h + mm(attn, "wo", attn_group)
    x = copy_to_model(rmsnorm(h, lp["mlp_norm"], config.rms_norm_eps), mlp_group)
    if qlayer is not None:
        gu = mm(x, "w_gu")
        g, up = gu[..., :F], gu[..., F:]
    else:
        g, up = mm(x, "w_gate"), mm(x, "w_up")
    # x * sigmoid(x), not F.silu: in bf16 the sigmoid is rounded before the
    # product, as in the JAX path and the exact backbone kernel.
    gated = g * torch.sigmoid(g) * up
    return h + mm(gated, "w_down", mlp_group)


def make_causal_bias(
    key_valid: torch.Tensor, q_len: int, q_offset: Index = 0
) -> torch.Tensor:
    """Additive bias ``[B, 1, 1, q_len, T]``: query at absolute position
    ``q_offset + s`` may attend valid keys at positions ``<= q_offset + s``.
    ``q_offset`` is an int or a per-stream ``[B]`` tensor."""
    B, T = key_valid.shape
    dev = key_valid.device
    if isinstance(q_offset, int):
        q_off = torch.full((1,), q_offset, dtype=torch.long, device=dev)
    else:
        q_off = q_offset.to(dev).long().reshape(-1)
    q_pos = q_off[:, None, None] + torch.arange(q_len, device=dev)[None, :, None]
    k_pos = torch.arange(T, device=dev)[None, None, :]
    ok = (k_pos <= q_pos) & key_valid.bool()[:, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    return torch.where(ok, zero, neg)[:, None, None, :, :]


REMAT_POLICIES = ("nothing", "dots")


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing's ``"dots"``: keep 2-D matmul outputs and the
    flash op's outputs, recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.csm_tpu_torch.flash_attn.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def forward(
    params: dict,
    config: LlamaConfig,
    inputs_embeds: torch.Tensor,  # [B, S, D]
    *,
    rope_table: Tuple[torch.Tensor, torch.Tensor],
    positions: torch.Tensor,  # [B, S] long
    attn_bias: Optional[torch.Tensor],
    cache: Optional[KVCache] = None,
    flash_key_valid: Optional[torch.Tensor] = None,
    qlayers: Optional[dict] = None,
    remat: bool = False,
    remat_policy: str = "nothing",
    mesh=None,
    seq_sharded: bool = False,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the stack.  Without a cache, T == S.  With one, the chunk's K/V
    are written (in place) at ``cache.index`` and attention spans the
    window; the returned cache shares the tensors, with the index advanced
    by ``S``.  ``qlayers``: stacked int8 weights
    (:func:`csm_tpu_torch.ops.quant.prepare_quantized_backbone`) for W8A16
    products.  ``remat`` (uncached passes under autograd): checkpoint each
    layer with ``remat_policy`` ``"nothing"`` or ``"dots"`` (module
    docstring); no effect on a pass that builds no graph.  ``mesh``: a
    :class:`~csm_tpu_torch.parallel.Mesh`; weights cut by ``shard_params``
    run tensor-parallel over its ``model`` axis (module docstring), and with
    ``seq_sharded`` (uncached) ``inputs_embeds`` are this rank's frames of a
    sequence sharded over its ``seq`` axis (see :func:`_layer`)."""
    if seq_sharded and cache is not None:
        raise ValueError("sequence parallelism runs uncached passes only")
    sp_mesh = mesh if seq_sharded else None
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}; got {remat_policy!r}")
    cos, sin = gather_rope(rope_table, positions)
    layers = params["layers"]
    h = inputs_embeds
    run = _layer
    if remat and cache is None and torch.is_grad_enabled():
        extra = {}
        if remat_policy == "dots":
            extra["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                    _dots_policy)
        run = functools.partial(checkpoint, _layer, use_reentrant=False, **extra)
    # One unbind per stacked weight, not a slice per layer: the backward of
    # unbind stacks the layers' gradients once, where each slice's backward
    # would write a zero tensor of the whole stack for autograd to sum.
    groups = model_groups(layers, config, mesh) if qlayers is None else (None, None)
    per_layer = {name: w.unbind(0) for name, w in layers.items()}
    for l in range(config.num_hidden_layers):
        lp = {name: ws[l] for name, ws in per_layer.items()}
        kv = None if cache is None else (cache.k[l], cache.v[l])
        idx = 0 if cache is None else cache.index
        ql = None if qlayers is None else {
            part: {name: w[l] for name, w in qlayers[part].items()} for part in ("w", "s")}
        with span("csm.llama.layer", l=l):
            h = run(h, lp, cos, sin, attn_bias, config, cache_kv=kv,
                    cache_index=idx, flash_key_valid=flash_key_valid, qlayer=ql,
                    sp_mesh=sp_mesh, groups=groups)
    new_cache = None
    if cache is not None:
        new_cache = dataclasses.replace(
            cache, index=cache.index + inputs_embeds.shape[1]
        )
    return rmsnorm(h, params["final_norm"], config.rms_norm_eps), new_cache


def forward_uncached(
    params: dict,
    config: LlamaConfig,
    inputs_embeds: torch.Tensor,
    *,
    rope_table: Tuple[torch.Tensor, torch.Tensor],
    mesh=None,
) -> torch.Tensor:
    """Full-sequence causal forward over all-valid rows at positions
    ``arange(S)`` (the decoder's training pass); ``mesh`` as in
    :func:`forward`."""
    B, S, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    positions = torch.arange(S, device=dev).expand(B, S)
    bias = make_causal_bias(torch.ones((B, S), dtype=torch.bool, device=dev), S)
    h, _ = forward(params, config, inputs_embeds, rope_table=rope_table,
                   positions=positions, attn_bias=bias, mesh=mesh)
    return h
