"""Hybrid state-space backbone: Mamba-2 mixers beside position-free GQA
attention layers (HF ``GraniteMoeHybrid`` without experts, e.g.
``ibm-granite/granite-4.0-h-micro``), as CSM's backbone.

Per layer ``l`` of ``config.layer_types``, on the residual stream ``h``
(which starts as the embedded frames times ``embedding_multiplier``)::

    h = h + residual_multiplier * mixer_l(rms(h))   # Mamba-2, or attention
    h = h + residual_multiplier * mlp_l(rms(h))     # SwiGLU

and a final RMSNorm.  The Mamba-2 mixer: ``in_proj`` gives ``z``, ``xBC``
and ``dt``; ``xBC`` passes a causal depthwise conv (width ``d_conv``, with
bias) and SiLU and splits into ``x`` (``H`` heads of ``P``), ``B`` and ``C``
(``G`` groups of ``N``); ``Δ = softplus(dt + dt_bias)``, ``A = -exp(A_log)``;
per head ``S_t = exp(Δ A) S_{t-1} + Δ x_t ⊗ B_t`` and ``y_t = S_t C_t + D
x_t``; the output is ``out_proj(rms_w(y ⊙ silu(z)))`` with the gated RMSNorm
over all ``H P`` channels.  Attention has no position embedding and scores
scaled by ``attention_multiplier``, which is folded into ``q`` so that the
flash kernel's and the plain attention's fixed ``1/sqrt(head_dim)`` apply it.

Parameters: ``{"mamba": {...}, "attn": {...}, "final_norm": [D]}``, each
kind's layers stacked on a leading axis in the order they occur, linear
weights input-major.  The cache (:class:`HybridCache`) holds the attention
layers' K/V window as :class:`~csm_tpu_torch.models.llama.KVCache` does,
and for every mixer its conv state (the last ``d_conv - 1`` inputs of
``xBC``) and its recurrent state ``[B, H, P, N]``, both in the cache's dtype.

A pass over more than one frame (prefill, or the uncached forward) runs the
scan in its chunked form (SSD, ``mamba_chunk_size`` positions a chunk, the
same recurrence) from the cache's state; frames whose 33-wide mask is all
zero, which generation only puts after a stream's real frames (right
padding), move neither state, so the state after a padded bucket is the
state after the real frames.  A single-frame cached pass steps each mixer
through :func:`csm_tpu_torch.ops.ssm.ssm_step` (the CUDA kernel on the card)
with the states updated in place.  On the card both passes a server runs
again and again replay CUDA graphs: its steps, all on one cache
(:func:`step`), and its admissions' prefills from a cache's start, one graph
a prompt bucket (:func:`prefill`), also while a profiler records (its
device trace then holds the replayed kernels; the spans inside a graph
fire only where it runs eagerly).  Arithmetic: products and the residual in
the parameters' dtype, the conv, the scan, the gate and the norms'
statistics in float32.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from csm_tpu_torch.config import HybridConfig
from csm_tpu_torch.models.llama import Index, attention, normal_, write_rows
from csm_tpu_torch.ops.flash_attention import flash_attention
from csm_tpu_torch.ops.ssm import conv_silu, ssm_step
from csm_tpu_torch.utils.profiling import span

def init_params(config: HybridConfig, generator: torch.Generator, device,
                dtype=torch.float32) -> dict:
    """Stacked parameters: linear weights ``N(0, 0.02)``, norms 1, conv
    weights ``N(0, 0.5)`` and biases 0, ``A_log = log(1..H)``, ``dt_bias``
    the inverse softplus of steps spaced evenly in log between 0.001 and 0.1
    (the published initialisation's range), ``D`` 1."""
    Lm, La = len(config.mamba_layers), len(config.attention_layers)
    D, Fs = config.hidden_size, config.shared_intermediate_size
    H, inner, C = config.mamba_n_heads, config.mamba_inner, config.conv_dim
    hd, nq, nkv = config.head_dim, config.num_attention_heads, config.num_key_value_heads
    kw = dict(device=device, dtype=dtype)

    def normal(shape, scale=0.02):
        return normal_(shape, generator, device, torch.float32).mul(scale / 0.02).to(dtype)

    def mlp(L):
        return {"mlp_norm": torch.ones((L, D), **kw), "w_gate": normal((L, D, Fs)),
                "w_up": normal((L, D, Fs)), "w_down": normal((L, Fs, D))}

    dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), H, dtype=torch.float64))
    dt_bias = (dt + torch.log(-torch.expm1(-dt))).float()
    return {
        "mamba": {
            "norm": torch.ones((Lm, D), **kw),
            "in_proj": normal((Lm, D, config.in_proj_dim)),
            "conv_w": normal((Lm, C, config.mamba_d_conv), 0.5),
            "conv_b": torch.zeros((Lm, C), **kw),
            "dt_bias": dt_bias.expand(Lm, H).to(**kw).contiguous(),
            "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32)).expand(Lm, H)
            .to(**kw).contiguous(),
            "D": torch.ones((Lm, H), **kw),
            "gate_norm": torch.ones((Lm, inner), **kw),
            "out_proj": normal((Lm, inner, D)),
            **mlp(Lm),
        },
        "attn": {
            "attn_norm": torch.ones((La, D), **kw),
            "wq": normal((La, D, nq * hd)), "wk": normal((La, D, nkv * hd)),
            "wv": normal((La, D, nkv * hd)), "wo": normal((La, nq * hd, D)),
            **mlp(La),
        },
        "final_norm": torch.ones((D,), **kw),
    }


@dataclasses.dataclass
class HybridCache:
    """The hybrid backbone's cache.  ``k``/``v``: ``[La, B, max_len, nkv,
    hd]`` for the attention layers; ``valid``: ``[B, max_len]``; ``index``:
    the next write position, an ``int`` or a per-stream ``[B]`` tensor (as
    :class:`~csm_tpu_torch.models.llama.KVCache`); ``conv``: ``[Lm, B,
    d_conv - 1, conv_dim]`` in the parameters' dtype; ``ssm``: ``[Lm, B, H,
    P, N]`` in the cache's dtype (the parameters').  Writes happen in place."""

    k: torch.Tensor
    v: torch.Tensor
    valid: torch.Tensor
    conv: torch.Tensor
    ssm: torch.Tensor
    index: Index = 0

    @classmethod
    def create(cls, config: HybridConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> "HybridCache":
        """An empty cache: no keys, zero states."""
        La, Lm = len(config.attention_layers), len(config.mamba_layers)
        kv = (La, batch, max_len, config.num_key_value_heads, config.head_dim)
        return cls(
            k=torch.zeros(kv, dtype=dtype, device=device),
            v=torch.zeros(kv, dtype=dtype, device=device),
            valid=torch.zeros((batch, max_len), dtype=torch.bool, device=device),
            conv=torch.zeros((Lm, batch, config.mamba_d_conv - 1, config.conv_dim),
                             dtype=dtype, device=device),
            ssm=torch.zeros((Lm, batch, config.mamba_n_heads, config.mamba_d_head,
                             config.mamba_d_state), dtype=dtype, device=device),
        )

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def batch(self) -> int:
        return self.valid.shape[0]

    @property
    def state_bytes(self) -> int:
        """Bytes of one stream's recurrent state (conv and SSM states)."""
        per = (self.conv[:, 0].numel() * self.conv.element_size()
               + self.ssm[:, 0].numel() * self.ssm.element_size())
        return int(per)

    def clone(self) -> "HybridCache":
        """A copy: a registered prefix's snapshot stays as it was."""
        idx = self.index.clone() if isinstance(self.index, torch.Tensor) else self.index
        return HybridCache(self.k.clone(), self.v.clone(), self.valid.clone(), self.conv.clone(),
                           self.ssm.clone(), idx)

    def put(self, slot: int, src: "HybridCache") -> None:
        """In place: stream ``slot`` becomes ``src``'s stream 0 (K/V rows,
        validity and both states; the index is the caller's)."""
        self.k[:, slot] = src.k[:, 0]
        self.v[:, slot] = src.v[:, 0]
        self.valid[slot] = src.valid[0]
        self.conv[:, slot] = src.conv[:, 0]
        self.ssm[:, slot] = src.ssm[:, 0]


def _rms(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in one call: statistics in float32, the normed value in
    ``x``'s dtype, times the weight."""
    return F.rms_norm(x, (x.shape[-1],), eps=eps) * weight


def _gated_out(y: torch.Tensor, z: torch.Tensor, lp: dict, config: HybridConfig,
               dtype) -> torch.Tensor:
    """``out_proj(rms_w(y ⊙ silu(z)))`` for ``y`` already gated when ``z``
    is None; the norm over all ``H P`` channels in float32."""
    g = y.float() if z is None else y.float() * F.silu(z.float())
    normed = F.rms_norm(g, (g.shape[-1],), eps=config.rms_norm_eps)
    return (normed.to(dtype) * lp["gate_norm"]) @ lp["out_proj"]


def ssd_scan(x, dt, A, Bm, Cm, chunk: int, state):
    """The chunked (SSD) scan, float32: ``x [B, S, H, P]``, ``dt [B, S, H]``
    (0 at frames that move no state), ``A [H]``, ``Bm`` / ``Cm [B, S, G,
    N]``, ``state [B, H, P, N]`` the state before the first frame.  Returns
    ``(y [B, S, H, P] without the D skip, the state after the last
    frame)``.  Within a chunk the outputs are the masked decay-weighted
    products; across chunks the states are carried one chunk at a time."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2:]
    rep = H // G
    pad = (-S) % chunk
    if pad:
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, 0, 0, pad))
    c, L = (S + pad) // chunk, chunk
    x = x.reshape(Bsz, c, L, H, P)
    dt = dt.reshape(Bsz, c, L, H)
    Bh = Bm.reshape(Bsz, c, L, G, N).repeat_interleave(rep, dim=3)  # [B, c, L, H, N]
    Ch = Cm.reshape(Bsz, c, L, G, N).repeat_interleave(rep, dim=3)
    acs = (dt * A).cumsum(dim=2)  # [B, c, L, H]
    xdt = x * dt[..., None]
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    seg = acs[:, :, :, None, :] - acs[:, :, None, :, :]  # [B, c, l, s, H]
    decay = torch.exp(seg.masked_fill(~causal[:, :, None], -math.inf))
    cb = torch.einsum("bclhn,bcshn->bclsh", Ch, Bh)
    y = torch.einsum("bclsh,bcshp->bclhp", cb * decay, xdt)
    to_end = torch.exp(acs[:, :, -1:, :] - acs)  # [B, c, L, H]
    chunk_states = torch.einsum("bclhn,bclh,bclhp->bchpn", Bh, to_end, xdt)
    entering = []
    for i in range(c):
        entering.append(state)
        state = torch.exp(acs[:, i, -1])[:, :, None, None] * state + chunk_states[:, i]
    st = torch.stack(entering, dim=1)  # [B, c, H, P, N]
    y = y + torch.einsum("bclhn,bchpn->bclhp", Ch, st) * torch.exp(acs)[..., None]
    return y.reshape(Bsz, c * L, H, P)[:, :S], state


def _mixer_scan(lp: dict, config: HybridConfig, x: torch.Tensor, lengths: torch.Tensor,
                conv_state: Optional[torch.Tensor], ssm_state: Optional[torch.Tensor]):
    """A mixer over ``x [B, S, D]`` (normed) whose first ``lengths [B]``
    frames are real, from the given states (zeros when None).  Returns
    ``(out [B, S, D], conv state, SSM state in float32)`` after the real
    frames."""
    Bsz, S, _ = x.shape
    H, P, N, G = config.mamba_n_heads, config.mamba_d_head, config.mamba_d_state, \
        config.mamba_n_groups
    inner, C, K = config.mamba_inner, config.conv_dim, config.mamba_d_conv
    dev = x.device
    zxbcdt = x @ lp["in_proj"]
    z, xbc, dt = zxbcdt[..., :inner], zxbcdt[..., inner:inner + C], zxbcdt[..., inner + C:]
    if conv_state is None:
        conv_state = torch.zeros((Bsz, K - 1, C), dtype=xbc.dtype, device=dev)
    ctx = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)  # [B, K-1+S, C]
    windows = ctx.unfold(1, K, 1).transpose(-1, -2)  # [B, S, K, C]
    xbc = conv_silu(windows, lp["conv_w"], lp["conv_b"])
    # The conv state after the real frames: their last K - 1 inputs.
    rows = lengths.to(dev).long()[:, None] + torch.arange(K - 1, device=dev)
    new_conv = ctx.gather(1, rows[..., None].expand(Bsz, K - 1, C))
    real = torch.arange(S, device=dev)[None, :] < lengths.to(dev)[:, None]
    delta = F.softplus(dt.float() + lp["dt_bias"].float())
    delta = torch.where(real[..., None], delta, torch.zeros((), device=dev))
    if ssm_state is None:
        ssm_state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=dev)
    xs = xbc[..., :inner].reshape(Bsz, S, H, P)
    Bm = xbc[..., inner:inner + G * N].reshape(Bsz, S, G, N)
    Cm = xbc[..., inner + G * N:].reshape(Bsz, S, G, N)
    with span("csm.ssm.scan", device=True, S=S,
              chunks=-(-S // config.mamba_chunk_size)):
        y, state = ssd_scan(xs, delta, -torch.exp(lp["A_log"].float()), Bm, Cm,
                            config.mamba_chunk_size, ssm_state.float())
    y = y + lp["D"].float()[:, None] * xs
    out = _gated_out(y.reshape(Bsz, S, inner), z, lp, config, x.dtype)
    return out, new_conv, state


def _mixer_step(lp: dict, config: HybridConfig, x: torch.Tensor, conv_state: torch.Tensor,
                ssm_state: torch.Tensor) -> torch.Tensor:
    """A mixer over one frame ``x [B, 1, D]`` (normed), the states updated
    in place by :func:`~csm_tpu_torch.ops.ssm.ssm_step`."""
    zxbcdt = (x[:, 0] @ lp["in_proj"]).contiguous()
    y = ssm_step(zxbcdt, conv_state, ssm_state, lp, config)
    return _gated_out(y, None, lp, config, x.dtype)[:, None]


def _mlp(lp: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ lp["w_gate"]) * (x @ lp["w_up"])) @ lp["w_down"]


def _attention(lp: dict, config: HybridConfig, x: torch.Tensor, kv, index: Index,
               bias: Optional[torch.Tensor], flash_key_valid: Optional[torch.Tensor]):
    """Position-free GQA over ``x [B, S, D]`` (normed): the new K/V rows
    written into ``kv`` (this layer's window views) at ``index``, or, without
    a cache, attention over the chunk itself."""
    B, S, _ = x.shape
    hd, nq, nkv = config.head_dim, config.num_attention_heads, config.num_key_value_heads
    # attention_multiplier folded into q: the attentions below scale by 1/sqrt(hd).
    q = (x @ lp["wq"]) * (config.attention_multiplier * math.sqrt(hd))
    q = q.reshape(B, S, nq, hd)
    k = (x @ lp["wk"]).reshape(B, S, nkv, hd)
    v = (x @ lp["wv"]).reshape(B, S, nkv, hd)
    if kv is not None:
        ck, cv = kv
        write_rows(ck, k, index)
        write_rows(cv, v, index)
        k, v = ck.to(q.dtype), cv.to(q.dtype)
    if flash_key_valid is not None:
        out = flash_attention(q, k, v, flash_key_valid).reshape(B, S, nq * hd)
    else:
        out = attention(q, k, v, bias)
    return out @ lp["wo"]


def forward(params: dict, config: HybridConfig, h: torch.Tensor, *,
            valid: Optional[torch.Tensor], attn_bias: Optional[torch.Tensor],
            cache: Optional[HybridCache] = None,
            flash_key_valid: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Optional[HybridCache]]:
    """The stack over ``h [B, S, D]`` (the embedded frames, not yet times
    ``embedding_multiplier``); ``valid [B, S]`` the real frames (each
    stream's come first; a single-frame cached step reads none).  With a cache, the attention layers write their
    K/V rows at ``cache.index`` and attend the window (``attn_bias``, or the
    flash kernel with ``flash_key_valid`` for a prefill at index 0), and the
    mixers continue from the cache's states and leave theirs there (one
    frame: stepped in place); the returned cache shares the tensors, the
    index advanced by ``S``.  Without one, attention over the chunk
    (``attn_bias``) and the scans from zero states.  Returns the final-normed
    hidden and the cache."""
    B, S, _ = h.shape
    rm = config.residual_multiplier
    mp, ap = params["mamba"], params["attn"]
    m_layers = {name: w.unbind(0) for name, w in mp.items()}
    a_layers = {name: w.unbind(0) for name, w in ap.items()}
    step = cache is not None and S == 1
    lengths = None if step else valid.sum(dim=1)
    h = h * config.embedding_multiplier
    im = ia = 0
    for l, kind in enumerate(config.layer_types):
        with span("csm.hybrid.layer", l=l, kind=kind):
            if kind == "mamba":
                lp = {name: ws[im] for name, ws in m_layers.items()}
                x = _rms(h, lp["norm"], config.rms_norm_eps)
                if step:
                    out = _mixer_step(lp, config, x, cache.conv[im], cache.ssm[im])
                else:
                    out, conv, state = _mixer_scan(
                        lp, config, x, lengths, None if cache is None else cache.conv[im],
                        None if cache is None else cache.ssm[im])
                    if cache is not None:
                        cache.conv[im] = conv.to(cache.conv.dtype)
                        cache.ssm[im] = state.to(cache.ssm.dtype)
                im += 1
            else:
                lp = {name: ws[ia] for name, ws in a_layers.items()}
                x = _rms(h, lp["attn_norm"], config.rms_norm_eps)
                kv = None if cache is None else (cache.k[ia], cache.v[ia])
                out = _attention(lp, config, x, kv, 0 if cache is None else cache.index,
                                 attn_bias, flash_key_valid)
                ia += 1
            h = torch.add(h, out, alpha=rm)
            h = torch.add(h, _mlp(lp, _rms(h, lp["mlp_norm"], config.rms_norm_eps)), alpha=rm)
    new_cache = None
    if cache is not None:
        new_cache = dataclasses.replace(cache, index=cache.index + S)
    return _rms(h, params["final_norm"], config.rms_norm_eps), new_cache


# ---------------------------------------------------------------------------
# The single-frame step and the prefill as CUDA graphs
# ---------------------------------------------------------------------------

# Whether steps and prefills may replay captured graphs (tests turn it off
# to hold the graphs against the eager passes).
GRAPHS = True
# Eager passes of one shape before it is captured: the kernels and cuBLAS
# are loaded by then, so the capture records what the eager pass runs.
_GRAPH_AFTER = 3
_CAPTURED: list = []  # the newest _StepGraph only
_PENDING: list = []  # [tensor refs, shapes, eager steps seen] of the cache being counted
# Prefill graphs by their shapes, at most _PREFILL_GRAPHS (the oldest goes
# first), and the eager prefills seen of each shape.
_PREFILL_GRAPHS = 8
_PREFILLS: dict = {}
_PREFILLS_SEEN: dict = {}


def _graphs_on(h: torch.Tensor) -> bool:
    """Whether a pass may replay a graph: on the card, without autograd."""
    return GRAPHS and h.is_cuda and not torch.is_grad_enabled()


def _may_capture() -> bool:
    """Whether a graph may be captured now: not while a profiler records,
    whose spans would be recorded into the capture and never fire again."""
    return not torch.autograd.profiler._is_profiler_enabled


def _cache_tensors(cache: HybridCache) -> list:
    return [cache.k, cache.v, cache.valid, cache.conv, cache.ssm]


def _param_tensors(params: dict) -> list:
    return [w for kind in ("mamba", "attn") for _, w in sorted(params[kind].items())] + \
        [params["final_norm"]]


def _graph_tensors(params: dict, cache: HybridCache) -> list:
    """Every tensor a captured step reads or writes outside its own pool:
    a graph replays only on these very tensors."""
    return _param_tensors(params) + _cache_tensors(cache)


def _same(refs: list, tensors: list) -> bool:
    """Whether ``refs`` (weak references) still name exactly ``tensors``:
    a freed tensor, or another at a freed one's address, does not match."""
    return len(refs) == len(tensors) and all(r() is t for r, t in zip(refs, tensors))


class _StepGraph:
    """One captured step of :func:`forward` over one cache: the cache's
    tensors are the graph's (written in place as in the eager step), and the
    step's inputs are copied into static buffers before each replay.  It
    holds only weak references to the parameters and the cache, so it never
    keeps a dropped server's memory, and replays only while they live."""

    def __init__(self, params, config, h, attn_bias, cache, tensors, shapes):
        self.refs = [weakref.ref(t) for t in tensors]
        self.shapes = shapes
        self.h, self.bias = h.clone(), attn_bias.clone()
        self.index = cache.index.clone()
        static = dataclasses.replace(cache, index=self.index)
        self.graph = torch.cuda.CUDAGraph()
        before = ssm_step.launches
        with torch.cuda.graph(self.graph):
            self.out, _ = forward(params, config, self.h, valid=None, attn_bias=self.bias,
                                  cache=static)
        # The capture ran nothing; each replay runs the mixer kernels it holds.
        self.launches, ssm_step.launches = ssm_step.launches - before, before

    def __call__(self, h, attn_bias, index) -> torch.Tensor:
        self.h.copy_(h)
        self.bias.copy_(attn_bias)
        self.index.copy_(index)
        self.graph.replay()
        ssm_step.launches += self.launches
        return self.out.clone()


def step(params: dict, config: HybridConfig, h: torch.Tensor, *, attn_bias: torch.Tensor,
         cache: HybridCache) -> Tuple[torch.Tensor, HybridCache]:
    """A single-frame cached step, :func:`forward`'s, through a CUDA graph
    where one pays: on the card, for a cache with a per-stream index (a
    server's shared cache, stepped again and again), once that cache has
    stepped :data:`_GRAPH_AFTER` times eagerly (a capture waits while a
    profiler records; a replay does not).  The graph replays
    the eager step's kernels on the same tensors; a step on any other
    tensors (another server, or one built where a dropped one was) runs
    eagerly and counts towards its own capture, which replaces the graph."""
    if not (_graphs_on(h) and isinstance(cache.index, torch.Tensor)):
        return forward(params, config, h, valid=None, attn_bias=attn_bias, cache=cache)
    tensors = _graph_tensors(params, cache)
    shapes = (tuple(h.shape), tuple(attn_bias.shape))
    graph = _CAPTURED[0] if _CAPTURED else None
    if graph is None or graph.shapes != shapes or not _same(graph.refs, tensors):
        if not (_PENDING and _PENDING[1] == shapes and _same(_PENDING[0], tensors)):
            _PENDING[:] = [[weakref.ref(t) for t in tensors], shapes, 0]
        _PENDING[2] += 1
        if _PENDING[2] <= _GRAPH_AFTER or not _may_capture():
            return forward(params, config, h, valid=None, attn_bias=attn_bias, cache=cache)
        _CAPTURED.clear()
        _PENDING.clear()
        graph = _StepGraph(params, config, h, attn_bias, cache, tensors, shapes)
        _CAPTURED.append(graph)
    out = graph(h, attn_bias, cache.index)
    return out, dataclasses.replace(cache, index=cache.index + 1)


class _PrefillGraph:
    """One captured prefill of :func:`forward` from a cache's start, on a
    static batch of inputs and a static cache of its own: each replay copies
    the caller's inputs and cache in and the cache back out, so it writes
    the caller's cache as the eager prefill does.  Weak references to the
    parameters, as :class:`_StepGraph`."""

    def __init__(self, params, config, h, valid, cache):
        self.refs = [weakref.ref(t) for t in _param_tensors(params)]
        self.h, self.valid = h.clone(), valid.clone()
        self.cache = HybridCache(*(t.clone() for t in _cache_tensors(cache)), index=0)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out, _ = forward(params, config, self.h, valid=self.valid, attn_bias=None,
                                  cache=self.cache, flash_key_valid=self.cache.valid)

    def __call__(self, h, valid, cache) -> torch.Tensor:
        self.h.copy_(h)
        self.valid.copy_(valid)
        for mine, theirs in zip(_cache_tensors(self.cache), _cache_tensors(cache)):
            mine.copy_(theirs)
        self.graph.replay()
        for mine, theirs in zip(_cache_tensors(self.cache), _cache_tensors(cache)):
            theirs.copy_(mine)
        return self.out.clone()


def prefill(params: dict, config: HybridConfig, h: torch.Tensor, *, valid: torch.Tensor,
            cache: HybridCache) -> Tuple[torch.Tensor, HybridCache]:
    """A prefill from the start of ``cache`` (index 0) with the flash
    kernel over the cache's window, :func:`forward`'s, through a CUDA graph
    where one pays: where :func:`step` would, once :data:`_GRAPH_AFTER`
    eager prefills of the same shapes (inputs and cache) have run on the
    same parameters; one graph a shape, :data:`_PREFILL_GRAPHS` at most.
    Each replay copies the cache in and out (~40 MB a batch-1 window of
    512 at the published widths), so any cache of those shapes takes it."""
    if not (_graphs_on(h) and isinstance(cache.index, int) and cache.index == 0):
        return forward(params, config, h, valid=valid, attn_bias=None, cache=cache,
                       flash_key_valid=cache.valid)
    key = (tuple(h.shape), h.dtype) + tuple((tuple(t.shape), t.dtype)
                                            for t in _cache_tensors(cache))
    graph = _PREFILLS.get(key)
    if graph is not None and not _same(graph.refs, _param_tensors(params)):
        del _PREFILLS[key]
        graph = None
    if graph is None:
        _PREFILLS_SEEN[key] = _PREFILLS_SEEN.get(key, 0) + 1
        if _PREFILLS_SEEN[key] <= _GRAPH_AFTER or not _may_capture():
            return forward(params, config, h, valid=valid, attn_bias=None, cache=cache,
                           flash_key_valid=cache.valid)
        del _PREFILLS_SEEN[key]
        while len(_PREFILLS) >= _PREFILL_GRAPHS:
            del _PREFILLS[next(iter(_PREFILLS))]
        graph = _PREFILLS[key] = _PrefillGraph(params, config, h, valid, cache)
    out = graph(h, valid, cache)
    return out, dataclasses.replace(cache, index=h.shape[1])
