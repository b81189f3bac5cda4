"""The Mamba-2 mixer's decode step: the CUDA kernel ``csrc/ssm_step.cu`` and
its plain PyTorch version (the CPU path and the kernel's test oracle).

One call advances every stream of a batch by one frame through one mixer
layer, between the layer's two projections (``in_proj``, whose output it
reads, and ``out_proj``, which stays a cuBLAS product after the gated
RMSNorm).  Per stream, from ``zxbcdt = [z | xBC | dt]``:

- the causal depthwise conv of width ``d_conv`` over ``xBC``: the conv state
  (the last ``d_conv - 1`` inputs, ``[B, d_conv - 1, conv_dim]``) shifted by
  the new input, then bias, the taps' sum and SiLU, in float32;
- ``Δ = softplus(dt + dt_bias)`` and ``A = -exp(A_log)`` per head;
- per head the state ``S [P, N] = exp(Δ A) S + Δ x ⊗ B`` updated in place
  (read once, written once, in the activations' dtype), then
  ``y = S C + D x`` from the float32 update, before it is stored;
- the gate ``y ⊙ silu(z)``, returned in float32 ``[B, H * P]``.

Both conv state and recurrent state are updated in place.  The kernel runs
one block per (head, stream); the ``B`` and ``C`` channels' conv state, which
every head of a stream reads, is shifted by the last of the stream's blocks
to arrive (a per-stream counter that re-arms itself).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from csm_tpu_torch.ops import _build
from csm_tpu_torch.utils.profiling import span

KERNEL = "ssm_step"
# Return codes from this one on are arguments the kernel refuses.
_REFUSED = 10001
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

_F, _I = ctypes.c_void_p, ctypes.c_int
# The C functions of csrc/ssm_step.cu: (argtypes, restype).
SIGNATURES = {
    "ssm_step": ([_F] * 10 + [_I] * 9 + [_F], _I),
    "ssm_error_string": ([_I], ctypes.c_char_p),
}


def _lib():
    return _build.load(KERNEL, SIGNATURES)


def conv_silu(window: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SiLU of the causal depthwise conv at the last position of each
    ``window [..., d_conv, C]`` (oldest input first), float32: ``b + Σ_k
    w[:, k] window[k]`` with ``w [C, d_conv]``, ``b [C]``, summed in the
    kernel's order (bias, then the taps oldest first)."""
    acc = b.float().expand(window.shape[:-2] + b.shape)
    for k in range(window.shape[-2]):
        acc = acc + w[:, k].float() * window[..., k, :].float()
    return F.silu(acc)


def ssm_step_reference(zxbcdt, conv_state, ssm_state, lp: dict, config) -> torch.Tensor:
    """The plain version of :func:`ssm_step` (same arguments and effects):
    float32 arithmetic, the states updated in place in their own dtype."""
    H, P, N, G = config.mamba_n_heads, config.mamba_d_head, config.mamba_d_state, \
        config.mamba_n_groups
    inner, C = config.mamba_inner, config.conv_dim
    Bsz = zxbcdt.shape[0]
    z = zxbcdt[:, :inner].float()
    xbc_new = zxbcdt[:, inner:inner + C]
    dt = zxbcdt[:, inner + C:].float()
    window = torch.cat([conv_state, xbc_new[:, None].to(conv_state.dtype)], dim=1)
    xbc = conv_silu(window, lp["conv_w"], lp["conv_b"])
    conv_state.copy_(window[:, 1:])
    x = xbc[:, :inner].reshape(Bsz, H, P)
    Bm = xbc[:, inner:inner + G * N].reshape(Bsz, G, N).repeat_interleave(H // G, dim=1)
    Cm = xbc[:, inner + G * N:].reshape(Bsz, G, N).repeat_interleave(H // G, dim=1)
    delta = F.softplus(dt + lp["dt_bias"].float())  # [B, H]
    dA = torch.exp(delta * -torch.exp(lp["A_log"].float()))
    s = dA[:, :, None, None] * ssm_state.float() + (delta[:, :, None] * x)[..., None] * Bm[:, :, None]
    y = (s * Cm[:, :, None]).sum(dim=-1) + lp["D"].float()[:, None] * x
    ssm_state.copy_(s.to(ssm_state.dtype))
    return y.reshape(Bsz, inner) * F.silu(z)


def _check(zxbcdt, conv_state, ssm_state, lp: dict, config) -> None:
    """ValueError naming the limit the kernel does not take."""
    H, P, N, G = config.mamba_n_heads, config.mamba_d_head, config.mamba_d_state, \
        config.mamba_n_groups
    if config.mamba_d_conv != 4:
        raise ValueError(f"ssm_step kernel: d_conv {config.mamba_d_conv} (4)")
    if P % 8 or P > 64:
        raise ValueError(f"ssm_step kernel: d_head {P} (a multiple of 8, at most 64)")
    if N % 128 or N > 256:
        raise ValueError(f"ssm_step kernel: d_state {N} (128 or 256)")
    if H % G:
        raise ValueError(f"ssm_step kernel: {G} groups do not divide {H} heads")
    dt = zxbcdt.dtype
    if dt not in _DTYPES or any(t.dtype != dt for t in (
            conv_state, ssm_state, *(lp[k] for k in ("conv_w", "conv_b", "dt_bias", "A_log",
                                                     "D")))):
        raise ValueError("ssm_step kernel: the activations, both states and the layer's "
                         "parameters must share one dtype, bf16 or f32")
    for name, t in (("zxbcdt", zxbcdt), ("conv_state", conv_state), ("ssm_state", ssm_state),
                    *((k, lp[k]) for k in ("conv_w", "conv_b", "dt_bias", "A_log", "D"))):
        if not t.is_contiguous():
            raise ValueError(f"ssm_step kernel: {name} must be contiguous")


# One zeroed int32 counter a stream per device, kept across calls; the
# kernel re-arms each counter it uses.
_COUNTERS: dict = {}


def ssm_step(zxbcdt: torch.Tensor, conv_state: torch.Tensor, ssm_state: torch.Tensor,
             lp: dict, config) -> torch.Tensor:
    """One frame of one mixer layer for every stream: ``zxbcdt [B,
    in_proj_dim]`` (``in_proj``'s output), ``conv_state [B, d_conv - 1,
    conv_dim]`` and ``ssm_state [B, H, P, N]`` (both updated in place),
    ``lp`` the layer's ``conv_w``, ``conv_b``, ``dt_bias``, ``A_log`` and
    ``D``, ``config`` a :class:`~csm_tpu_torch.config.HybridConfig`.  Returns
    the gated output ``y ⊙ silu(z)``, float32 ``[B, H * P]``.  CPU tensors
    take the plain version; CUDA tensors launch the kernel (either inside a
    ``csm.ssm.launch`` span).  ``ssm_step.launches`` counts kernel launches
    (a replayed CUDA graph's too: ``models/hybrid.py`` adds those it holds)."""
    dev = zxbcdt.device
    if dev.type != "cuda":
        with span("csm.ssm.launch", device=True, B=zxbcdt.shape[0]):
            return ssm_step_reference(zxbcdt, conv_state, ssm_state, lp, config)
    _check(zxbcdt, conv_state, ssm_state, lp, config)
    Bsz = zxbcdt.shape[0]
    H, P, N, G = config.mamba_n_heads, config.mamba_d_head, config.mamba_d_state, \
        config.mamba_n_groups
    cnt = _COUNTERS.get(dev)
    if cnt is None or cnt.numel() < Bsz:
        cnt = _COUNTERS[dev] = torch.zeros((max(Bsz, 64),), dtype=torch.int32, device=dev)
    y = torch.empty((Bsz, config.mamba_inner), dtype=torch.float32, device=dev)
    lib = _lib()
    with span("csm.ssm.launch", device=True, B=Bsz):
        rc = lib.ssm_step(
            zxbcdt.data_ptr(), conv_state.data_ptr(), lp["conv_w"].data_ptr(),
            lp["conv_b"].data_ptr(), lp["dt_bias"].data_ptr(), lp["A_log"].data_ptr(),
            lp["D"].data_ptr(), ssm_state.data_ptr(), y.data_ptr(), cnt.data_ptr(),
            Bsz, H, P, N, G, config.conv_dim, config.mamba_inner, zxbcdt.shape[1],
            _DTYPES[zxbcdt.dtype], _build.stream_handle(dev))
    if rc >= _REFUSED:
        raise ValueError(f"ssm_step kernel (B={Bsz}): {lib.ssm_error_string(rc).decode()}")
    if rc != 0:
        raise RuntimeError(f"ssm_step launch failed: {lib.ssm_error_string(rc).decode()}")
    ssm_step.launches += 1
    return y


ssm_step.launches = 0
