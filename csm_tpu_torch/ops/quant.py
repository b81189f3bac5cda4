"""W8A16 weights for the backbone's plain decode step (counterpart of
``csm_tpu/ops/quant.py``): int8 per-output-channel weights against bf16
activations, f32 sums, the scale applied to the output.  A plain PyTorch
product, not a kernel (the JAX package leaves it to XLA): it serves the
per-frame backbone steps that the int8 backbone kernel does not take
(``B > 32``).  The prefill and training stay in the param dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch

from csm_tpu_torch.config import CSMConfig

_MATS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_per_channel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of ``[..., K, N]``:
    ``(q int8 [..., K, N], scale f32 [..., 1, N])`` with ``w ~ q * scale``;
    rounding half to even, as the JAX package's."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def qmm(x: torch.Tensor, wq: torch.Tensor, s: torch.Tensor, acc: torch.dtype = torch.float32,
        act: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """W8A16 product ``x [..., K] @ wq [K, N]`` (int8 values are exact in
    bf16): activations rounded to ``act``, sums in ``acc``, then the
    per-output-channel scale ``s [1, N]``; f32."""
    return (x.to(act).to(acc) @ wq.to(acc)).float() * s


def prepare_quantized_backbone(params: dict, config: CSMConfig) -> dict:
    """The backbone's matmul weights in int8 (norms stay float):
    ``{"w": {name: int8 [L, K, N]}, "s": {name: f32 [L, 1, N]}}`` with Q/K/V
    and gate/up fused into ``wqkv`` / ``w_gu`` (per-output-channel scales
    make the concatenation exact); the shape
    :func:`csm_tpu_torch.models.llama.forward` takes as ``qlayers``."""
    del config
    layers = params["backbone"]["layers"]
    q = {name: quantize_per_channel(layers[name]) for name in _MATS}
    out = {"w": {}, "s": {}}
    for name, parts in (("wqkv", ("wq", "wk", "wv")), ("wo", ("wo",)),
                        ("w_gu", ("w_gate", "w_up")), ("w_down", ("w_down",))):
        out["w"][name] = torch.cat([q[p][0] for p in parts], dim=-1).contiguous()
        out["s"][name] = torch.cat([q[p][1] for p in parts], dim=-1).contiguous()
    return out
