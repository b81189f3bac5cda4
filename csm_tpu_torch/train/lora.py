"""LoRA adapters for parameter-efficient CSM fine-tuning (counterpart of
``csm_tpu/train/lora.py``).

Rank-``r`` additive factors on selected projection matrices while the base
checkpoint stays frozen.  Adapters keep the stacked-layer layout of the
parameters, ``A [L, K, r]`` / ``B [L, r, N]`` per target matrix, so the
forward runs unchanged on the merged weights; merging is one batched product
per target, computed in fp32, and only the adapters receive gradients.
``merge_lora`` folds them into a reference-layout checkpoint.

Standard scaling: ``W' = W + (alpha / r) * A @ B``; ``B`` is zero at init,
so step 0 is exactly the base model.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

DEFAULT_TARGETS: Tuple[str, ...] = ("wq", "wv")
STACKS = ("backbone", "decoder")


def init_lora_params(
    generator: torch.Generator,
    params: dict,
    rank: int,
    targets: Sequence[str] = DEFAULT_TARGETS,
    dtype=torch.float32,
) -> dict:
    """Zero-effect adapters: ``A ~ N(0, 1) / r`` drawn from ``generator``
    (on its device), ``B = 0``, for each target matrix of each stack, shaped
    off the base parameters."""
    lora: dict = {}
    for stack in STACKS:
        lora[stack] = {}
        for name in targets:
            w = params[stack]["layers"][name]  # [L, K, N]
            L, K, N = w.shape
            a = torch.randn((L, K, rank), generator=generator, device=generator.device,
                            dtype=torch.float32) / rank
            lora[stack][name] = {
                "A": a.to(device=w.device, dtype=dtype),
                "B": torch.zeros((L, rank, N), dtype=dtype, device=w.device),
            }
    return lora


def apply_lora(params: dict, lora: dict, alpha: float, rank: int) -> dict:
    """``params`` with the adapters folded in, ``W' = W + (alpha/rank) * A @
    B`` per stacked target matrix (fp32, cast back to ``W``'s dtype).
    Differentiable in ``lora``: the train step's loss goes through it."""
    scale = alpha / rank
    out = dict(params)
    for stack, mats in lora.items():
        layers = dict(params[stack]["layers"])
        for name, ab in mats.items():
            delta = torch.einsum("lkr,lrn->lkn", ab["A"].float(), ab["B"].float())
            w = layers[name]
            layers[name] = (w.float() + scale * delta).to(w.dtype)
        out[stack] = {**params[stack], "layers": layers}
    return out


@torch.no_grad()
def merge_lora(params: dict, lora: dict, alpha: float, rank: int) -> dict:
    """The merged checkpoint (same arithmetic as :func:`apply_lora`); it
    saves through ``save_params_to_safetensors`` as an ordinary
    reference-layout model."""
    return apply_lora(params, lora, alpha, rank)
