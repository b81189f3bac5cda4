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

Tensor parallelism: the adapters stay whole (replicated) over a sharded
base, as in the JAX package.  :func:`apply_lora` merges into this rank's
shard of a target: the columns of ``B`` that belong to a column-parallel
target (``wq`` / ``wk`` / ``wv`` / ``w_gate`` / ``w_up``), the rows of ``A``
of a row-parallel one (``wo`` / ``w_down``).  Both factors of a sharded
target pass :func:`~csm_tpu_torch.parallel.collectives.copy_to_model`
first, so their gradients, each rank's share, are summed over ``model``:
every rank gets the whole gradient and updates its copy alike.  A target the
layout keeps replicated needs no sum.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from csm_tpu_torch.parallel.collectives import copy_to_model

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


def apply_lora(params: dict, lora: dict, alpha: float, rank: int, mesh=None) -> dict:
    """``params`` with the adapters folded in, ``W' = W + (alpha/rank) * A @
    B`` per stacked target matrix (fp32, cast back to ``W``'s dtype).
    Differentiable in ``lora``: the train step's loss goes through it.
    ``mesh``: ``params`` are this rank's shards over its ``model`` axis; the
    whole adapters are merged into them (module docstring)."""
    scale = alpha / rank
    out = dict(params)
    for stack, mats in lora.items():
        layers = dict(params[stack]["layers"])
        for name, ab in mats.items():
            w = layers[name]
            a, b = ab["A"], ab["B"]
            if w.shape[-2:] != (a.shape[-2], b.shape[-1]):
                a, b = _local_factors(a, b, w, mesh)
            delta = torch.einsum("lkr,lrn->lkn", a.float(), b.float())
            layers[name] = (w.float() + scale * delta).to(w.dtype)
        out[stack] = {**params[stack], "layers": layers}
    return out


def _local_factors(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor, mesh):
    """The factors of this rank's shard ``w`` of a target: ``B``'s columns
    of a column-parallel shard, ``A``'s rows of a row-parallel one, after
    :func:`copy_to_model` on both."""
    if mesh is None or mesh.size("model") == 1:
        raise ValueError(f"a target of shape {tuple(w.shape)} is a shard of a model axis: pass "
                         "the mesh it was cut for")
    group, i = mesh.group("model"), mesh.index("model")
    a, b = copy_to_model(a, group), copy_to_model(b, group)
    if w.shape[-1] != b.shape[-1]:
        n = w.shape[-1]
        return a, b[..., i * n:(i + 1) * n]
    n = w.shape[-2]
    return a[..., i * n:(i + 1) * n, :], b


@torch.no_grad()
def merge_lora(params: dict, lora: dict, alpha: float, rank: int) -> dict:
    """The merged checkpoint (same arithmetic as :func:`apply_lora`); it
    saves through ``save_params_to_safetensors`` as an ordinary
    reference-layout model."""
    return apply_lora(params, lora, alpha, rank)
