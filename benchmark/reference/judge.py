"""Judging served tokens by a reference's logits, whatever the model: the
gap of a greedy token below the best, of a sampled one below the ``k``-th
best, and the sampler's draw for the controls."""

from __future__ import annotations

from typing import Optional

import torch


def by_token(c0: torch.Tensor, rest: torch.Tensor) -> torch.Tensor:
    """``(c0 [F, V], rest [F, 31, V])`` -> ``[F, 32, V]``, one row a served
    token."""
    return torch.cat([c0[:, None], rest], dim=1)


def gaps_below_best(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``[F, 32]``: by how far each token's reference logit lies below the
    reference's best at its position (0 where it is the best)."""
    return ref.max(dim=-1).values - ref.gather(-1, tokens[..., None].long())[..., 0]


def gaps_below_topk(ref: torch.Tensor, tokens: torch.Tensor, k: int) -> torch.Tensor:
    """``[F, 32]``: by how far each token's reference logit lies below the
    reference's ``k``-th best at its position (0 inside the top ``k``)."""
    kth = torch.topk(ref, min(k, ref.shape[-1]), dim=-1).values[..., -1]
    return (kth - ref.gather(-1, tokens[..., None].long())[..., 0]).clamp(min=0)


def draw(logits: torch.Tensor, temperature: float, topk: Optional[int],
         generator: torch.Generator) -> torch.Tensor:
    """A token a row, as the port's sampler draws it (``modeling_csm``'s
    recipe): Gumbel-max over ``logits / temperature`` with all but the top
    ``topk`` (ties kept) left out; ``topk=None`` keeps every token."""
    x = logits.float() / temperature
    if topk is not None:
        kth = torch.topk(x, min(topk, x.shape[-1]), dim=-1).values[..., -1:]
        x = torch.where(x < kth, torch.full_like(x, -torch.inf), x)
    e = torch.empty(x.shape, device=x.device).exponential_(generator=generator)
    return torch.argmax(x - torch.log(e), dim=-1)
