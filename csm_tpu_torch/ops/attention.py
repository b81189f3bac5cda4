"""Attention dispatch (counterpart of ``csm_tpu/ops/attention.py``).

``auto`` (default): multi-token forward passes whose queries start at
position 0 (the prefill and the uncached forward, training included: the
flash op carries its own backward kernels) go to the flash kernel when the
stack runs on CUDA and the kernels take its shape and type; everything else,
decode steps (``q_len == 1``) included, takes the plain path.  ``flash``
sends every shape the kernels take to the flash op on any device (on the CPU
the op runs its kernels' plain versions).  ``xla`` keeps the JAX package's
name, so scripts and environment settings carry over; here it names the
plain PyTorch attention, everywhere.  Set by ``CSM_TPU_ATTENTION``, read once
at import, or by :func:`set_attention_impl`.  The JAX package's
``pick_block`` has no counterpart: the kernels' tiles are fixed when they are
compiled.

Sequence-parallel passes (a mesh with ``seq > 1``) take
:func:`csm_tpu_torch.ops.flash_attention.flash_attention_sp` when
:func:`sp_flash_eligible`, on any device: on the CPU its kernels' plain
versions run, so the host drives the route the card takes.  An ineligible
shape takes the plain attention over the gathered K / V.
"""

from __future__ import annotations

import os

import torch

from csm_tpu_torch.config import LlamaConfig
from csm_tpu_torch.ops.flash_attention import DTYPES, GROUPS, HEAD_DIMS

IMPLS = ("auto", "flash", "xla")
_impl = "auto"


def set_attention_impl(impl: str) -> None:
    """Force the attention path: ``"auto"``, ``"flash"``, or ``"xla"`` (the
    plain PyTorch attention; module docstring).  Another value raises
    ``ValueError``."""
    global _impl
    if impl not in IMPLS:
        raise ValueError(impl)
    _impl = impl


set_attention_impl(os.environ.get("CSM_TPU_ATTENTION", "auto"))


def flash_eligible(q_len: int, config: LlamaConfig, layers: dict) -> bool:
    """Whether a ``q_len``-token pass of the stack ``config`` with the
    stacked weights ``layers`` should use the flash kernels: on CUDA (on any
    device under ``"flash"``; never under ``"xla"``), in a dtype, head dim
    and GQA group they take.  The head counts are the weights' own (this
    rank's heads under tensor parallelism); a head shard the kernels do not
    take where the whole stack's heads are taken raises, so that no sharded
    pass drifts to the plain attention on the card."""
    weight = layers["wq"]
    if _impl == "xla" or q_len < 2:
        return False
    if _impl == "auto" and weight.device.type != "cuda":
        return False
    hd = config.head_dim
    nq, nkv = weight.shape[-1] // hd, layers["wk"].shape[-1] // hd
    ok = _takes(nq, nkv, hd, weight.dtype)
    if not ok and _takes(config.num_attention_heads, config.num_key_value_heads, hd, weight.dtype):
        raise ValueError(f"a head shard of {nq} query / {nkv} KV heads is not taken by the "
                         "flash kernels, which take the whole stack's")
    return ok


def _takes(nq: int, nkv: int, head_dim: int, dtype: torch.dtype) -> bool:
    """Whether the flash kernels take this head layout and dtype."""
    return (dtype in DTYPES and head_dim in HEAD_DIMS and nkv > 0 and nq % nkv == 0
            and nq // nkv in GROUPS)


def sp_flash_eligible(mesh, batch: int, q_len: int, num_q_heads: int, num_kv_heads: int,
                      head_dim: int, dtype: torch.dtype) -> bool:
    """Whether a sequence-parallel pass of a global ``[batch, q_len]`` batch
    on ``mesh`` takes :func:`~csm_tpu_torch.ops.flash_attention.
    flash_attention_sp`: a ``seq`` axis above 1 that divides ``q_len``, a
    ``data`` axis that divides ``batch``, at least two frames a shard, and a
    dtype, head dim and GQA group the kernels take, on any device; never
    under ``"xla"``.  The head counts are this rank's (its share under
    tensor parallelism)."""
    if _impl == "xla" or mesh is None or mesh.size("seq") == 1:
        return False
    if q_len % mesh.size("seq") or batch % mesh.size("data"):
        return False
    if q_len // mesh.size("seq") < 2:
        return False
    return _takes(num_q_heads, num_kv_heads, head_dim, dtype)
