"""Training-state checkpoints (counterpart of
``csm_tpu/checkpoint/orbax_io.py``): ``{params, opt_state, step}`` bundles
written with ``torch.save``, one directory per step, with retention (HF
Trainer's ``save_total_limit`` rotation, reference ``train.py:263-264``) and
resume from the latest.

Layout: ``<directory>/<step>/state.pt``.  A bundle is written to a temporary
file and renamed into place, so a step directory that exists holds a
complete bundle.

Under a process group rank 0 writes, between two barriers: no rank reads a
directory that is being written, and every rank restores from it.  So every
rank must hold the same state: under tensor parallelism, where each rank
holds its shard, the caller passes the whole state, gathered over the
``model`` axis, and cuts what it loads for its mesh (``CSMTrainer`` does
both), so a bundle does not depend on the mesh that wrote it.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

_FILE = "state.pt"


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit() and os.path.exists(os.path.join(directory, d, _FILE)))


def _to_host(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def on_rank_zero(write: Callable[[], None]) -> None:
    """Run ``write`` on rank 0 of the running process group, between two
    barriers (every rank calls this); without a group, just run it."""
    if not dist.is_initialized():
        write()
        return
    dist.barrier()
    if dist.get_rank() == 0:
        write()
    dist.barrier()


def save_checkpoint(directory: str, step: int, state: Any, max_to_keep: Optional[int] = 3) -> None:
    """Save ``state`` (nested dicts / lists of tensors and plain values;
    tensors are copied to the host) at ``step``, then drop the oldest steps
    beyond ``max_to_keep`` (``None`` keeps all).  Under a process group,
    every rank calls it and rank 0 writes (:func:`on_rank_zero`)."""

    def write():
        out = os.path.join(os.path.abspath(directory), str(int(step)))
        os.makedirs(out, exist_ok=True)
        tmp = os.path.join(out, f"{_FILE}.{os.getpid()}.tmp")
        torch.save(_to_host(state), tmp)
        os.replace(tmp, os.path.join(out, _FILE))
        if max_to_keep is not None:
            for old in _steps(directory)[:-max_to_keep]:
                shutil.rmtree(os.path.join(directory, str(old)), ignore_errors=True)

    on_rank_zero(write)


def latest_step(directory: str) -> Optional[int]:
    """The newest saved step in ``directory``, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def load_checkpoint(directory: str, step: Optional[int] = None, map_location="cpu") -> Any:
    """The bundle saved at ``step`` (default: the latest), its tensors on
    ``map_location``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, str(int(step)), _FILE)
    return torch.load(path, map_location=map_location, weights_only=True)
