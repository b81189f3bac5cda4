"""Process mesh and sharding rules (counterpart of
``csm_tpu/parallel/mesh.py``).

A :class:`Mesh` lays the ranks of a ``torch.distributed`` job on three axes,
in the rank order of ``np.arange(n).reshape(data, seq, model)``:

- ``data``: each rank trains its rows of every global batch; gradients are
  summed over ``data`` x ``seq`` after the accumulation loop;
- ``seq``: each rank holds its frames of every row, and attention gathers
  K / V over the axis (:func:`csm_tpu_torch.ops.flash_attention.
  flash_attention_sp`);
- ``model``: tensor parallelism, not ported yet (``model > 1`` raises).

Every process holds the full global batch on the host (the data pipeline is
deterministic by item index), and takes its rows and frames of it
(:func:`batch_sharding`, :func:`shard_batch`): no data moves between ranks.

Backends: NCCL when each rank has a card of its own; gloo for ranks on the
CPU, or sharing one card when the caller asks for it.  The mesh
builds its groups with ``dist.new_group``, not ``init_device_mesh``, which
would pick NCCL for CUDA and fail on ranks that share a card.

The tensor-parallel layout table of the JAX package (``param_sharding``) is
kept as data for the slice that ports the ``model`` axis.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from datetime import timedelta
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in a ``(data, seq, model)`` mesh: the axis sizes,
    its coordinates and a process group per axis (``None`` for an axis of
    size 1), plus ``"batch"``, the ``data`` x ``seq`` ranks that share this
    rank's ``model`` index, over which gradients and losses are summed."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Optional[dist.ProcessGroup]]
    rank: int

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups[axis]


def mesh_coords(rank: int, data: int, seq: int, model: int) -> Dict[str, int]:
    """``rank``'s coordinates in ``np.arange(n).reshape(data, seq, model)``."""
    d, s, m = np.unravel_index(rank, (data, seq, model))
    return {"data": int(d), "seq": int(s), "model": int(m)}


def _default_backend(local_world_size: int, share_device: bool) -> str:
    """NCCL when every rank of this host has a card of its own; gloo on a
    host without CUDA, or when the caller lets the ranks share the cards.
    Fewer cards than local ranks otherwise raise: the ranks would pile onto
    one card unseen."""
    if not torch.cuda.is_available():
        return "gloo"
    cards = torch.cuda.device_count()
    if cards >= local_world_size:
        return "nccl"
    if share_device:
        return "gloo"
    raise RuntimeError(
        f"{local_world_size} ranks on this host but {cards} card(s): set LOCAL_RANK / "
        "LOCAL_WORLD_SIZE for a job over several hosts, or pass share_device=True to run "
        "the ranks on one card over gloo")


def maybe_init_distributed(share_device: bool = False) -> bool:
    """Environment-guarded process-group start (counterpart of the JAX
    package's ``jax.distributed`` bootstrap, the reference's ``torchrun``
    DDP reach):

    - ``CSM_TPU_COORDINATOR=host:port`` with ``CSM_TPU_NUM_PROCESSES`` and
      ``CSM_TPU_PROCESS_ID``: ``init_process_group(init_method="tcp://...")``;
    - ``CSM_TPU_MULTIHOST=1``: ``init_method="env://"`` from torchrun's
      ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``.

    ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` place a rank among its host's
    ranks; without them every rank is taken to be on this host.  The
    backend is NCCL when each local rank has a card of its own (the rank
    then takes ``cuda:<local rank>``), else gloo on a host without CUDA.
    More local ranks than cards raise unless ``share_device`` lets them
    share the card over gloo.
    Returns True when a process group is up (started here or before),
    False when the environment asks for none."""
    if dist.is_initialized():
        return True
    addr = os.environ.get("CSM_TPU_COORDINATOR")
    if addr:
        world = int(os.environ["CSM_TPU_NUM_PROCESSES"])
        rank = int(os.environ["CSM_TPU_PROCESS_ID"])
        init, kw = f"tcp://{addr}", dict(world_size=world, rank=rank)
    elif os.environ.get("CSM_TPU_MULTIHOST") == "1":
        world = int(os.environ.get("WORLD_SIZE", "1"))
        rank = int(os.environ.get("RANK", "0"))
        init, kw = "env://", {}
    else:
        return False
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = _default_backend(local_world, share_device)
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init, timeout=timedelta(minutes=10), **kw)
    return True


def make_mesh(data: Optional[int] = None, model: int = 1, seq: int = 1) -> Mesh:
    """This rank's :class:`Mesh` over the running process group.  ``data``
    defaults to ``world_size // (seq * model)``; the mesh must cover every
    rank.  Every rank must call it, in the same order as its other
    collectives (it creates the axis groups)."""
    if model != 1:
        raise NotImplementedError(
            f"model={model}: tensor parallelism is not ported yet (queued in ROADMAP.md); "
            "the port's mesh takes data and seq axes")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call maybe_init_distributed() "
                           "or torch.distributed.init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if data is None:
        data = world // (seq * model)
    if min(data, seq, model) < 1 or data * seq * model != world:
        raise ValueError(f"mesh {data}x{seq}x{model} must cover the {world} ranks")
    shape = {"data": data, "seq": seq, "model": model}
    grid = np.arange(world).reshape(data, seq, model)
    # Every rank creates every group, in this order.
    members = {
        "data": [grid[:, s, m] for s, m in itertools.product(range(seq), range(model))],
        "seq": [grid[d, :, m] for d, m in itertools.product(range(data), range(model))],
        "model": [grid[d, s, :] for d, s in itertools.product(range(data), range(seq))],
        "batch": [grid[:, :, m].reshape(-1) for m in range(model)],
    }
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    for axis, lists in members.items():
        groups[axis] = None
        for ranks in lists:
            if len(ranks) == 1:
                continue
            g = dist.new_group([int(r) for r in ranks])
            if rank in ranks:
                groups[axis] = g
    return Mesh(shape=shape, coords=mesh_coords(rank, data, seq, model), groups=groups,
                rank=rank)


# ---------------------------------------------------------------------------
# Batches: every process holds the full global batch
# ---------------------------------------------------------------------------


def batch_sharding(mesh: Optional[Mesh], batch: int, seq_len: int) -> Tuple[slice, slice]:
    """This rank's ``(rows, frames)`` of a ``[batch, seq_len, ...]`` global
    batch: rows split over ``data``, frames over ``seq``; the whole batch
    without a mesh."""
    if mesh is None:
        return slice(0, batch), slice(0, seq_len)
    d, s = mesh.size("data"), mesh.size("seq")
    if batch % d or seq_len % s:
        raise ValueError(f"a [{batch}, {seq_len}] batch does not split over data={d} x seq={s}")
    b, t = batch // d, seq_len // s
    i, j = mesh.index("data"), mesh.index("seq")
    return slice(i * b, (i + 1) * b), slice(j * t, (j + 1) * t)


def shard_batch(batch: dict, mesh: Mesh, batch_dim: int = 0) -> dict:
    """This rank's rows and frames of each ``[..., B, S, ...]`` array of a
    global batch (``batch_dim`` is the index of ``B``; ``S`` follows it)."""
    out = {}
    for k, v in batch.items():
        rows, frames = batch_sharding(mesh, v.shape[batch_dim], v.shape[batch_dim + 1])
        index = (slice(None),) * batch_dim + (rows, frames)
        out[k] = v[index]
    return out


def put_global_batch(batch: dict, mesh: Mesh, device) -> dict:
    """This rank's block of a host batch of ``[B, S, ...]`` numpy arrays,
    as tensors on ``device``."""
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
            for k, v in shard_batch(batch, mesh).items()}


# ---------------------------------------------------------------------------
# Tensor-parallel layout (data for the slice that ports the model axis)
# ---------------------------------------------------------------------------


def _llama_rules() -> dict:
    """Specs (one axis name or None per dimension) for one stacked Llama
    stack, leading axis = layers: attention projections on the head
    dimension, the gated MLP on the FFN dimension."""
    return {
        "layers": {
            "attn_norm": (),
            "wq": (None, None, "model"),
            "wk": (None, None, "model"),
            "wv": (None, None, "model"),
            "wo": (None, "model", None),
            "mlp_norm": (),
            "w_gate": (None, None, "model"),
            "w_up": (None, None, "model"),
            "w_down": (None, "model", None),
        },
        "final_norm": (),
    }


def _specs() -> dict:
    return {
        "backbone": _llama_rules(),
        "decoder": _llama_rules(),
        # Embedding tables: the vocab rows over the model axis.
        "text_embeddings": ("model", None),
        "audio_embeddings": ("model", None),
        "projection": (),
        # The heads' vocab dimension is 2051 (odd), which no mesh divides:
        # _fit_spec replicates them.
        "codebook0_head": (None, "model"),
        "audio_head": (None, None, "model"),
    }


def _fit_spec(spec: tuple, shape, sizes: Dict[str, int]) -> tuple:
    """Drop the sharding of any dimension the mesh does not divide (the odd
    2051 audio vocab): that dimension is replicated."""
    axes = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(a if (a is None or shape[i] % sizes[a] == 0) else None
                 for i, a in enumerate(axes))


def param_sharding(mesh: Optional[Mesh] = None, params: Optional[dict] = None) -> dict:
    """The layout of :func:`csm_tpu_torch.models.csm.init_params`' tree:
    one spec per parameter.  With ``params`` the specs are fitted to their
    shapes on the mesh's axis sizes."""
    specs = _specs()
    if params is None:
        return specs

    def fit(spec, p):
        if isinstance(spec, dict):
            return {k: fit(spec[k], p[k]) for k in spec}
        return _fit_spec(spec, tuple(p.shape), mesh.shape)

    return fit(specs, params)
