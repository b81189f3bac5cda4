"""Process mesh and sharding rules (counterpart of
``csm_tpu/parallel/mesh.py``).

A :class:`Mesh` lays the ranks of a ``torch.distributed`` job on three axes,
in the rank order of ``np.arange(n).reshape(data, seq, model)``:

- ``data``: each rank trains its rows of every global batch; gradients are
  summed over ``data`` x ``seq`` after the accumulation loop;
- ``seq``: each rank holds its frames of every row, and attention gathers
  K / V over the axis (:func:`csm_tpu_torch.ops.flash_attention.
  flash_attention_sp`);
- ``model``: Megatron-style tensor parallelism.  Each rank holds its shard
  of the parameters (:func:`shard_params`): the attention projections cut on
  the head dimension (``wq`` / ``wk`` / ``wv`` on their output columns,
  ``wo`` on its input rows), the gated MLP on the FFN dimension (``w_gate`` /
  ``w_up`` on columns, ``w_down`` on rows), both embedding tables on their
  vocab rows; the model sums the row-parallel products and the lookups over
  the axis (:mod:`csm_tpu_torch.parallel.collectives`).

Every process holds the full global batch on the host (the data pipeline is
deterministic by item index), and takes its rows and frames of it
(:func:`batch_sharding`, :func:`shard_batch`): no data moves between ranks.

Backends: NCCL when each rank has a card of its own; gloo for ranks on the
CPU, or sharing one card when the caller asks for it.  The mesh
builds its groups with ``dist.new_group``, not ``init_device_mesh``, which
would pick NCCL for CUDA and fail on ranks that share a card.

The layout table is the JAX package's (:func:`param_sharding` without
arguments).  Fitted to a configuration it differs in one deliberate rule, at
head granularity: a stack's ``wq`` / ``wk`` / ``wv`` / ``wo`` are sharded
only when the ``model`` axis divides both its query and its KV head counts,
else they stay replicated (the stack's MLP is still sharded where the axis
divides its FFN width).  XLA's partitioner may split a head's columns and
reshard; the port's explicit products cannot.  ``CSMConfig.tiny()``'s
decoder (2 query / 1 KV head) keeps replicated attention at ``model=2``.
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

from csm_tpu_torch.parallel.collectives import all_gather_frames

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
# Tensor-parallel layout
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


ATTENTION = ("wq", "wk", "wv", "wo")


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


def param_shapes(config) -> dict:
    """The shape of every parameter of :func:`csm_tpu_torch.models.csm.
    init_params` under ``config`` (a ``CSMConfig``)."""

    def stack(c):
        L, D, F, hd = c.num_hidden_layers, c.hidden_size, c.intermediate_size, c.head_dim
        q, kv = c.num_attention_heads * hd, c.num_key_value_heads * hd
        return {"layers": {"attn_norm": (L, D), "wq": (L, D, q), "wk": (L, D, kv),
                           "wv": (L, D, kv), "wo": (L, q, D), "mlp_norm": (L, D),
                           "w_gate": (L, D, F), "w_up": (L, D, F), "w_down": (L, F, D)},
                "final_norm": (D,)}

    D, Dd = config.backbone.hidden_size, config.decoder.hidden_size
    Va = config.audio_vocab_size
    return {"backbone": stack(config.backbone), "decoder": stack(config.decoder),
            "text_embeddings": (config.text_vocab_size, D),
            "audio_embeddings": (config.audio_embedding_rows, D), "projection": (D, Dd),
            "codebook0_head": (D, Va), "audio_head": (config.audio_num_codebooks - 1, Dd, Va)}


def param_sharding(mesh: Optional[Mesh] = None, params: Optional[dict] = None,
                   config=None) -> dict:
    """The layout of :func:`csm_tpu_torch.models.csm.init_params`' tree:
    one spec per parameter.  Without ``config`` the raw table, the JAX
    package's.  With ``config`` (a ``CSMConfig``) the specs are fitted on
    the mesh's axis sizes to the shapes of ``params`` (default: the
    configuration's own, :func:`param_shapes`): per dimension as the JAX
    package's ``_fit_spec``, then at head granularity, a stack's attention
    projections are replicated unless the ``model`` axis divides both its
    query and its KV head counts (module docstring)."""
    specs = _specs()
    if config is None:
        if params is not None:
            raise ValueError("fitting the specs needs the config (its head counts)")
        return specs
    shapes = (param_shapes(config) if params is None
              else _tree_map(lambda p: tuple(p.shape), params))

    def fit(spec, shape):
        if isinstance(spec, dict):
            return {k: fit(spec[k], shape[k]) for k in spec}
        return _fit_spec(spec, shape, mesh.shape)

    fitted = fit(specs, shapes)
    m = mesh.shape["model"]
    for name in ("backbone", "decoder"):
        c = getattr(config, name)
        if c.num_attention_heads % m or c.num_key_value_heads % m:
            layers = fitted[name]["layers"]
            for w in ATTENTION:
                layers[w] = (None,) * len(layers[w])
    return fitted


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def sharded_dim(spec: tuple) -> Optional[int]:
    """The dimension a fitted spec cuts over ``model``, or None."""
    return spec.index("model") if "model" in spec else None


def take_shard(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` over the mesh's ``model``
    axis, as a tensor of its own."""
    n = t.shape[dim] // mesh.size("model")
    return t.narrow(dim, mesh.index("model") * n, n).clone()


def shard_params(params: dict, mesh: Mesh, config) -> dict:
    """This rank's parameters on ``mesh``: each tensor of ``params`` (the
    whole tree, on any device) cut by ``param_sharding(mesh, params,
    config)`` at ``mesh.index("model")`` (:func:`take_shard`); replicated
    tensors are returned as given."""
    specs = param_sharding(mesh, params, config)

    def cut(spec, p):
        d = sharded_dim(spec)
        return p if d is None or mesh.size("model") == 1 else take_shard(p, d, mesh)

    return _tree_map(cut, specs, params)


def gather_params(local: dict, mesh: Mesh, config) -> dict:
    """The inverse of :func:`shard_params`: every sharded tensor of
    ``local`` all-gathered over the mesh's ``model`` group (every rank of
    the group calls it and gets the whole tree); replicated tensors are
    returned as given."""
    specs = param_sharding(mesh, config=config)
    group = mesh.group("model")

    def gather(spec, p):
        d = sharded_dim(spec)
        return p if d is None else all_gather_frames(p.contiguous(), group, dim=d)

    return _tree_map(gather, specs, local)
