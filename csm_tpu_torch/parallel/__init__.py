"""Data-, sequence- and tensor-parallel training and tensor-parallel
generation over ``torch.distributed`` (the counterpart of
``csm_tpu/parallel``): a ``(data, seq, model)`` mesh of ranks, this rank's
block of the global batch, this rank's shard of the parameters and its
inverse, the collectives of the sharded model and train step, and a launcher
of spawned ranks."""

from csm_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    gather_params,
    make_mesh,
    maybe_init_distributed,
    param_sharding,
    put_global_batch,
    shard_batch,
    shard_params,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "maybe_init_distributed",
    "param_sharding",
    "shard_params",
    "gather_params",
    "batch_sharding",
    "put_global_batch",
    "shard_batch",
]
