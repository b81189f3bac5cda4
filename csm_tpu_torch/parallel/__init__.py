"""Data- and sequence-parallel training over ``torch.distributed`` (the
counterpart of ``csm_tpu/parallel``): a ``(data, seq, model)`` mesh of
ranks, this rank's block of the global batch, the collectives of the
sharded train step and a launcher of spawned ranks.  Tensor parallelism
(``model > 1``) is not ported yet."""

from csm_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    make_mesh,
    maybe_init_distributed,
    param_sharding,
    put_global_batch,
    shard_batch,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "maybe_init_distributed",
    "param_sharding",
    "batch_sharding",
    "put_global_batch",
    "shard_batch",
]
