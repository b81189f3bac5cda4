"""Driver entry points (counterpart of the JAX package's
``__graft_entry__.py``).

``entry()``: a CSM-1B forward on zero bf16 weights on the card, so a prefill
through the flash kernel, for a quick check that the port runs there.

``dryrun_multichip(n)``: one full training step (gradient accumulation,
AdamW) on ``n`` spawned ranks laid out as a ``data x seq x model`` mesh:
batch rows split over ``data``, frames over ``seq``, attention heads, FFN
and vocabulary over ``model``, on tiny shapes.  With one card the ranks
share it over gloo.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from csm_tpu_torch.config import CSMConfig
from csm_tpu_torch.device import DeviceLike, resolve_device

DRYRUN_TIMEOUT_S = 600.0


def entry(device: DeviceLike = None):
    """Return ``(fn, example_args)``: ``fn(*example_args)`` is a CSM-1B
    forward at B = 1, S = 128 on zero bf16 parameters on ``device`` (CUDA
    unless ``"cpu"``), returning the c0 logits ``[1, audio_vocab_size]``."""
    from csm_tpu_torch.models import csm
    from csm_tpu_torch.parallel.mesh import param_shapes

    dev = resolve_device(device)
    config = CSMConfig()  # CSM-1B shape
    B, S = 1, 128

    def zeros(shape):
        if isinstance(shape, dict):
            return {k: zeros(v) for k, v in shape.items()}
        return torch.zeros(shape, dtype=torch.bfloat16, device=dev)

    params = zeros(param_shapes(config))

    @torch.no_grad()
    def fn(params, input_ids, attention_mask):
        return csm.forward(params, config, input_ids, attention_mask).logits

    example_args = (
        params,
        torch.zeros((B, S, config.frame_width), dtype=torch.long, device=dev),
        torch.ones((B, S, config.frame_width), dtype=torch.float32, device=dev),
    )
    return fn, example_args


def mesh_axes(n_devices: int) -> dict:
    """The JAX dryrun's layout: ``model = 2`` when ``n`` is even, ``seq = 2``
    when 4 divides it, ``data`` the rest."""
    model = 2 if n_devices % 2 == 0 else 1
    seq = 2 if n_devices % 4 == 0 else 1
    return {"data": n_devices // (model * seq), "seq": seq, "model": model}


def dryrun_batch(config: CSMConfig, dp: int) -> dict:
    """The JAX dryrun's batch: ``[accum 2, B = dp, S = 16, 33]`` from
    ``default_rng(0)``, 32 audio ids then one text id a frame, every token
    valid, labels = ids."""
    accum, B, S = 2, dp, 16
    rng = np.random.default_rng(0)
    ids = np.concatenate([
        rng.integers(0, config.audio_vocab_size, (accum, B, S, 32)),
        rng.integers(0, config.text_vocab_size, (accum, B, S, 1)),
    ], axis=-1)
    return {"input_ids": ids, "attention_mask": np.ones((accum, B, S, config.frame_width),
                                                        np.float32),
            "labels": ids}


def _dryrun_rank(axes: dict, device: str, params, batch: dict) -> dict:
    """One rank of the dryrun: its mesh, its shard of the parameters (seed 0,
    or ``params``), one train step; the step's metrics."""
    from csm_tpu_torch.checkpoint import params_from_jax
    from csm_tpu_torch.models import csm
    from csm_tpu_torch.parallel import make_mesh, shard_params
    from csm_tpu_torch.train import make_optimizer, make_train_step

    config = CSMConfig.tiny()
    mesh = make_mesh(**axes)
    if params is None:
        params = csm.init_params(config, 0, torch.float32, device)
    else:
        params = params_from_jax(params, config, device)
    if axes["model"] > 1:
        params = shard_params(params, mesh, config)
    optimizer = make_optimizer(1e-4, total_steps=10)
    step = make_train_step(config, optimizer, max_decoder_frames=8, mesh=mesh)
    state = optimizer.init(params)
    _, metrics = step(state, None, {k: torch.as_tensor(v, device=device)
                                    for k, v in batch.items()})
    return {k: float(v) for k, v in metrics.items()}


def dryrun_multichip(n_devices: int, *, device: DeviceLike = None,
                     params: Optional[dict] = None) -> dict:
    """One full training step of ``CSMConfig.tiny()`` over an ``n_devices``
    mesh (:func:`mesh_axes`) on spawned ranks, all on ``device`` (CUDA
    unless ``"cpu"``; ranks share a card over gloo).  ``params``: the
    starting weights as a numpy tree in the shared parameter layout (the
    JAX package's, for a test to compare steps), else the port's seed-0
    init.  Prints the JAX dryrun's line and returns rank 0's metrics."""
    from csm_tpu_torch.parallel.launch import launch, to_numpy

    dev = resolve_device(device)
    axes = mesh_axes(n_devices)
    config = CSMConfig.tiny()
    if params is not None:
        params = to_numpy(params)
    metrics = launch(_dryrun_rank, n_devices, axes, str(dev), params,
                     dryrun_batch(config, axes["data"]), timeout=DRYRUN_TIMEOUT_S)[0]
    loss = metrics["loss"]
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip: non-finite loss {loss}")
    print(
        f"dryrun_multichip ok: mesh={axes} "
        f"loss={loss:.4f} backbone={metrics['backbone_loss']:.4f} "
        f"decoder={metrics['decoder_loss']:.4f}"
    )
    return metrics
