"""On-device measurement of the prefill (counterpart of
``csm_tpu/utils/measure.py``): the time of one prefill at a prompt length,
and its model FLOPs, whose quotient over the card's peak is the prefill's
model-FLOPs share.

On the card each call is timed by a pair of CUDA events after one untimed
warm-up call, and the median of the calls is taken; on the CPU the host
clock times each call, which returns when its work is done.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from csm_tpu_torch.device import DeviceLike, resolve_device

# Dense bf16 tensor-core peak of the H100 SXM, from NVIDIA's data sheet (not
# a measurement).
H100_BF16_DENSE_FLOPS = 989e12


@torch.no_grad()
def prefill_ms_on_device(
    params: dict,
    config,
    S: int,
    *,
    dtype=None,
    reps: int = 3,
    seed: int = 0,
    device: DeviceLike = None,
) -> float:
    """Median milliseconds of one prefill at prompt length ``S`` (a text-only
    prompt from ``default_rng(seed)``, the flash prefill path into a cache of
    ``S + 128`` slots rounded up to 128, the c0 head on the last position:
    the compute ``generate`` pays before its first frame).  ``params`` lie
    on ``device`` (CUDA unless ``"cpu"``); the cache is in ``dtype``
    (default: the params')."""
    from csm_tpu_torch.models import csm
    from csm_tpu_torch.models.llama import KVCache

    dev = resolve_device(device)
    if dtype is None:
        dtype = params["backbone"]["final_norm"].dtype
    cache_len = ((S + 128 + 127) // 128) * 128
    rng = np.random.default_rng(seed)
    ids = np.zeros((1, S, config.frame_width), np.int64)
    ids[..., -1] = rng.integers(1, config.text_vocab_size, (1, S))
    mask = np.zeros((1, S, config.frame_width), np.float32)
    mask[..., -1] = 1.0
    ids_t, mask_t = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
    cache = KVCache.create(config.backbone, 1, cache_len, dtype=dtype, device=dev)

    def prefill():
        # Every call writes the same rows of the same cache at index 0.
        return csm.forward(params, config, ids_t, mask_t, cache=cache, flash_prefill=True)

    times = []
    if dev.type == "cuda":
        prefill()
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            prefill()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            prefill()
            times.append(1000.0 * (time.perf_counter() - t0))
    return float(np.median(times))


def prefill_flops(params, config, S: int) -> float:
    """Model FLOPs of one prefill: 2·N·S over the backbone layers'
    parameters, norms included as the JAX package counts them (embedding
    gathers are not FLOPs), plus causal attention (qk and pv over the causal
    half-square).  ``params=None`` counts the configuration's shapes
    (:func:`csm_tpu_torch.parallel.mesh.param_shapes`), so no weights need
    to exist."""
    bb = config.backbone
    if params is None:
        from csm_tpu_torch.parallel.mesh import param_shapes

        shapes = param_shapes(config)["backbone"]["layers"].values()
    else:
        shapes = [tuple(x.shape) for x in params["backbone"]["layers"].values()]
    bb_mm = sum(int(np.prod(s)) for s in shapes)
    attn_fwd = 2 * 2 * S * S * bb.num_attention_heads * bb.head_dim * \
        bb.num_hidden_layers / 2
    return 2.0 * bb_mm * S + attn_fwd
