"""Generation warm-up (counterpart of ``csm_tpu/utils/warmup.py``): pay a
deployment's first-call costs before the first real request.

PyTorch compiles nothing ahead of time, so the warm-up runs the work once.
On the card it first builds (``nvcc``, once per source; later processes
reuse ``csm_tpu_torch/_build/``) and loads every kernel library and the
native audio library, then runs one :func:`csm_tpu_torch.generation.
generate_compiled` for every (batch, prompt bucket, frame budget) on a zero
prompt of that shape: the CUDA context and library handles, the kernels'
scratch buffers and the caching allocator's blocks are then in place, and
left there.  A failed build or launch raises; nothing falls back to the
plain path.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional, Sequence

import torch

from csm_tpu_torch.config import CSMConfig
from csm_tpu_torch.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)


def _load_kernels() -> None:
    """Build every ``csrc/*.cu`` (one ``nvcc`` each, started together) and
    load each library with its wrapper's signatures, and the native audio
    library; raises if any of them fails."""
    from csm_tpu_torch import native
    from csm_tpu_torch.ops import _build, bb_kernel, flash_attention, fused_decoder

    _build.build(sorted(f[:-3] for f in os.listdir(_build.CSRC) if f.endswith(".cu")))
    for load in (flash_attention._fwd_lib, flash_attention._bwd_lib, bb_kernel._lib,
                 bb_kernel._lib_q, fused_decoder._lib):
        load()
    if not native.available():
        raise RuntimeError(f"the native audio library did not load: {native.load_error()}")


@torch.no_grad()
def warmup_generation(
    params: dict,
    config: CSMConfig,
    *,
    batch_sizes: Sequence[int] = (1,),
    prompt_buckets: Sequence[int] = (64, 256),
    frame_budgets: Sequence[int] = (64,),
    qdec: Optional[dict] = None,
    qbb: Optional[dict] = None,
    qsb: Optional[dict] = None,
    specdec: bool = False,
    temperature: float = 1.0,
    topk: int = 50,
    greedy: bool = False,
    stop_on_all_zeros: bool = False,
    stop_mode: str = "stream",
    device: DeviceLike = None,
) -> int:
    """Run :func:`~csm_tpu_torch.generation.generate_compiled` once for
    every (batch, prompt bucket, frame budget) combination with the given
    tiers, on ``device`` (CUDA unless ``"cpu"``; the params' device).
    Returns the number of runs.  The draws come from a generator of the
    warm-up's own, so no caller's generator moves."""
    from csm_tpu_torch.generation import generate_compiled

    dev = resolve_device(device)
    if dev.type == "cuda":
        _load_kernels()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n = 0
    for B in batch_sizes:
        for S in prompt_buckets:
            for frames in frame_budgets:
                ids = torch.zeros((B, S, config.frame_width), dtype=torch.long, device=dev)
                mask = torch.zeros((B, S, config.frame_width), dtype=torch.float32, device=dev)
                t0 = time.perf_counter()
                generate_compiled(
                    params, config, ids, mask, S, max_new_frames=frames,
                    temperature=temperature, topk=topk, greedy=greedy,
                    stop_on_all_zeros=stop_on_all_zeros, stop_mode=stop_mode, generator=gen,
                    qdec=qdec, qbb=qbb, qsb=qsb, specdec=specdec,
                )
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                logger.info("warmed generate B=%d S=%d frames=%d in %.1fs",
                            B, S, frames, time.perf_counter() - t0)
                n += 1
    return n
