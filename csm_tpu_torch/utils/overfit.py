"""Deterministic-pattern overfit (counterpart of ``csm_tpu/utils/overfit.py``):
sharpen a random-init model's logits so that greedy-agreement claims can be
tested without published weights.

Random-init logits sit in a tight band (every greedy argmax is a near-tie),
so no agreement number measured on them separates a kernel fault from
last-ulp noise.  Training the model until its logits sharpen, then measuring
teacher-forced greedy agreement on those weights, does:

- :func:`pattern_batch` (own copy, numpy only, byte-equal output): a fully
  deterministic, fully learnable synthetic conversation.  Codebook 0 follows
  a fixed affine chain ``c0[t+1] = (a*c0[t] + b) mod M`` and codebooks 1..31
  are affine in ``(c0, i)``, so a model that learns the transition drives
  both CE losses toward zero and its greedy gaps toward O(1);
- :func:`overfit`: an AdamW overfit loop over that one batch, through the
  port's train step.

The trained weights are a fidelity instrument, not a speech model.
"""

from __future__ import annotations

import sys
import time
from typing import Tuple

import numpy as np
import torch

from csm_tpu_torch.config import CSMConfig


def pattern_batch(
    config: CSMConfig,
    seq_len: int,
    batch: int = 1,
    n_text: int = 8,
    accum: int = 1,
    phase: int = 0,
) -> dict:
    """Deterministic learnable training batch ``[accum, batch, S, 33]``.

    Audio codebook-0 follows ``c0[t+1] = (5*c0[t] + 7) mod (Va-1) + 1``
    (tokens stay in ``1..Va-1`` — 0 is the all-zero stop frame); codebook
    ``i`` is ``(c0[t] + 11*i) mod (Va-1) + 1``.  ``phase`` offsets the
    chain's start so train/eval contexts differ while the transition rule
    (what the model learns) is identical.  Labels cover EVERY audio frame
    (amortization 1 — sharpening all 32 heads is the point).
    """
    S, W = seq_len, config.frame_width
    N = config.audio_num_codebooks
    Va = config.audio_vocab_size
    M = Va - 1
    ids = np.zeros((accum, batch, S, W), np.int32)
    mask = np.zeros((accum, batch, S, W), np.float32)
    labels = np.full((accum, batch, S, W), -100, np.int32)
    # Fixed text prefix (deterministic; batch rows get distinct prefixes so
    # B>1 still contributes independent gradients).
    for b in range(batch):
        ids[:, b, :n_text, W - 1] = (
            7 * np.arange(n_text) + 3 * b + phase
        ) % (config.text_vocab_size - 1) + 1
    mask[..., :n_text, W - 1] = 1.0
    n_audio = S - n_text
    c0 = np.zeros((batch, n_audio), np.int64)
    for b in range(batch):
        c = (1 + 13 * b + phase) % M
        for t in range(n_audio):
            c0[b, t] = c
            c = (5 * c + 7) % M
    i_idx = np.arange(N)[None, None, :]
    frames = (c0[:, :, None] + 11 * i_idx) % M + 1  # [batch, n_audio, N]
    frames[:, :, 0] = c0 + 1
    ids[:, :, n_text:, :N] = frames[None]
    mask[..., n_text:, :N] = 1.0
    labels[:, :, n_text:, :N] = frames[None]
    return {"input_ids": ids, "attention_mask": mask, "labels": labels}


def overfit(
    params: dict,
    config: CSMConfig,
    steps: int = 300,
    lr: float = 3e-4,
    seq_len: int = 64,
    batch: int = 4,
    log_every: int = 50,
    verbose: bool = True,
) -> Tuple[dict, float]:
    """AdamW-overfit ``params`` on one :func:`pattern_batch` for ``steps``
    updates (warmup ``min(20, steps // 5)``, no remat), on the parameters'
    device; returns ``(trained_params, final_loss)``.  The tensors of
    ``params`` are trained in place; the returned ones share their storage,
    detached.  The AdamW moments are dropped before returning."""
    from csm_tpu_torch.train.loop import make_optimizer, make_train_step, map_tree

    steps = max(int(steps), 1)
    device = params["projection"].device
    opt = make_optimizer(lr, total_steps=steps, warmup_steps=min(20, steps // 5))
    step_fn = make_train_step(config, opt, batch * seq_len, remat=False)
    b_np = pattern_batch(config, seq_len, batch=batch)
    batch_t = {k: torch.as_tensor(v, device=device) for k, v in b_np.items()}
    state = opt.init(params)
    t0 = time.time()
    for s in range(steps):
        state, m = step_fn(state, None, batch_t)
        if verbose and (s % log_every == 0 or s == steps - 1):
            print(
                f"  overfit step {s}: loss {float(m['loss']):.4f} "
                f"(bb {float(m['backbone_loss']):.4f} / "
                f"dec {float(m['decoder_loss']):.4f}) "
                f"[{time.time() - t0:.0f}s]",
                file=sys.stderr,
            )
    loss = float(m["loss"])
    trained = map_tree(lambda t: t.detach(), state.params)
    del state
    return trained, loss
