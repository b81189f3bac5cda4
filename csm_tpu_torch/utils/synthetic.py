"""Synthetic full-context conversation batches (own copy of
``csm_tpu/utils/synthetic.py``, numpy only, byte-equal output).

One recipe: text frames, then audio frames with codebook-0 labels on every
frame and full 32-codebook labels on an amortized 1/ratio subset, the
processor's output shape (reference ``processor.py:339-369``).
``chip_smoke.py`` trains on it at full width, as the JAX package's
``scripts/train_2048_hw.py`` does.
"""

from __future__ import annotations

import numpy as np

from csm_tpu_torch.config import CSMConfig


def synthetic_conversation_batch(
    config: CSMConfig,
    seq_len: int,
    accum: int = 1,
    batch: int = 1,
    n_text: int = 64,
    amortization_ratio: int = 16,
    seed: int = 1,
) -> dict:
    """``[accum, batch, seq_len, 33]`` numpy training batch: ``n_text``
    leading text frames, audio frames after, labels amortized 1/ratio."""
    rng = np.random.default_rng(seed)
    S, W = seq_len, config.frame_width
    N = config.audio_num_codebooks
    ids = np.zeros((accum, batch, S, W), np.int32)
    mask = np.zeros((accum, batch, S, W), np.float32)
    labels = np.full((accum, batch, S, W), -100, np.int32)
    ids[..., :n_text, W - 1] = rng.integers(
        1, config.text_vocab_size, (accum, batch, n_text)
    )
    mask[..., :n_text, W - 1] = 1
    ids[..., n_text:, :N] = rng.integers(
        1, config.audio_vocab_size, (accum, batch, S - n_text, N)
    )
    mask[..., n_text:, :N] = 1
    labels[..., n_text:, 0] = ids[..., n_text:, 0]
    n_audio = S - n_text
    for a in rng.choice(n_audio, size=n_audio // amortization_ratio,
                        replace=False):
        labels[..., n_text + a, :N] = ids[..., n_text + a, :N]
    return {"input_ids": ids, "attention_mask": mask, "labels": labels}
