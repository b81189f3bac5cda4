"""JSONL conversation dataset (own copy of ``csm_tpu/data/dataset.py``;
reference ``CSMAudioTextDataset``, ``train.py:45-146``).

Each line: ``{"messages": [...], "training_mask": [...]}`` where messages
carry text and/or audio-by-url content (``README.md:161-192``).  Keeps the
reference's **epoch-repetition trick**: ``__len__`` is
``len(data) × num_train_epochs`` so decoder amortization resamples a
different frame subset on every pass (``train.py:81-87``), and failed audio
loads degrade to ``None`` with a warning (``train.py:127-129``).

Framework-agnostic: plain ``__getitem__`` protocol returning numpy.  The
processor's audio tokenizer may be the port's ``MimiCodec``, which encodes on
its own device; ``CSMTrainer`` calls ``__getitem__`` from its batch-prefetch
thread, where ``MimiCodec.encode`` sets ``torch.no_grad`` itself.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional

import numpy as np

from csm_tpu_torch.data.audio_io import load_audio_mono

logger = logging.getLogger(__name__)


class CSMAudioTextDataset:
    def __init__(
        self,
        data_path: str,
        audio_cache_dir: Optional[str] = None,
        processor=None,
        num_train_epochs: int = 10,
        seed: int = 0,
    ):
        self.data_path = data_path
        self.audio_cache_dir = audio_cache_dir
        self.processor = processor
        self.num_train_epochs = num_train_epochs
        self.seed = seed

        if audio_cache_dir and not os.path.exists(audio_cache_dir):
            os.makedirs(audio_cache_dir)

        with open(data_path) as f:
            self.data = [json.loads(line) for line in f if line.strip()]
        logger.info("Loaded %d conversations from %s", len(self.data), data_path)

        self.amortization_ratio = getattr(processor, "amortization_ratio", 16)

    def __len__(self) -> int:
        return len(self.data) * self.num_train_epochs

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        # Per-index RNG: amortization draws depend only on (seed, idx) — the
        # epoch-repetition index keeps resampling different frame subsets
        # per pass, while resume-by-index and parallel loading stay
        # bit-reproducible (a shared call-order RNG would not be).
        rng = np.random.default_rng((self.seed, idx))
        idx = idx % len(self.data)
        item = self.data[idx]
        messages = item["messages"]
        training_mask = item.get("training_mask")

        audio_tensors = []
        for message in messages:
            for content in message["content"]:
                if content["type"] == "audio" and "url" in content:
                    path = content["url"]
                    if self.audio_cache_dir:
                        cached = os.path.join(
                            self.audio_cache_dir, os.path.basename(path)
                        )
                        if os.path.exists(cached):
                            path = cached
                    try:
                        audio_tensors.append(
                            load_audio_mono(path, self.processor.sample_rate)
                        )
                    except Exception as e:  # noqa: BLE001 — soft-fail like the reference
                        logger.warning("Error loading audio %s: %s", path, e)
                        audio_tensors.append(None)

        processed = self.processor(
            messages=messages,
            audios=audio_tensors,
            messages_training_mask=training_mask,
            return_tensors="np",
            padding=True,
            truncation=True,
            max_length=2048,
            amortize_decoder_training=True,
            amortization_ratio=self.amortization_ratio,
            rng=rng,
        )
        return {
            "input_ids": processed["input_ids"][0],
            "attention_mask": processed["attention_mask"][0],
            "labels": processed["labels"][0],
        }
