"""Batch collation (own copy of ``csm_tpu/data/collator.py``, numpy only):
left-padding to a shared length (reference ``CSMDataCollator``,
``train.py:149-209``), optionally to a multiple or a **fixed bucket length**
so training batches come in few shapes.

Pad values (``train.py:185-200``): labels −100; mask 0; inputs 0 except the
text column which gets ``text_pad_token_id`` (the reference instantiates it
with the EOS id, ``train.py:411``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

IGNORE_INDEX = -100


@dataclasses.dataclass
class CSMDataCollator:
    """Left-pads features to the batch max (or a fixed bucket).

    Args:
        text_pad_token_id: id written into the text column of padding rows.
        pad_to_multiple: round the padded length up to a multiple (shape
            buckets; 0 disables).
        pad_to_length: pad every batch to exactly this length (strongest
            static-shape guarantee; overrides ``pad_to_multiple``).
    """

    text_pad_token_id: int
    pad_to_multiple: int = 0
    pad_to_length: Optional[int] = None

    def __call__(self, features: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        if not features:
            return {}
        max_len = max(int(f["input_ids"].shape[0]) for f in features)
        if self.pad_to_length is not None:
            if max_len > self.pad_to_length:
                raise ValueError(
                    f"sequence length {max_len} exceeds pad_to_length={self.pad_to_length}"
                )
            max_len = self.pad_to_length
        elif self.pad_to_multiple:
            m = self.pad_to_multiple
            max_len = ((max_len + m - 1) // m) * m

        out: Dict[str, np.ndarray] = {}
        for key in features[0].keys():
            rows = []
            for f in features:
                x = np.asarray(f[key])
                pad = max_len - x.shape[0]
                if pad > 0:
                    if key == "labels":
                        p = np.full((pad, x.shape[1]), IGNORE_INDEX, x.dtype)
                    elif key == "attention_mask":
                        p = np.zeros((pad, x.shape[1]), x.dtype)
                    else:
                        p = np.zeros((pad, x.shape[1]), x.dtype)
                        p[:, -1] = self.text_pad_token_id
                    x = np.concatenate([p, x], axis=0)
                rows.append(x)
            out[key] = np.stack(rows)
        return out
