"""Data pipeline (counterpart of ``csm_tpu/data``): conversation
preprocessing into ``[B, S, 33]`` frame tensors, the JSONL dataset with the
epoch-repetition trick, the left-padding collator with static-shape
buckets, host-side audio I/O on the native runtime and the Llama-3
tokenizer loader."""

from csm_tpu_torch.data.collator import CSMDataCollator
from csm_tpu_torch.data.dataset import CSMAudioTextDataset
from csm_tpu_torch.data.processor import CSMProcessor

__all__ = ["CSMProcessor", "CSMAudioTextDataset", "CSMDataCollator"]
