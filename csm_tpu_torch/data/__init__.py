"""Data: the left-padding batch collator (the dataset and the processor
wait for the codec port)."""

from csm_tpu_torch.data.collator import CSMDataCollator  # noqa: F401

__all__ = ["CSMDataCollator"]
