"""Training: the train step (AdamW, linear schedule, clipping, gradient
accumulation, remat), the single-device trainer loop, LoRA adapters and the
CLI argument surface (reference ``train.py``)."""

from csm_tpu_torch.train.args import DataArguments, ModelArguments, TrainingArguments
from csm_tpu_torch.train.loop import CSMTrainer, TrainState, make_optimizer, make_train_step

__all__ = [
    "ModelArguments",
    "DataArguments",
    "TrainingArguments",
    "TrainState",
    "make_optimizer",
    "make_train_step",
    "CSMTrainer",
]
