"""CLI argument dataclasses (own copy of ``csm_tpu/train/args.py``),
mirroring the reference's three-dataclass surface (``train.py:212-280``)
with the same defaults: lr 5e-6, 3 epochs, per-device batch 1, grad-accum 8,
logging every step, epoch-based saves rotated to 3 checkpoints, optional
bf16.

``mesh_data`` / ``mesh_seq`` / ``mesh_model`` lay the ranks of a
``torch.distributed`` job on a data x sequence x model mesh
(:func:`csm_tpu_torch.parallel.make_mesh`)."""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class ModelArguments:
    """Reference ``ModelArguments`` (``train.py:235-244``)."""

    model_name_or_path: Optional[str] = None  # path to converted weights / checkpoint
    config_path: Optional[str] = None  # JSON CSMConfig (defaults to CSM-1B shape)


@dataclasses.dataclass
class DataArguments:
    """Reference ``DataTrainingArguments`` (``train.py:212-232``)."""

    train_file: str = ""
    eval_file: Optional[str] = None
    audio_cache_dir: Optional[str] = None
    amortization_ratio: int = 16


@dataclasses.dataclass
class TrainingArguments:
    """Reference ``CustomTrainingArguments`` defaults (``train.py:247-280``)
    plus the JAX package's knobs (remat, prefetch, shape buckets, mesh)."""

    output_dir: str = "out"
    learning_rate: float = 5e-6
    num_train_epochs: float = 3
    per_device_train_batch_size: int = 1
    gradient_accumulation_steps: int = 8
    logging_steps: int = 1
    save_strategy: str = "epoch"  # "epoch" | "steps" | "no"
    save_steps: int = 500
    save_total_limit: int = 3
    eval_strategy: str = "no"  # "no" | "epoch" | "steps"
    eval_steps: int = 500
    warmup_steps: int = 0
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    bf16: bool = False
    fp16: bool = False  # reference exposes fp32/fp16/bf16 (train.py:374-383)
    seed: int = 42
    resume_from_checkpoint: bool = False
    # LoRA (beyond the reference: parameter-efficient fine-tuning; 0 = full
    # fine-tune like the reference)
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: str = "wq,wv"  # comma-separated stacked-matrix names
    gradient_checkpointing: bool = True  # checkpoint each backbone layer:
    # its activations are recomputed in the backward instead of stored;
    # with the flash backward kernels this fits full-context (2048-frame)
    # CSM-1B training; costs up to one extra forward per step.
    gradient_checkpointing_policy: str = "auto"  # "auto" = "dots" when the
    # microbatch is 1, else "nothing"; "nothing" = minimum memory (full
    # per-layer recompute); "dots" keeps the matmul and flash outputs.
    report_to: str = "none"  # metrics reporting: "none" or "tensorboard"
    # (event files under <output_dir>/runs with the reference's tag scheme:
    # train/loss, train/backbone_loss, train/decoder_loss, eval/loss)
    dataloader_prefetch: int = 2  # background-prefetched global batches: a
    # daemon thread collates batch i+k and copies it to the device while the
    # device runs step i.  0 = fully synchronous.
    max_seq_length: int = 2048  # hard cap / fallback frame bucket
    pad_to_multiple: int = 64  # length-bucket granularity (0 = always pad
    # to max_seq_length)
    mesh_data: Optional[int] = None  # data-parallel axis size (None: the
    # ranks left over by seq x model)
    mesh_model: int = 1  # tensor-parallel axis size
    mesh_seq: int = 1  # sequence-parallel axis size

    def __post_init__(self):
        for name in ("mesh_data", "mesh_seq", "mesh_model"):
            if getattr(self, name) is not None and getattr(self, name) < 1:
                raise ValueError(f"{name} must be at least 1; got {getattr(self, name)}")


def parse_args(argv=None) -> Tuple[ModelArguments, DataArguments, TrainingArguments]:
    """argparse-based equivalent of ``HfArgumentParser`` over the three
    dataclasses (``train.py:340-343``)."""
    parser = argparse.ArgumentParser(description="CSM training (PyTorch / CUDA)")
    for cls in (ModelArguments, DataArguments, TrainingArguments):
        for f in dataclasses.fields(cls):
            name = "--" + f.name
            if f.type in ("bool", bool):
                # BooleanOptionalAction: default-True flags (e.g.
                # gradient_checkpointing) stay disable-able via --no-<name>.
                parser.add_argument(
                    name, action=argparse.BooleanOptionalAction,
                    default=f.default,
                )
            else:
                typ = {"int": int, "float": float}.get(str(f.type), str)
                if f.type in (int, float, str):
                    typ = f.type
                elif "int" in str(f.type):
                    typ = int
                elif "float" in str(f.type):
                    typ = float
                default = None if f.default is dataclasses.MISSING else f.default
                parser.add_argument(name, type=typ, default=default)
    ns = parser.parse_args(argv)

    def build(cls):
        return cls(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(cls)})

    return build(ModelArguments), build(DataArguments), build(TrainingArguments)
