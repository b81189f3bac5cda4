"""The training CLI (counterpart of the JAX package's ``train.py``, reference
``train.py:329-512``):

    python -m csm_tpu_torch.train --train_file data.jsonl --output_dir out \\
        --learning_rate 5e-6 --num_train_epochs 3 --gradient_accumulation_steps 8

Pipeline: JSONL -> CSMAudioTextDataset (audio I/O on the native runtime,
Mimi encode on the card) -> CSMProcessor (framing, labels, amortization) ->
CSMDataCollator (left padding to a length bucket) -> CSMTrainer (AdamW,
gradient accumulation, the flash kernels forward and backward on CUDA) ->
``save_model(output_dir)``.

The Mimi weights are read from a local safetensors file named by
``CSM_TPU_MIMI_PATH`` (nothing is downloaded); the text tokenizer is the
Llama-3.2-1B one, from the Hugging Face cache or a local directory.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from csm_tpu_torch.codec import load_mimi
from csm_tpu_torch.config import CSMConfig
from csm_tpu_torch.data import CSMAudioTextDataset, CSMDataCollator, CSMProcessor
from csm_tpu_torch.data.tokenizer import load_llama3_tokenizer
from csm_tpu_torch.device import DeviceLike, resolve_device
from csm_tpu_torch.parallel import maybe_init_distributed
from csm_tpu_torch.train.args import parse_args
from csm_tpu_torch.train.loop import CSMTrainer

logger = logging.getLogger(__name__)


def main(argv=None, device: DeviceLike = None) -> CSMTrainer:
    """Parse ``argv`` (``sys.argv[1:]`` when None), train, and save the model
    to ``--output_dir``; returns the trainer.  ``device``: CUDA unless
    ``"cpu"`` is given (it raises without a card otherwise)."""
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S",
        level=logging.INFO,
    )
    model_args, data_args, training_args = parse_args(argv)
    device = resolve_device(device)

    # Multi-process data / sequence / tensor parallelism, the torchrun-DDP
    # counterpart (reference ``train.py:414-425``): environment-guarded, a
    # plain single-process run is untouched.  The trainer lays the mesh from
    # --mesh_data / --mesh_seq / --mesh_model.
    if maybe_init_distributed():
        import torch.distributed as dist

        logger.info("distributed: rank %d/%d", dist.get_rank(), dist.get_world_size())
    # Name the card by its index: the trainer's batch-prefetch thread, where
    # the dataset encodes audio and copies batches to the device, has its own
    # current device.
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    np.random.seed(training_args.seed)
    logger.info("device: %s", device)

    if model_args.config_path:
        config = CSMConfig.from_json(model_args.config_path)
    else:
        config = CSMConfig()  # CSM-1B shape

    logger.info("Loading text tokenizer...")
    text_tokenizer = load_llama3_tokenizer()

    logger.info("Loading multi-codebook audio tokenizer (Mimi)...")
    audio_tokenizer = load_mimi(num_codebooks=config.audio_num_codebooks, device=device)

    processor = CSMProcessor(text_tokenizer, audio_tokenizer,
                             amortization_ratio=data_args.amortization_ratio)

    if training_args.bf16:
        dtype = torch.bfloat16
    elif training_args.fp16:
        dtype = torch.float16
    else:
        dtype = torch.float32
    if model_args.model_name_or_path:
        logger.info("Loading model from %s", model_args.model_name_or_path)
        from csm_tpu_torch.checkpoint import load_params_from_safetensors

        params = load_params_from_safetensors(model_args.model_name_or_path, config, device,
                                              dtype)
    else:
        logger.info("Creating a new model from default CSMConfig")
        from csm_tpu_torch.models import csm

        params = csm.init_params(config, training_args.seed, dtype, device)

    train_dataset = CSMAudioTextDataset(
        data_args.train_file,
        audio_cache_dir=data_args.audio_cache_dir,
        processor=processor,
        num_train_epochs=int(training_args.num_train_epochs),
        seed=training_args.seed,
    )
    eval_dataset = (
        CSMAudioTextDataset(
            data_args.eval_file,
            audio_cache_dir=data_args.audio_cache_dir,
            processor=processor,
            num_train_epochs=1,
            seed=training_args.seed,
        )
        if data_args.eval_file
        else None
    )

    # Length bucketing: pad to the next multiple of ``pad_to_multiple`` so a
    # short-utterance dataset doesn't pay the full 2048-frame attention
    # square every step; 0 falls back to a single max_seq_length bucket.
    collator = CSMDataCollator(
        text_pad_token_id=text_tokenizer.eos_token_id,
        pad_to_multiple=training_args.pad_to_multiple or 0,
        pad_to_length=(
            None if training_args.pad_to_multiple else training_args.max_seq_length
        ),
    )

    trainer = CSMTrainer(config, params, training_args, train_dataset,
                         eval_dataset=eval_dataset, data_collator=collator, device=device)
    logger.info(
        "Effective batch size: %d (per_device=%d × accum=%d × data_parallel=%d), "
        "model_parallel=%d",
        trainer.global_batch * training_args.gradient_accumulation_steps,
        training_args.per_device_train_batch_size,
        training_args.gradient_accumulation_steps,
        trainer.mesh.size("data") if trainer.mesh is not None else 1,
        trainer.mesh.size("model") if trainer.mesh is not None else 1,
    )
    trainer.train()
    logger.info("Saving final model to %s", training_args.output_dir)
    trainer.save_model(training_args.output_dir)
    return trainer
