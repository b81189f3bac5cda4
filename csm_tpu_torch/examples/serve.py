"""Continuous-batching serving example (counterpart of the JAX package's
``examples/serve.py``).

Runs a :class:`csm_tpu_torch.serving.CSMServer` on the quantized fast tiers
of the H100 (the fused codebook-loop kernel with its int8 decoder, the int8
backbone-step kernel, W8A16 products for the rest) and feeds it several text
requests that arrive at different times, so later ones join free slots
mid-flight.  Each request draws from its own generator (seeded ``100 + i``),
so its frames equal a solo run's: batching never changes outputs.

Reads local files only (see :mod:`csm_tpu_torch.examples.generate`).

    python -m csm_tpu_torch.examples.serve --model path/to/csm-1b \\
        --mimi path/to/mimi.safetensors --tokenizer path/to/llama-3.2-1b \\
        --slots 4 --texts "First request." "Second request." "Third request."
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from csm_tpu_torch.codec import load_mimi
from csm_tpu_torch.data import CSMProcessor
from csm_tpu_torch.data.audio_io import save_wav
from csm_tpu_torch.data.tokenizer import load_llama3_tokenizer
from csm_tpu_torch.device import DeviceLike, resolve_device
from csm_tpu_torch.examples.generate import TOKENIZER
from csm_tpu_torch.model_api import CSMModel
from csm_tpu_torch.serving import CSMServer

# As the JAX script: past 8 slots the codebook loop takes the int8 head.
INT8_HEAD_PAST = 8


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m csm_tpu_torch.examples.serve",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", required=True, help="local CSM checkpoint directory")
    ap.add_argument("--mimi", default=None,
                    help="Mimi safetensors path (default: $CSM_TPU_MIMI_PATH)")
    ap.add_argument("--tokenizer", default=TOKENIZER,
                    help="local Llama-3.2 tokenizer directory, or a name in the local "
                    "Hugging Face cache")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--window", type=int, default=1024)
    ap.add_argument("--frames", type=int, default=125)
    ap.add_argument("--texts", nargs="+", required=True)
    ap.add_argument("--out-prefix", default="serve_out")
    ap.add_argument("--no-quant", action="store_true",
                    help="the plain bf16 path, without the quantized kernels")
    return ap.parse_args(argv)


def bundles(model: CSMModel, slots: int):
    """``(qdec, qbb, qsb)`` for a server of ``slots`` slots: the fused loop
    up to the batch one kernel call serves, the streamed int8 backbone step
    up to its validated batch (else the W8A16 products alone)."""
    from csm_tpu_torch.ops.bb_kernel import MAX_VALIDATED_B, prepare_streamed_backbone
    from csm_tpu_torch.ops.fused_decoder import MAX_CHUNKED_B, prepare_fused_decoder
    from csm_tpu_torch.ops.quant import prepare_quantized_backbone

    head_bits = 8 if slots > INT8_HEAD_PAST else 16
    qdec = (prepare_fused_decoder(model.params, model.config, head_bits=head_bits)
            if slots <= MAX_CHUNKED_B else None)
    qbb = prepare_quantized_backbone(model.params, model.config)
    qsb = (prepare_streamed_backbone(model.params, model.config, bits=8)
           if slots <= MAX_VALIDATED_B else None)
    return qdec, qbb, qsb


def main(argv=None, device: DeviceLike = None) -> dict:
    """Run the example on ``argv`` (``sys.argv[1:]`` when None) on ``device``
    (CUDA unless ``"cpu"``; the bundles are built on the card only).
    Returns ``{request id: frames [F, 32]}``."""
    args = parse_args(argv)
    device = resolve_device(device)

    print("loading tokenizer / codec / model ...")
    tokenizer = load_llama3_tokenizer(args.tokenizer, local_files_only=True)
    mimi = load_mimi(args.mimi, num_codebooks=32, device=device)
    model = CSMModel.from_pretrained(args.model, dtype=torch.bfloat16, device=device)
    processor = CSMProcessor(tokenizer, mimi)

    qdec = qbb = qsb = None
    if not args.no_quant and device.type == "cuda":
        print("quantizing fast paths (one-time)...")
        qdec, qbb, qsb = bundles(model, args.slots)

    server = CSMServer(
        model.params, model.config, n_slots=args.slots, window=args.window,
        max_new_frames=args.frames, qdec=qdec, qbb=qbb, qsb=qsb,
    )

    t0 = time.time()
    for i, text in enumerate(args.texts):
        batch = processor(
            messages=[{"role": "speaker_0",
                       "content": [{"type": "text", "text": text}]}],
            audios=None, amortize_decoder_training=False, return_tensors="np",
        )
        rid = server.submit(batch["input_ids"], batch["attention_mask"], seed=100 + i)
        # New requests join while earlier ones are mid-stream.
        server.step()
        print(f"t={time.time()-t0:5.1f}s submitted #{rid}: {text!r} "
              f"(active slots: {server.active_slots})")

    results = server.run_until_idle()
    print(f"all requests drained in {time.time()-t0:.1f}s")

    for rid, frames in sorted(results.items()):
        if frames.shape[0] == 0:
            print(f"#{rid}: empty (stopped immediately)")
            continue
        wave = mimi.decode(np.asarray(frames).T)
        path = f"{args.out_prefix}_{rid}.wav"
        save_wav(path, np.asarray(wave), mimi.sample_rate)
        print(f"#{rid}: {frames.shape[0]} frames "
              f"({frames.shape[0]/12.5:.1f} s) -> {path}")
    return results


if __name__ == "__main__":
    main()
