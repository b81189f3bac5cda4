"""End-to-end generation example (counterpart of the JAX package's
``examples/generate.py``, the reference README recipe): voice cloning from a
context clip and its transcript, then new text in that voice.

Reads local files only: CSM weights (a directory with ``config.json`` and
reference-layout safetensors), Mimi weights (safetensors in the HF
``MimiModel`` layout, ``--mimi`` or ``CSM_TPU_MIMI_PATH``) and the
Llama-3.2 tokenizer (``--tokenizer``: a local directory, or a name in the
local Hugging Face cache).  Nothing is downloaded.

    python -m csm_tpu_torch.examples.generate \\
        --model path/to/csm-1b --mimi path/to/mimi.safetensors \\
        --tokenizer path/to/llama-3.2-1b --context context.wav \\
        --context-text "We have a lot to talk about." \\
        --text "This voice is cloned from the context." \\
        --out out.wav --frames 125 --bf16 --quantize
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from csm_tpu_torch.codec import load_mimi
from csm_tpu_torch.data import CSMProcessor
from csm_tpu_torch.data.audio_io import load_audio_mono, save_wav
from csm_tpu_torch.data.tokenizer import load_llama3_tokenizer
from csm_tpu_torch.device import DeviceLike, resolve_device
from csm_tpu_torch.model_api import CSMModel
from csm_tpu_torch.serving import CSMStreamer

TOKENIZER = "meta-llama/Llama-3.2-1B"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m csm_tpu_torch.examples.generate",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", required=True, help="local CSM checkpoint directory")
    ap.add_argument("--mimi", default=None,
                    help="Mimi safetensors path (default: $CSM_TPU_MIMI_PATH)")
    ap.add_argument("--tokenizer", default=TOKENIZER,
                    help="local Llama-3.2 tokenizer directory, or a name in the local "
                    "Hugging Face cache")
    ap.add_argument("--context", default=None, help="context WAV for voice cloning")
    ap.add_argument("--context-text", default="")
    ap.add_argument("--text", required=True)
    ap.add_argument("--speaker", type=int, default=0)
    ap.add_argument("--out", default="out.wav")
    ap.add_argument("--frames", type=int, default=125)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--topk", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stream", action="store_true",
                    help="emit audio frame by frame through the serving streamer")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--quantize", action="store_true",
                    help="the quantized fast tiers on the H100: the fused codebook-loop "
                    "kernel and the streamed backbone-step kernel")
    ap.add_argument("--bits", type=int, default=8, choices=(4, 8),
                    help="backbone-step weight precision (4 = int4; with --quantize)")
    ap.add_argument("--head-bits", type=int, default=16, choices=(8, 16),
                    help="codebook-loop audio_head precision (8 = int8 head; with --quantize)")
    return ap.parse_args(argv)


def main(argv=None, device: DeviceLike = None) -> dict:
    """Run the example on ``argv`` (``sys.argv[1:]`` when None) on ``device``
    (CUDA unless ``"cpu"``).  Returns ``{"frames": [1, F, 32], "wave": [T],
    "path": the WAV written}``."""
    args = parse_args(argv)
    device = resolve_device(device)

    print("loading tokenizer / codec / model ...")
    tokenizer = load_llama3_tokenizer(args.tokenizer, local_files_only=True)
    mimi = load_mimi(args.mimi, num_codebooks=32, device=device)
    model = CSMModel.from_pretrained(
        args.model, dtype=torch.bfloat16 if args.bf16 else torch.float32, device=device)
    if args.quantize:
        print("quantizing fast paths (one-time)...")
        model.quantize(bits=args.bits, head_bits=args.head_bits)
    processor = CSMProcessor(tokenizer, mimi)

    role = f"speaker_{args.speaker}"
    messages, audios = [], []
    if args.context:
        wave = load_audio_mono(args.context, mimi.sample_rate)
        messages.append({
            "role": role,
            "content": [{"type": "text", "text": args.context_text},
                        {"type": "audio", "url": args.context}],
        })
        audios.append(wave)
    messages.append({"role": role, "content": [{"type": "text", "text": args.text}]})

    batch = processor(
        messages=messages, audios=audios or None,
        amortize_decoder_training=False, return_tensors="np",
    )
    generator = torch.Generator(device=device)
    generator.manual_seed(args.seed)

    if args.stream:
        # The model's tiers, so that a streamed run makes the frames of the
        # offline one.
        streamer = CSMStreamer(
            model.params, model.config, codec=mimi,
            temperature=args.temperature, topk=args.topk, qdec=model._qdec,
            qbb=model._qbb, qsb=model._qsb, specdec=model._specdec,
        )
        chunks, frames = [], []
        for i, out in enumerate(streamer.run(
            batch["input_ids"], batch["attention_mask"],
            max_new_frames=args.frames, generator=generator,
        )):
            frames.append(out["frame"][0])
            chunks.append(out["audio"][0])
            print(f"\rframe {i + 1}", end="", flush=True)
        print()
        frames = np.stack(frames)[None] if frames else np.zeros((1, 0, 32), np.int64)
        wave = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    else:
        frames = model.generate(
            batch["input_ids"], batch["attention_mask"],
            max_new_frames=args.frames, temperature=args.temperature,
            topk=args.topk, generator=generator,
        )
        print(f"generated {frames.shape[1]} frames "
              f"({frames.shape[1] / 12.5:.1f} s of audio)")
        wave = mimi.decode(frames[0].T)

    save_wav(args.out, wave, mimi.sample_rate)
    print(f"wrote {args.out} ({len(wave) / mimi.sample_rate:.1f} s @ "
          f"{mimi.sample_rate} Hz)")
    return {"frames": frames, "wave": wave, "path": args.out}


if __name__ == "__main__":
    main()
