"""CSMProcessor (own copy of ``csm_tpu/data/processor.py``): conversations
(text + audio) → ``[B, S, 33]`` frame tensors.

Behavioral contract (reference ``processor.py:1-378``):

- A conversation is a causal sequence of 33-wide frames: columns 0–31 audio
  codebooks, column 32 text.  Each frame is single-modality.
- Text: ``"[{speaker_id}]{text}"`` encoded **with BOS/EOS** (the tokenizer
  is expected to wrap, cf. ``train.py:283-300``); tokens go to column 32,
  mask set only there (``processor.py:255-267``).
- Audio: ``audio_tokenizer.encode(wave)`` → ``[32, T]`` codes, plus one
  appended **all-zero EOS frame**; codes go to columns 0–31, column 32 zero,
  mask on columns 0–31 (``processor.py:284-298``).
- Truncation keeps the **last** ``max_length`` frames (``processor.py:318-320``).
- Labels: copy of tokens with −100 where mask==0 and always −100 in the text
  column; message-level masking via ``messages_training_mask``
  (``processor.py:326-337``).
- Decoder amortization: among frames with any live label, a random
  ``max(1, n // ratio)`` subset keeps labels for codebooks 1–31; codebook 0
  and the text column keep labels on all valid frames
  (``processor.py:339-369``).
- Batch: left (front) padding to the batch max — inputs/mask 0, labels −100
  (``processor.py:137-169``).

Host-side by design: tokenization and framing are numpy; the audio
tokenizer may be the port's Mimi codec (which encodes on its device) or any
object with ``encode``/``sample_rate``.

Deliberate fixes over the reference (SURVEY §7 step 6):
- the single-``text`` entry point is implemented as intended (the reference
  version passes ``audios`` positionally into ``text`` and crashes,
  ``processor.py:185-194``);
- amortization uses an explicit seedable ``numpy`` RNG instead of the
  global ``random`` module.

One difference from the JAX package: ``return_tensors`` takes ``"np"`` or
``"pt"``; ``"jax"`` raises, as the port imports no JAX.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

FRAME_WIDTH = 33
NUM_CODEBOOKS = 32
IGNORE_INDEX = -100


class CSMProcessor:
    def __init__(self, tokenizer, audio_tokenizer, amortization_ratio: int = 16):
        """
        Args:
            tokenizer: text tokenizer with ``encode(text, add_special_tokens=True)
                -> list[int]`` (BOS/EOS wrapping expected, cf.
                ``load_llama3_tokenizer``).
            audio_tokenizer: audio codec with ``encode(wave: np.ndarray [T])
                -> np.ndarray [32, frames]`` and a ``sample_rate`` attribute.
        """
        self.tokenizer = tokenizer
        self.audio_tokenizer = audio_tokenizer
        self.sample_rate = getattr(audio_tokenizer, "sample_rate", 16000)
        self.amortization_ratio = amortization_ratio

    # ------------------------------------------------------------------

    def __call__(
        self,
        messages: Optional[Union[List[Dict], List[List[Dict]]]] = None,
        text: Optional[str] = None,
        audios: Optional[Sequence] = None,
        speaker_id: Optional[int] = None,
        return_tensors: str = "np",
        padding: bool = True,
        truncation: bool = True,
        max_length: int = 2048,
        amortize_decoder_training: bool = True,
        amortization_ratio: Optional[int] = None,
        messages_training_mask: Optional[Sequence] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> Dict[str, Any]:
        """Convert conversation messages (and optional audio) into
        ``{"input_ids", "attention_mask", "labels"}`` each ``[B, S, 33]``.

        ``return_tensors``: ``"np"`` (default) or ``"pt"`` (int64 tensors).
        ``rng``: seedable generator for amortization frame selection.
        """
        if amortization_ratio is None:
            amortization_ratio = self.amortization_ratio
        if rng is None:
            rng = np.random.default_rng()

        if messages is None:
            if text is None or speaker_id is None:
                raise ValueError(
                    "Must provide either 'messages' or both 'text' and 'speaker_id'."
                )
            # Single-text mode, implemented as intended (the reference's
            # recursive call is broken — ``processor.py:185-194``).
            messages = [
                {
                    "role": f"speaker_{speaker_id}",
                    "content": [{"type": "text", "text": text}],
                }
            ]

        is_batched = bool(messages) and isinstance(messages[0], list)
        if not is_batched:
            messages = [messages]
            audios = [audios] if audios is not None else [None]
        elif audios is not None and audios and not isinstance(audios[0], (list, tuple)):
            audios = [audios]
        if audios is None:
            audios = [None] * len(messages)

        if messages_training_mask is not None:
            if not is_batched:
                if messages_training_mask and isinstance(messages_training_mask[0], (list, tuple)):
                    raise ValueError(
                        "`messages_training_mask` is nested but expected flat for a single conversation."
                    )
                messages_training_mask = [messages_training_mask]
            if len(messages_training_mask) < len(messages):
                raise ValueError(
                    f"messages_training_mask has {len(messages_training_mask)} entries "
                    f"but {len(messages)} conversations were provided."
                )

        outputs = []
        for i, convo in enumerate(messages):
            convo_audios = audios[i] if i < len(audios) else None
            convo_mask = (
                messages_training_mask[i] if messages_training_mask is not None else None
            )
            outputs.append(
                self._process_messages(
                    convo, convo_audios, truncation, max_length,
                    amortize_decoder_training, amortization_ratio, convo_mask, rng,
                )
            )

        # Left-pad conversations to the batch max (``processor.py:137-169``).
        if outputs:
            max_s = max(o["input_ids"].shape[0] for o in outputs) if padding else None
            ids, masks, labels = [], [], []
            for o in outputs:
                s = o["input_ids"].shape[0]
                if padding and s < max_s:
                    pad = max_s - s
                    ids.append(np.pad(o["input_ids"], ((pad, 0), (0, 0))))
                    masks.append(np.pad(o["attention_mask"], ((pad, 0), (0, 0))))
                    labels.append(
                        np.pad(o["labels"], ((pad, 0), (0, 0)), constant_values=IGNORE_INDEX)
                    )
                else:
                    ids.append(o["input_ids"])
                    masks.append(o["attention_mask"])
                    labels.append(o["labels"])
            batch = {
                "input_ids": np.stack(ids),
                "attention_mask": np.stack(masks),
                "labels": np.stack(labels),
            }
        else:
            batch = {
                "input_ids": np.zeros((0, 0, FRAME_WIDTH), np.int64),
                "attention_mask": np.zeros((0, 0, FRAME_WIDTH), np.int64),
                "labels": np.zeros((0, 0, FRAME_WIDTH), np.int64),
            }
        return _convert(batch, return_tensors)

    # ------------------------------------------------------------------

    def _process_messages(
        self,
        messages: List[Dict],
        audios: Optional[Sequence],
        truncation: bool,
        max_length: int,
        amortize_decoder_training: bool,
        amortization_ratio: int,
        messages_training_mask: Optional[Sequence],
        rng: np.random.Generator,
    ) -> Dict[str, np.ndarray]:
        """One conversation → ``[S, 33]`` tokens/mask/labels
        (``processor.py:200-378``)."""
        all_tokens: List[np.ndarray] = []
        all_masks: List[np.ndarray] = []
        audio_index = 0
        boundaries = []

        for msg_idx, message in enumerate(messages):
            speaker_id = int(message["role"].split("_")[-1])
            keep = (
                True
                if messages_training_mask is None
                else bool(messages_training_mask[msg_idx])
            )
            text_parts = [
                item["text"]
                for item in message["content"]
                if item["type"] == "text" and item.get("text", "")
            ]
            has_audio = any(item["type"] == "audio" for item in message["content"])
            text = " ".join(text_parts)
            start = sum(c.shape[0] for c in all_tokens)

            if text:
                toks = self.tokenizer.encode(
                    f"[{speaker_id}]{text}", add_special_tokens=True
                )
                frame = np.zeros((len(toks), FRAME_WIDTH), np.int64)
                fmask = np.zeros((len(toks), FRAME_WIDTH), np.int64)
                frame[:, -1] = np.asarray(toks, np.int64)
                fmask[:, -1] = 1
                all_tokens.append(frame)
                all_masks.append(fmask)

            if has_audio and audios is not None and audio_index < len(audios) and audios[audio_index] is not None:
                wave = np.asarray(audios[audio_index], np.float32)
                audio_index += 1
                codes = np.asarray(self.audio_tokenizer.encode(wave))  # [32, T]
                if codes.ndim != 2 or codes.shape[0] != NUM_CODEBOOKS:
                    raise ValueError(
                        f"audio_tokenizer.encode must return [32, T], got {codes.shape}"
                    )
                # Append the all-zero EOS frame (``processor.py:290-291``).
                codes = np.concatenate(
                    [codes, np.zeros((NUM_CODEBOOKS, 1), codes.dtype)], axis=1
                )
                t = codes.shape[1]
                frame = np.zeros((t, FRAME_WIDTH), np.int64)
                fmask = np.zeros((t, FRAME_WIDTH), np.int64)
                frame[:, :-1] = codes.T
                fmask[:, :-1] = 1
                all_tokens.append(frame)
                all_masks.append(fmask)
            elif has_audio:
                warnings.warn(
                    f"Audio content declared but no audio tensor provided for "
                    f"message with {message.get('role', 'unknown')}"
                )

            end = sum(c.shape[0] for c in all_tokens)
            boundaries.append((start, end, keep))

        if audios is not None and audio_index < len(audios):
            warnings.warn(f"{len(audios) - audio_index} audio tensors were not used")

        if all_tokens:
            tokens = np.concatenate(all_tokens, axis=0)
            mask = np.concatenate(all_masks, axis=0)
            if truncation and tokens.shape[0] > max_length:
                tokens = tokens[-max_length:]
                mask = mask[-max_length:]
        else:
            tokens = np.zeros((0, FRAME_WIDTH), np.int64)
            mask = np.zeros((0, FRAME_WIDTH), np.int64)

        # Labels: −100 where masked and always in the text column
        # (``processor.py:326-328``).
        labels = tokens.copy()
        labels[mask == 0] = IGNORE_INDEX
        labels[:, -1] = IGNORE_INDEX

        # Message-level masking (``processor.py:331-337``).  Deliberate fix:
        # the reference applies pre-truncation boundary indices to the
        # truncated array (masking the wrong frames after tail truncation);
        # here boundaries are shifted by the dropped prefix.
        dropped = max(0, sum(c.shape[0] for c in all_tokens) - labels.shape[0])
        for start, end, keep in boundaries:
            s, e = start - dropped, end - dropped
            if e <= 0 or s >= labels.shape[0]:
                continue
            if not keep:
                labels[max(s, 0) : min(e, labels.shape[0]), :] = IGNORE_INDEX

        if amortize_decoder_training:
            labels = self._amortize(labels, amortization_ratio, rng)

        return {"input_ids": tokens, "attention_mask": mask, "labels": labels}

    @staticmethod
    def _amortize(
        labels: np.ndarray, ratio: int, rng: np.random.Generator
    ) -> np.ndarray:
        """Keep codebook-1..31 labels on a random ``max(1, n//ratio)`` subset
        of frames; c0 + text labels stay on all valid frames
        (``processor.py:339-369``)."""
        seq_len = labels.shape[0]
        valid = np.any(labels[:, :-1] != IGNORE_INDEX, axis=-1)
        valid_idx = np.where(valid)[0]

        frame_mask = np.zeros(seq_len, bool)
        if len(valid_idx) > 0:
            n_sel = max(1, len(valid_idx) // ratio)
            frame_mask[rng.choice(valid_idx, size=n_sel, replace=False)] = True

        keep = np.zeros_like(labels, dtype=bool)
        keep[:, -1] = True
        keep[:, 0] = np.any(labels != IGNORE_INDEX, axis=-1)
        keep[frame_mask, 1:-1] = True

        out = labels.copy()
        out[(labels != IGNORE_INDEX) & ~keep] = IGNORE_INDEX
        return out


def _convert(batch: Dict[str, np.ndarray], return_tensors: str) -> Dict[str, Any]:
    if return_tensors in ("np", None):
        return batch
    if return_tensors == "pt":
        import torch

        return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    raise ValueError(
        f"Unsupported return format: {return_tensors!r}; csm_tpu_torch returns \"np\" "
        "(numpy) or \"pt\" (torch) tensors")
