"""The README recipe at tiny size, on the CPU, through the port alone
(counterpart of tests/test_end_to_end.py, which is ``slow``): the port's
processor with the port's tiny 32-quantizer ``MimiCodec`` encoding real
(random) audio -> ``CSMTrainer`` fine-tuning -> greedy ``generate`` with the
trained weights -> Mimi decode -> ``save_wav`` -> ``load_audio``.  The
conversations are held exactly equal to the JAX processor's on the JAX
Mimi with the same weights (carried across by ``mimi_params_from_jax``);
the loss ceiling and the shapes are the JAX test's."""

import jax
import numpy as np
import pytest
import torch

from csm_tpu.codec import convert as jconv
from csm_tpu.codec import mimi as jmimi
from csm_tpu.data.processor import CSMProcessor as JaxProcessor
from csm_tpu_torch import CSMConfig, CSMModel
from csm_tpu_torch.codec import MimiCodec, MimiCodecConfig, mimi_params_from_jax
from csm_tpu_torch.data import CSMDataCollator, CSMProcessor
from csm_tpu_torch.data.audio_io import load_audio, save_wav
from csm_tpu_torch.models import csm
from csm_tpu_torch.train import CSMTrainer, TrainingArguments

from tests.test_processor import StubTokenizer

KEYS = ("input_ids", "attention_mask", "labels")


@pytest.fixture(scope="module")
def recipe():
    jmcfg = jmimi.MimiCodecConfig.tiny(num_quantizers=32)
    jmp = jconv.random_mimi_params(jmcfg, seed=0)
    mcfg = MimiCodecConfig.tiny(num_quantizers=32)
    codec = MimiCodec(mcfg, mimi_params_from_jax(jax.tree.map(np.asarray, jmp)), device="cpu")
    # the audio vocab covers the codec's code range 0..codebook_size-1
    cfg = CSMConfig.tiny(audio_vocab_size=mcfg.codebook_size + 1)
    return cfg, codec, jmimi.MimiCodec(jmcfg, jmp)


def _conversations(codec, jcodec, n=3):
    """Short two-message conversations with real (random) audio, each equal
    to the JAX processor's on the JAX codec."""
    proc = CSMProcessor(StubTokenizer(), codec, amortization_ratio=4)
    jproc = JaxProcessor(StubTokenizer(), jcodec, amortization_ratio=4)
    frame = int(codec.sample_rate / codec.frame_rate)
    items = []
    for i in range(n):
        wave = (0.3 * np.random.default_rng(10 + i).standard_normal(3 * frame)).astype(np.float32)
        messages = [
            {"role": "speaker_0", "content": [{"type": "text", "text": "hi"}]},
            {"role": "speaker_1", "content": [{"type": "text", "text": "ok"},
                                              {"type": "audio", "url": f"clip{i}.wav"}]},
        ]
        kw = dict(messages=messages, audios=[wave], max_length=24, return_tensors="np")
        out = proc(rng=np.random.default_rng(i), **kw)
        want = jproc(rng=np.random.default_rng(i), **kw)
        for k in KEYS:
            np.testing.assert_array_equal(out[k], want[k], k)
        # the conversation holds audio frames: no silent text-only training
        assert (out["attention_mask"][0][:, :-1] == 1).any()
        items.append({k: out[k][0] for k in KEYS})
    return items


class _ListDataset:
    amortization_ratio = 4

    def __init__(self, items, epochs):
        self.items, self.epochs = items, epochs

    def __len__(self):
        return len(self.items) * self.epochs

    def __getitem__(self, i):
        return self.items[i % len(self.items)]


def test_readme_recipe_end_to_end(recipe, tmp_path):
    cfg, codec, jcodec = recipe
    items = _conversations(codec, jcodec)
    S = max(it["input_ids"].shape[0] for it in items)
    pad = ((S + 7) // 8) * 8

    args = TrainingArguments(
        output_dir=str(tmp_path), learning_rate=5e-3, per_device_train_batch_size=1,
        gradient_accumulation_steps=3, max_seq_length=pad, save_strategy="no", seed=42)
    params = csm.init_params(cfg, 0, torch.float32, "cpu")
    trainer = CSMTrainer(cfg, params, args, _ListDataset(items, epochs=6),
                         data_collator=CSMDataCollator(text_pad_token_id=0, pad_to_length=pad),
                         device="cpu")
    metrics = trainer.train()
    assert trainer.state.step == 6
    # random-init CE ≈ ln(text_vocab) + 2·ln(audio_vocab); training on 3
    # repeated conversations must overfit well below that.
    init_ceiling = np.log(cfg.text_vocab_size) + 2 * np.log(cfg.audio_vocab_size)
    assert metrics["loss"] < init_ceiling * 0.8, (metrics, init_ceiling)

    # Generate continuation audio for a prompt with the trained weights.
    model = CSMModel(cfg, params=trainer.model_params(), device="cpu")
    prompt = items[0]
    frames = model.generate(prompt["input_ids"][None],
                            prompt["attention_mask"][None].astype(np.float32),
                            max_new_frames=4, greedy=True, stop_on_all_zeros=False)
    assert frames.shape == (1, 4, cfg.audio_num_codebooks)
    assert frames.min() >= 0 and frames.max() < cfg.audio_vocab_size

    # Decode back to audio, write it, read it (README.md:114-118).  Clip to
    # the codec's code range: CSM's audio vocab has one extra id.
    codes = np.minimum(frames[0].T, codec.config.codebook_size - 1)
    wave = codec.decode(codes)
    frame_size = int(codec.sample_rate / codec.frame_rate)
    assert wave.shape == (4 * frame_size,) and np.isfinite(wave).all()
    path = str(tmp_path / "out.wav")
    save_wav(path, np.clip(wave / max(1e-6, np.abs(wave).max()), -1, 1), codec.sample_rate)
    back, rate = load_audio(path)
    assert rate == codec.sample_rate and back.shape == (1, 4 * frame_size)
    assert np.isfinite(back).all()
