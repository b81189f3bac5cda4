"""The port's example scripts (``python -m csm_tpu_torch.examples.generate``
/ ``.serve``) on the CPU, against the JAX package's ``examples/generate.py``
loaded by path.

Both run from the same reference-layout checkpoint (a tiny config whose
audio vocabulary is the 64 codes of a tiny 32-quantizer Mimi: the JAX
package's Mimi decode makes NaN of a code past the codebook, such as CSM's
three audio tokens above Mimi's codes, where the port's takes the last
centroid, so only in-range codes compare; JAX ``init_params`` written by the
port's ``save_params_to_safetensors``), the stub tokenizer of
tests/test_processor.py and that Mimi carried across by
``mimi_params_from_jax`` in place of the tokenizer and codec loaders (no
download), and the same 24 kHz context WAV, at ``--topk 1 --frames 4``
(one candidate a draw, so the frames do not depend on the generators,
which cannot match across the packages).  Frames exactly equal; the WAVs,
16-bit PCM, within one PCM step plus the Mimi decode tolerance of
tests/test_torch_codec.py (rtol 1e-4, atol 1e-5)."""

import importlib.util
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import csm_tpu.codec
import csm_tpu.data.tokenizer
import csm_tpu.model_api
from csm_tpu.codec import convert as jconv
from csm_tpu.codec import mimi as jmimi
from csm_tpu.config import CSMConfig as JaxCSMConfig
from csm_tpu.models import csm as jcsm
from csm_tpu_torch import CSMConfig, CSMModel
from csm_tpu_torch.checkpoint import params_from_jax, save_params_to_safetensors
from csm_tpu_torch.codec import MimiCodec, MimiCodecConfig, mimi_params_from_jax
from csm_tpu_torch.data import CSMProcessor
from csm_tpu_torch.data.audio_io import load_wav, save_wav
from csm_tpu_torch.examples import generate as gen_example
from csm_tpu_torch.examples import serve as serve_example
from csm_tpu_torch.generation import generate

from tests.test_processor import StubTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PCM_STEP = 1.0 / 32767
DECODE_RTOL, DECODE_ATOL = 1e-4, 1e-5
FRAMES = 4


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("examples")
    jmcfg = jmimi.MimiCodecConfig.tiny(num_quantizers=32)
    jmp = jconv.random_mimi_params(jmcfg, seed=0)
    mcfg = MimiCodecConfig.tiny(num_quantizers=32)
    mp = mimi_params_from_jax(jax.tree.map(np.asarray, jmp))

    ckpt = d / "ckpt"
    ckpt.mkdir()
    cfg = CSMConfig.tiny(audio_vocab_size=mcfg.codebook_size, max_seq_len=256)
    cfg.to_json(str(ckpt / "config.json"))
    jcfg = JaxCSMConfig.from_json(str(ckpt / "config.json"))
    jparams = jax.tree.map(np.asarray, jcsm.init_params(jax.random.key(0), jcfg))
    save_params_to_safetensors(str(ckpt / "model.safetensors"),
                               params_from_jax(jparams, cfg, "cpu"))

    t = np.arange(int(0.4 * 24000)) / 24000
    clip = (0.3 * np.sin(2 * np.pi * 220 * t) * np.exp(-2 * t)).astype(np.float32)
    save_wav(str(d / "context.wav"), clip, 24000)
    return dict(dir=d, ckpt=str(ckpt), cfg=cfg, jmimi=(jmcfg, jmp), mimi=(mcfg, mp),
                context=str(d / "context.wav"))


def _read(path):
    """A mono WAV's samples ``[T]``."""
    wave, rate = load_wav(path)
    assert rate == 24000 and wave.shape[0] == 1
    return wave[0]


def _argv(files, out, *extra):
    return ["--model", files["ckpt"], "--context", files["context"],
            "--context-text", "Hi there.", "--text", "Hello.", "--out", out,
            "--frames", str(FRAMES), "--topk", "1", *extra]


def _patch_port(monkeypatch, files, module):
    mcfg, mp = files["mimi"]
    monkeypatch.setattr(module, "load_llama3_tokenizer", lambda *a, **k: StubTokenizer())
    monkeypatch.setattr(module, "load_mimi", lambda path, num_codebooks, device: MimiCodec(
        mcfg, mp, num_codebooks, device=device))


def _jax_generate_example(files, out, monkeypatch):
    """``examples/generate.py``'s ``main`` on ``_argv``: its frames and the
    WAV it wrote."""
    spec = importlib.util.spec_from_file_location(
        "jax_generate_example", os.path.join(REPO, "examples", "generate.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    jmcfg, jmp = files["jmimi"]
    monkeypatch.setattr(csm_tpu.data.tokenizer, "load_llama3_tokenizer", StubTokenizer)
    monkeypatch.setattr(csm_tpu.codec, "load_mimi",
                        lambda path, num_codebooks: jmimi.MimiCodec(jmcfg, jmp, num_codebooks))
    frames = []
    plain = csm_tpu.model_api.CSMModel.generate

    def recording(self, *args, **kw):
        frames.append(np.asarray(plain(self, *args, **kw)))
        return frames[-1]

    monkeypatch.setattr(csm_tpu.model_api.CSMModel, "generate", recording)
    monkeypatch.setattr(sys, "argv", ["generate.py", *_argv(files, out)])
    module.main()
    return frames[0], _read(out)


def test_generate_matches_the_jax_example(files, tmp_path, monkeypatch):
    jframes, jwave = _jax_generate_example(files, str(tmp_path / "jax.wav"),
                                                    monkeypatch)
    _patch_port(monkeypatch, files, gen_example)
    out = str(tmp_path / "port.wav")
    got = gen_example.main(_argv(files, out), device="cpu")
    assert got["path"] == out and got["frames"].shape == (1, FRAMES, 32)
    np.testing.assert_array_equal(got["frames"], jframes)
    wave = _read(out)
    assert wave.shape == jwave.shape == (FRAMES * 1920,)
    tol = PCM_STEP + DECODE_ATOL + DECODE_RTOL * np.abs(jwave)
    assert np.all(np.abs(wave - jwave) <= tol), np.abs(wave - jwave).max()


def test_streamed_generate_equals_offline(files, tmp_path, monkeypatch):
    _patch_port(monkeypatch, files, gen_example)
    offline = gen_example.main(_argv(files, str(tmp_path / "offline.wav")), device="cpu")
    streamed = gen_example.main(_argv(files, str(tmp_path / "stream.wav"), "--stream"),
                                device="cpu")
    np.testing.assert_array_equal(streamed["frames"], offline["frames"])
    np.testing.assert_allclose(streamed["wave"], offline["wave"], rtol=DECODE_RTOL,
                               atol=DECODE_ATOL)
    a = _read(str(tmp_path / "offline.wav"))
    b = _read(str(tmp_path / "stream.wav"))
    assert np.all(np.abs(a - b) <= PCM_STEP + DECODE_ATOL + DECODE_RTOL * np.abs(a))


def test_generate_quantized_on_the_cpu(files, tmp_path, monkeypatch):
    """``--quantize --bits 4 --head-bits 8`` builds the bundles and runs the
    kernels' plain versions on the CPU: the WAV holds every frame."""
    _patch_port(monkeypatch, files, gen_example)
    out = str(tmp_path / "q.wav")
    got = gen_example.main(_argv(files, out, "--quantize", "--bits", "4", "--head-bits", "8"),
                           device="cpu")
    n = got["frames"].shape[1]
    assert 0 < n <= FRAMES and _read(out).shape == (n * 1920,)


def test_serve_frames_equal_solo_generate(files, tmp_path, monkeypatch):
    """Two slots, three texts (the third waits for a slot): each request's
    frames equal a solo ``generate`` from a generator seeded ``100 + i``,
    and each WAV holds its frames."""
    _patch_port(monkeypatch, files, serve_example)
    texts = ["First request.", "Second one.", "Third."]
    prefix = str(tmp_path / "serve")
    results = serve_example.main(["--model", files["ckpt"], "--slots", "2", "--frames",
                                  str(FRAMES), "--out-prefix", prefix, "--texts", *texts],
                                 device="cpu")
    assert sorted(results) == [0, 1, 2]
    model = CSMModel.from_pretrained(files["ckpt"], dtype=torch.bfloat16, device="cpu")
    mcfg, mp = files["mimi"]
    processor = CSMProcessor(StubTokenizer(), MimiCodec(mcfg, mp, device="cpu"))
    for i, text in enumerate(texts):
        batch = processor(messages=[{"role": "speaker_0",
                                     "content": [{"type": "text", "text": text}]}],
                          audios=None, amortize_decoder_training=False, return_tensors="np")
        g = torch.Generator()
        g.manual_seed(100 + i)
        want = generate(model.params, model.config, batch["input_ids"], batch["attention_mask"],
                        max_new_frames=FRAMES, generator=[g])[0]
        np.testing.assert_array_equal(results[i], want, err_msg=f"request {i}")
        assert _read(f"{prefix}_{i}.wav").shape == (len(want) * 1920,)


def test_serve_builds_no_bundles_off_the_card(files, tmp_path, monkeypatch):
    _patch_port(monkeypatch, files, serve_example)
    monkeypatch.setattr(serve_example, "bundles", lambda *a: pytest.fail("bundles on the CPU"))
    serve_example.main(["--model", files["ckpt"], "--slots", "1", "--frames", "2",
                        "--out-prefix", str(tmp_path / "s"), "--texts", "One."], device="cpu")


@pytest.mark.parametrize("module", ["generate", "serve"])
def test_help_runs_in_a_subprocess(module):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-m", f"csm_tpu_torch.examples.{module}", "--help"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "--model" in res.stdout and "--tokenizer" in res.stdout
    assert ("H100" in res.stdout) == (module == "generate")  # --quantize's help
    assert "v5e" not in res.stdout
