"""The port's training CLI (``python -m csm_tpu_torch.train``,
csm_tpu_torch.train.cli.main) against the JAX package's ``train.py`` on the
CPU: the same JSONL and audio files, a tiny ``--config_path``, fp32, the same
weights through ``--model_name_or_path`` (JAX ``init_params`` written by the
port's ``save_params_to_safetensors`` after ``params_from_jax``), the stub
tokenizer of tests/test_processor.py and a tiny 32-quantizer Mimi carried
across by ``mimi_params_from_jax`` in place of the tokenizer and codec
loaders (no download).  Both CLIs run one step at ``--mesh_data 1`` (the JAX
one on one device of the virtual mesh): the collated batches are exactly
equal and the first step's losses agree within the fixture tolerances
(rtol 2e-4, atol 2e-5)."""

import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

import csm_tpu.codec
import csm_tpu.data.tokenizer
import csm_tpu.train
from csm_tpu.codec import convert as jconv
from csm_tpu.codec import mimi as jmimi
from csm_tpu.config import CSMConfig as JaxCSMConfig
from csm_tpu.models import csm as jcsm
from csm_tpu_torch import CSMConfig, CSMModel
from csm_tpu_torch.checkpoint import params_from_jax, save_params_to_safetensors
from csm_tpu_torch.codec import MimiCodec, MimiCodecConfig, mimi, mimi_params_from_jax
from csm_tpu_torch.data import audio_io
from csm_tpu_torch.train import cli
from csm_tpu_torch.train.loop import CSMTrainer, flatten

from tests.test_processor import StubTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, LOSS_ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A tiny config, its weights, a tiny 32-quantizer Mimi in both packages,
    and a JSONL of two conversations whose clips are a 24 kHz mono and a
    48 kHz stereo WAV."""
    d = tmp_path_factory.mktemp("cli")
    jmcfg = jmimi.MimiCodecConfig.tiny(num_quantizers=32)
    jmp = jconv.random_mimi_params(jmcfg, seed=0)
    mcfg = MimiCodecConfig.tiny(num_quantizers=32)
    mp = mimi_params_from_jax(jax.tree.map(np.asarray, jmp))

    cfg = CSMConfig.tiny(audio_vocab_size=mcfg.codebook_size + 1)
    cfg.to_json(str(d / "config.json"))
    jcfg = JaxCSMConfig.from_json(str(d / "config.json"))
    jparams = jax.tree.map(np.asarray, jcsm.init_params(jax.random.key(0), jcfg))
    save_params_to_safetensors(str(d / "weights.safetensors"),
                               params_from_jax(jparams, cfg, "cpu"))

    frame = int(mcfg.sampling_rate / mcfg.frame_rate)
    rng = np.random.default_rng(0)
    clips = []
    for i, (rate, ch) in enumerate(((24000, 1), (48000, 2))):
        n = 3 * frame * rate // 24000
        path = str(d / f"clip{i}.wav")
        audio_io.save_wav(path, (0.3 * rng.standard_normal((ch, n))).astype(np.float32), rate)
        clips.append(path)
    with open(d / "train.jsonl", "w") as f:
        for i, clip in enumerate(clips):
            f.write(json.dumps({"messages": [
                {"role": "speaker_0", "content": [{"type": "text", "text": f"turn {i}"}]},
                {"role": "speaker_1", "content": [{"type": "text", "text": "ok there"},
                                                  {"type": "audio", "url": clip}]},
            ]}) + "\n")
    return dict(dir=d, jmimi=(jmcfg, jmp), mimi=(mcfg, mp))


def _argv(files, out: str, *extra) -> list:
    d = files["dir"]
    return ["--train_file", str(d / "train.jsonl"), "--output_dir", out,
            "--config_path", str(d / "config.json"),
            "--model_name_or_path", str(d / "weights.safetensors"),
            "--num_train_epochs", "1", "--per_device_train_batch_size", "1",
            "--gradient_accumulation_steps", "2", "--save_strategy", "no",
            "--logging_steps", "1", "--seed", "0", "--mesh_data", "1",
            "--learning_rate", "1e-3", "--pad_to_multiple", "8", *extra]


def _recording(base, rec: dict):
    """``base`` (a CSMTrainer class) recording its collated batches and the
    metrics ``train()`` returns."""

    class Recording(base):
        def _collate_group(self, buf, accum):
            out = base._collate_group(self, buf, accum)
            rec.setdefault("batches", []).append({k: np.asarray(v) for k, v in out.items()})
            return out

        def train(self):
            rec["metrics"] = base.train(self)
            rec["trainer"] = self
            return rec["metrics"]

    return Recording


def _port_codec(files, device="cpu"):
    mcfg, mp = files["mimi"]
    return MimiCodec(mcfg, mp, device=device)


def test_cli_matches_the_jax_train_py(files, tmp_path, monkeypatch):
    import train as jax_train_py

    jmcfg, jmp = files["jmimi"]
    jrec, rec = {}, {}
    monkeypatch.setattr(csm_tpu.data.tokenizer, "load_llama3_tokenizer", StubTokenizer)
    monkeypatch.setattr(csm_tpu.codec, "load_mimi",
                        lambda num_codebooks: jmimi.MimiCodec(jmcfg, jmp, num_codebooks))
    monkeypatch.setattr(csm_tpu.train, "CSMTrainer", _recording(csm_tpu.train.CSMTrainer, jrec))
    jax_train_py.main(_argv(files, str(tmp_path / "jax")))

    encodes = []
    plain_encode = mimi.mimi_encode

    def recording_encode(*args, **kw):
        encodes.append((threading.current_thread().name, torch.is_grad_enabled()))
        return plain_encode(*args, **kw)

    monkeypatch.setattr(mimi, "mimi_encode", recording_encode)
    monkeypatch.setattr(cli, "load_llama3_tokenizer", StubTokenizer)
    monkeypatch.setattr(cli, "load_mimi",
                        lambda num_codebooks, device: _port_codec(files, device))
    monkeypatch.setattr(cli, "CSMTrainer", _recording(CSMTrainer, rec))
    out = str(tmp_path / "port")
    trainer = cli.main(_argv(files, out), device="cpu")

    assert trainer is rec["trainer"] and trainer.state.step == 1
    assert len(rec["batches"]) == len(jrec["batches"]) == 1
    for got, want in zip(rec["batches"], jrec["batches"]):
        assert got.keys() == want.keys()
        assert got["input_ids"].shape == (2, 1, 32, 33)  # [accum, batch, S, 33]
        assert (got["attention_mask"][..., :32] == 1).any()  # audio frames are in
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], k)
    for k in ("loss", "backbone_loss", "decoder_loss"):
        np.testing.assert_allclose(rec["metrics"][k], jrec["metrics"][k], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=k)
    # Mimi encoded every clip in the batch-prefetch thread, without autograd.
    assert encodes and all(name == "csm-batch-prefetch" and not grad for name, grad in encodes)

    saved = CSMModel.from_pretrained(out, device="cpu")
    want = flatten(trainer.model_params())
    got = flatten(saved.params)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_cli_error_in_the_prefetch_thread_reaches_the_caller(files, tmp_path, monkeypatch):
    class Failing:
        sample_rate = 24000

        def encode(self, wave):
            raise RuntimeError("encode failed in the worker")

    monkeypatch.setattr(cli, "load_llama3_tokenizer", StubTokenizer)
    monkeypatch.setattr(cli, "load_mimi", lambda num_codebooks, device: Failing())
    with pytest.raises(RuntimeError, match="encode failed in the worker"):
        cli.main(_argv(files, str(tmp_path / "out")), device="cpu")


def test_cli_needs_cuda_unless_cpu_is_asked(files, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(_argv(files, str(tmp_path / "out")))


def test_module_entry_point_prints_help():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-m", "csm_tpu_torch.train", "--help"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for flag in ("--train_file", "--output_dir", "--bf16", "--pad_to_multiple",
                 "--amortization_ratio", "--mesh_data"):
        assert flag in res.stdout, flag


def _cli_rank(argv, mimi_files):
    """``cli.main(argv)`` on a spawned rank, the tokenizer and codec loaders
    replaced as in the tests above."""
    mcfg, mp = mimi_files
    cli.load_llama3_tokenizer = StubTokenizer
    cli.load_mimi = lambda num_codebooks, device: MimiCodec(mcfg, mp, device=device)
    trainer = cli.main(argv, device="cpu")
    out = argv[argv.index("--output_dir") + 1]
    saved = flatten(CSMModel.from_pretrained(out, device="cpu").params)
    return dict(log=trainer._metrics_log, mesh=dict(trainer.mesh.shape),
                local_wq=tuple(trainer.state.params["backbone"]["layers"]["wq"].shape),
                saved_equal=all(torch.equal(saved[k], v)
                                for k, v in flatten(trainer.model_params()).items()))


def test_cli_trains_on_a_model_axis(files, tmp_path, monkeypatch):
    """``--mesh_model 2`` on two spawned ranks: the trainer's mesh is
    (1, 1, 2) and each rank trains its shard; the losses equal the
    one-process CLI's (rtol 1e-5), and the saved model is the gathered
    parameters bit for bit."""
    from csm_tpu_torch.parallel.launch import launch

    res = launch(_cli_rank, 2, _argv(files, str(tmp_path / "tp"), "--mesh_model", "2"),
                 files["mimi"], timeout=120.0)
    monkeypatch.setattr(cli, "load_llama3_tokenizer", StubTokenizer)
    monkeypatch.setattr(cli, "load_mimi",
                        lambda num_codebooks, device: _port_codec(files, device))
    one = cli.main(_argv(files, str(tmp_path / "one")), device="cpu")
    for rec in res:
        assert rec["mesh"] == {"data": 1, "seq": 1, "model": 2}
        assert rec["local_wq"] == (2, 64, 32) and rec["saved_equal"]
        assert len(rec["log"]) == len(one._metrics_log) == 1
        for k in ("loss", "backbone_loss", "decoder_loss"):
            np.testing.assert_allclose(rec["log"][0][k], one._metrics_log[0][k], rtol=1e-5,
                                       err_msg=k)
