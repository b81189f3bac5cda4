"""The port's utilities (``csm_tpu_torch.utils``: profiling, measure,
warmup) on the CPU, against the JAX package's where they compute the same
thing: ``FrameTimer.summary()`` equal on the same clock, ``prefill_flops``
exactly equal (CSM-1B counted on ``jax.eval_shape`` parameters on the JAX
side, on the configuration's shapes on the port's)."""

import glob
import json
import math

import jax
import numpy as np
import pytest
import torch

from csm_tpu.config import CSMConfig as JaxCSMConfig
from csm_tpu.models import csm as jcsm
from csm_tpu.utils import measure as jmeasure
from csm_tpu.utils import profiling as jprofiling
from csm_tpu_torch import CSMConfig, CSMModel
from csm_tpu_torch.utils import FrameTimer, enable_nan_checks, measure, trace
from csm_tpu_torch.utils.profiling import sync
from csm_tpu_torch.utils.warmup import warmup_generation


def _fake_clock(monkeypatch, ticks):
    it = iter(ticks)
    monkeypatch.setattr("time.perf_counter", lambda: next(it))


def test_frame_timer_summary_equals_jax(monkeypatch):
    ticks = [0.0, 0.25, 1.0, 1.5, 2.0, 2.125]
    frames = (16, 32, 8)
    summaries = []
    for cls in (FrameTimer, jprofiling.FrameTimer):
        _fake_clock(monkeypatch, ticks)
        timer = cls()
        for f in frames:
            with timer.step(frames=f):
                pass
        summaries.append(timer.summary())
    got, want = summaries
    assert got == want
    assert got["steps"] == 3 and got["audio_realtime_factor"] == 56 / 12.5 / 0.875
    assert FrameTimer().summary() == jprofiling.FrameTimer().summary() == {"steps": 0}


def test_trace_writes_a_trace_with_the_named_region(tmp_path):
    with trace(str(tmp_path), name="csm-region"):
        torch.randn(8, 8) @ torch.randn(8, 8)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "csm-region" for e in events)
    assert any(e.get("name") == "aten::mm" for e in events)


def test_nan_checks_raise_and_stop_when_off():
    try:
        enable_nan_checks(True)
        torch.log(torch.tensor(2.0))  # finite: no raise
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(torch.tensor(-1.0))
        enable_nan_checks(True)  # twice on is once on
    finally:
        enable_nan_checks(False)
    assert torch.isnan(torch.log(torch.tensor(-1.0)))
    assert not torch.is_anomaly_enabled()


def test_nan_checks_catch_the_backward():
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    try:
        enable_nan_checks(True)
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        with pytest.raises((FloatingPointError, RuntimeError), match="nan|NaN"):
            torch.sqrt(x).sum().backward()
    finally:
        enable_nan_checks(False)


def test_sync_takes_any_tree_of_cpu_tensors():
    sync({"a": torch.zeros(2), "b": [torch.ones(1), (3, "x")]})
    sync([])


@pytest.mark.parametrize("size", ["tiny", "csm-1b"])
@pytest.mark.parametrize("S", [16, 128, 2048])
def test_prefill_flops_equal_jax(size, S):
    jcfg = JaxCSMConfig.tiny() if size == "tiny" else JaxCSMConfig()
    cfg = CSMConfig.tiny() if size == "tiny" else CSMConfig()
    jparams = jax.eval_shape(lambda k: jcsm.init_params(k, jcfg), jax.random.key(0))
    want = jmeasure.prefill_flops(jparams, jcfg, S)
    assert measure.prefill_flops(None, cfg, S) == want
    if size == "tiny":
        model = CSMModel(cfg, device="cpu")
        assert measure.prefill_flops(model.params, cfg, S) == want


def test_h100_peak_is_the_data_sheet_figure():
    assert measure.H100_BF16_DENSE_FLOPS == 989e12


def test_prefill_ms_on_the_cpu_is_finite_and_positive():
    cfg = CSMConfig.tiny()
    model = CSMModel(cfg, device="cpu")
    ms = measure.prefill_ms_on_device(model.params, cfg, 32, reps=2, device="cpu")
    assert math.isfinite(ms) and ms > 0


def _prompt(cfg, S=10, seed=5):
    rng = np.random.default_rng(seed)
    ids = np.zeros((1, S, 33), np.int64)
    ids[..., 32] = rng.integers(1, cfg.text_vocab_size, (1, S))
    mask = np.zeros((1, S, 33), np.float32)
    mask[..., 32] = 1
    return ids, mask


@pytest.mark.parametrize("tier", ["plain", "quantize"])
def test_warmup_counts_its_runs_and_leaves_generation_unchanged(tier):
    """``warmup_generation`` runs each (B, S, frames) once and returns the
    count; it leaves the global generator where it was, and a seeded
    ``generate`` after it is bitwise the one before it (its draws came from
    a generator of its own)."""
    cfg = CSMConfig.tiny()
    model = CSMModel(cfg, device="cpu")
    if tier == "quantize":
        model.quantize(bits=4)
    ids, mask = _prompt(cfg)

    def run():
        g = torch.Generator()
        g.manual_seed(7)
        return model.generate(ids, mask, max_new_frames=3, generator=g)

    before = run()
    state = torch.get_rng_state()
    n = warmup_generation(model.params, cfg, batch_sizes=(1, 2), prompt_buckets=(16, 32),
                          frame_budgets=(2,), qdec=model._qdec, qbb=model._qbb,
                          qsb=model._qsb, device="cpu")
    assert n == 2 * 2 * 1
    assert torch.equal(torch.get_rng_state(), state)
    np.testing.assert_array_equal(run(), before)


def test_warmup_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cfg = CSMConfig.tiny()
    model = CSMModel(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        warmup_generation(model.params, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        measure.prefill_ms_on_device(model.params, cfg, 16)
