"""The ``granite`` family (CSM on Granite-4.0-H-Micro's hybrid backbone):
its weights, FLOPs and kernel work pinned to literals read when it was
added; its CPU twin through the serve driver and ``run.py``'s main path,
the new per-layer readers included; and the faults its check has to catch,
each planted underneath the timed path: a recurrent state reset every frame,
a prompt's pad frames fed into the state, a registered prefix whose states
are zero.  Held to the configuration's limits, the tiny model's logits
spreading less than the full model's as in ``test_bench_faults.py``."""

import json
import math
import os
import sys
import types

import pytest
import torch

from benchmark import spec, weights
from benchmark.tests.harness import run_tiny
from benchmark.tests.test_bench_family import digest

CELL = "granite-h-batch32-codes"
CONF = "csm-granite-4.0-h-micro"


def conf() -> dict:
    with open(os.path.join(spec.HERE, "configs", CONF + ".json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def fam_cfg():
    c = conf()
    fam = spec.family(c)
    return fam, fam.config(c["model"])


def test_the_configuration_is_the_published_one(fam_cfg):
    """Every key of the published ``config.json`` as published, at the top
    level and in the backbone the port reads; nothing reduced."""
    c = conf()
    fam, cfg = fam_cfg
    bb = c["model"]["backbone_config"]
    published = {k: v for k, v in c.items() if k in bb}
    assert len(published) == 33 and all(bb[k] == v for k, v in published.items())
    b = cfg.backbone
    assert (b.hidden_size, b.num_hidden_layers, b.mamba_n_heads, b.mamba_d_head,
            b.mamba_d_state, b.shared_intermediate_size) == (2048, 40, 64, 64, 128, 8192)
    assert b.attention_layers == (5, 15, 25, 35) and cfg.text_vocab_size == 100352
    assert c["reduced"] == [] and c["family"] == "granite"


def test_the_family_draws_the_weights(fam_cfg):
    """The seed's draw with the mixers' per-head constants set, pinned; the
    constants spread over the published init's ranges, head 0 the slowest."""
    fam, cfg = fam_cfg
    tiny = fam.config(fam.tiny(conf())["model"])
    seed = 2 ** 31 + 11
    for dtype, want in (
            (torch.float32, "a797a607e27a69e847ac2c1961639df580f8aae19ce56a2847e35e8e0e61606f"),
            (torch.bfloat16, "2d07b754869d9bff47306a8796d80724a32783e36bf069d51c3ae707b41a4812")):
        params = weights.model_params(fam, tiny, seed, dtype, "cpu")
        fam.mixer_constants(params, tiny)
        assert digest(params) == want
    shapes = fam.shapes(cfg)
    assert len(shapes) == 38 and sum(math.prod(s) for _, s, _, _ in shapes) == 3_508_373_248
    fills = {p.rsplit(".", 1)[-1]: c for p, _, sc, c in shapes if sc is None}
    assert {k: fills[k] for k in ("A_log", "dt_bias", "D", "conv_b")} == fam.FILLS
    dt_bias, a_log = fam.head_constants(64)
    dt = torch.nn.functional.softplus(dt_bias)
    assert dt[0] == pytest.approx(1e-3) and dt[-1] == pytest.approx(0.1)
    assert a_log.exp()[0] == pytest.approx(1.0) and a_log.exp()[-1] == pytest.approx(16.0)
    assert bool((dt.diff() > 0).all() and (a_log.diff() > 0).all())


def test_the_family_counts_the_flops_and_the_kernels_work(fam_cfg):
    fam, cfg = fam_cfg
    assert [fam.prefill_flops(cfg, S) for S in (128, 512, 2048)] == \
        [776731557888.0, 3110147457024.0, 12492129435648.0]
    assert [fam.frame_flops(cfg, c) for c in (100, 1024)] == [13242627584.0, 13272905216.0]
    assert [fam.request_flops(cfg, 128, 40), fam.request_flops(cfg, 300, 0),
            fam.request_flops(cfg, 37, 5)] == [1300432802304.0, 0.0, 284605826560.0]
    # One stream: the bf16 state read and written (2,097,152 bytes) and the rest.
    assert [fam.ssm_work(cfg, B) for B in (1, 32)] == [(2226688, 2656256),
                                                       (69892992, 85000192)]
    assert fam.k2_work(cfg, 32) == (3596573312, 224686571520)


def test_the_twin_runs_the_cell_traced_with_the_new_readers(monkeypatch, capsys):
    """Traced on the CPU the mixer steps run their plain version, so the
    device trace holds no mixer kernel: ``ssm_ms.batch`` reads the plain
    version's launch spans (host time: no device number),
    ``ssm_roofline.batch`` nothing."""
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", CELL])
    out = run_tiny(monkeypatch, capsys, CELL, trace=1)
    assert out["correct"] is True, out["checks"]
    assert out["metrics"]["ssm_ms.batch"]["value"] > 0
    assert "ssm_roofline.batch" not in out["metrics"]


def _traced(monkeypatch, steps: int, B: int, kernels: dict):
    """A traced run whose session holds ``steps`` backbone steps at batch
    ``B`` and whose device trace holds ``kernels``."""
    from csm_tpu_torch.utils import profiling

    spans = [types.SimpleNamespace(attrs={"S": 1, "B": B}) for _ in range(steps)]
    launches = [types.SimpleNamespace(device_ms=0.5) for _ in range(36 * steps)]
    sess = types.SimpleNamespace(named=lambda n: {"csm.gen.backbone": spans,
                                                  "csm.ssm.launch": launches}.get(n, []))
    monkeypatch.setattr(profiling, "last_session", lambda: sess)
    return types.SimpleNamespace(trace={"kernels": kernels})


KERNEL_NAME = ("void (anonymous namespace)::ssm_step_kernel<__nv_bfloat16, 1>"
               "(__nv_bfloat16 const*, ...)")


@pytest.mark.parametrize("argv", [["--workload", CELL], [f"--workload={CELL}", "--seed", "3"]])
def test_the_roofline_reader_divides_the_launches_bounds_by_the_kernels_time(monkeypatch,
                                                                           fam_cfg, argv):
    """Two steps of 36 launches at B = 32, 80 µs each: the launches' bounds
    over 5.76 ms; the launch count is the trace's, not a span's."""
    from benchmark import yardstick

    fam, cfg = fam_cfg
    reader = spec.reader("ssm_roofline.batch")
    run = _traced(monkeypatch, 2, 32, {KERNEL_NAME: [72, 72 * 80e-6], "other": [1, 1.0]})
    monkeypatch.setattr(sys, "argv", ["run.py", *argv])
    want = 100 * yardstick.bound_s(*fam.ssm_work(cfg, 32)) / 80e-6
    assert reader(run) == pytest.approx(want) and 20 < want < 30
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", "int4-batch32-codes"])
    assert reader(run) is None  # the csm family has no such kernel


def test_the_ms_reader_divides_the_kernels_time_by_the_steps(monkeypatch):
    """72 launches of 80 µs over 2 steps: 2.88 ms a step, whatever the
    launch spans read (a graph replay fires none); without the kernel in the
    trace, the spans' 36 x 0.5 ms a step; nothing without steps."""
    reader = spec.reader("ssm_ms.batch")
    run = _traced(monkeypatch, 2, 32, {KERNEL_NAME: [72, 72 * 80e-6], "other": [1, 1.0]})
    assert reader(run) == pytest.approx(2.88)
    assert reader(_traced(monkeypatch, 2, 32, {"other": [1, 1.0]})) == pytest.approx(18.0)
    assert reader(_traced(monkeypatch, 0, 32, {KERNEL_NAME: [72, 1.0]})) is None


# ---------------------------------------------------------------------------
# Faults
# ---------------------------------------------------------------------------

# The tiny twin's logits spread about six times less than the full model's
# (as CSM-1B's twin, test_bench_faults.py), so the faults are held to a sixth
# of the configuration's logit_gap limit.
def _limits():
    return {"logit_gap": conf()["limits"]["logit_gap"] / 6}


def _greedy_only(monkeypatch):
    """Every request greedy: a fault in the state shows in every token."""
    from benchmark.tests import tiny

    real = tiny.tiny_traffic
    monkeypatch.setattr(tiny, "tiny_traffic", lambda t: dict(real(t), greedy_share=1.0,
                                                             check_sampled=0))


def test_a_state_reset_every_frame_is_not_correct(monkeypatch, capsys):
    from csm_tpu_torch.models import hybrid

    real = hybrid._mixer_step

    def reset(lp, config, x, conv_state, ssm_state):
        conv_state.zero_()
        ssm_state.zero_()
        return real(lp, config, x, conv_state, ssm_state)

    monkeypatch.setattr(hybrid, "_mixer_step", reset)
    _greedy_only(monkeypatch)
    out = run_tiny(monkeypatch, capsys, CELL, limits=_limits())
    assert out["correct"] is False
    assert out["checks"]["logit_gap"]["value"] > out["checks"]["logit_gap"]["limit"]


def test_pad_frames_fed_into_the_state_are_not_correct(monkeypatch, capsys):
    """The prefill's scan given every frame of the bucket as real."""
    from csm_tpu_torch.models import hybrid

    real = hybrid._mixer_scan

    def padded(lp, config, x, lengths, conv_state, ssm_state):
        return real(lp, config, x, torch.full_like(lengths, x.shape[1]), conv_state, ssm_state)

    monkeypatch.setattr(hybrid, "_mixer_scan", padded)
    _greedy_only(monkeypatch)
    out = run_tiny(monkeypatch, capsys, CELL, limits=_limits())
    assert out["correct"] is False
    assert out["checks"]["logit_gap"]["value"] > out["checks"]["logit_gap"]["limit"]


def _prefix_bench():
    """The benchmark with the granite configuration under the prefix mix
    (``serve-prefix``) as one more cell, its metrics' cells appended."""
    bench = spec.load_benchmark()
    bench["workloads"].append({"name": "granite-serve-prefix", "config": CONF,
                               "traffic": "serve-prefix", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "int4-serve-prefix" in m.get("workloads", []):
            m["workloads"].append("granite-serve-prefix")
    return bench


def test_the_prefix_path_serves_within_the_limits(monkeypatch, capsys):
    """Sessions on registered prefixes through the granite twin: every
    admission starts from a prefix and the served tokens lie within the
    limits of the reference behind prefix and continuation.  (The twin's
    ``prefix_gap_share`` on the sound program depends on which requests the
    window finishes, 0.005-0.4 in trials: its small layers tell its two
    prefixes apart only by a little; the full model's is the chip's
    reading.)"""
    out = run_tiny(monkeypatch, capsys, "granite-serve-prefix", bench=_prefix_bench())
    for name in ("checked_requests", "logit_gap", "topk_gap", "pcm_rel", "prefix_admits"):
        c = out["checks"][name]
        assert c["value"] <= c["limit"] if c["must_be"] == "<=" else c["value"] >= c["limit"]


def test_a_zeroed_prefix_state_is_not_correct(monkeypatch, capsys):
    """Each registered prefix's recurrent states zeroed (its attention K/V
    kept): the served tokens lie nearer the reference behind another prefix
    than behind their own, which ``prefix_gap_share`` refuses."""
    from csm_tpu_torch.serving import CSMServer

    bench = _prefix_bench()
    real = CSMServer.register_prefix

    def register(self, *a, **k):
        pid = real(self, *a, **k)
        cache, _ = self._prefixes[pid]
        cache.ssm.zero_()
        cache.conv.zero_()
        return pid

    monkeypatch.setattr(CSMServer, "register_prefix", register)
    _greedy_only(monkeypatch)
    out = run_tiny(monkeypatch, capsys, "granite-serve-prefix", bench=bench, limits=_limits())
    assert out["correct"] is False
    share = out["checks"]["prefix_gap_share"]
    assert share["value"] > share["limit"]
