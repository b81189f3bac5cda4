"""A run with its timed path broken underneath comes out not correct: once
for each fault a cell can have (a token altered where it is produced; a
sampled token drawn without the top-k filter; a continuation served without
its registered prefix, from another speaker's prefix or from a prefix cache
whose keys and values are lost; a training step that returns its state unchanged, or
that leaves half of its batch out and takes the mean over the rest).  The cells run on one card, so
no exchange between cards can be left out.  Driven through ``run.py``'s main
path at tiny sizes on the CPU, held to the committed limits; the tiny
model's logits spread about six times less than CSM-1B's (a decoder of 32
against 1024 wide), so the serving fault is held to a sixth of the committed
``logit_gap`` limit."""

import json
import os

import pytest

from benchmark import spec
from benchmark.tests.harness import run_tiny


@pytest.mark.parametrize("workload", ["int4-serve-audio", "int4-batch32-codes",
                                      "bf16-exact-stream", "int4-serve-prefix"])
def test_a_token_altered_where_it_is_produced(monkeypatch, capsys, workload):
    from csm_tpu_torch import serving

    real = serving.generate_frame

    def altered(params, config, *a, **k):
        out = real(params, config, *a, **k)
        out.samples = (out.samples + 1) % config.audio_vocab_size
        return out

    monkeypatch.setattr(serving, "generate_frame", altered)
    tier = "csm-1b-int4" if workload.startswith("int4") else "csm-1b-bf16"
    with open(os.path.join(spec.HERE, "configs", tier + ".json")) as fh:
        lim = json.load(fh)["limits"]["logit_gap"] / 6
    out = run_tiny(monkeypatch, capsys, workload, limits={"logit_gap": lim})
    assert out["correct"] is False
    gap = out["checks"]["logit_gap"]
    assert gap["value"] > gap["limit"]


@pytest.mark.parametrize("workload", ["int4-serve-audio", "bf16-exact-stream",
                                      "int4-serve-prefix"])
def test_sampling_without_its_top_k_filter(monkeypatch, capsys, workload):
    """The sampled tokens drawn from the whole vocabulary, the greedy ones
    untouched: only ``topk_gap`` can see it (the tiny cells keep a top 8 of
    the tiny model's 23 codes)."""
    from csm_tpu_torch.ops import fused_decoder, specdec

    real = fused_decoder.row_params

    def no_topk(B, Va, *a, **k):
        temp, kk, gumbel = real(B, Va, *a, **k)
        return temp, kk.masked_fill(kk > 1, Va), gumbel

    monkeypatch.setattr(fused_decoder, "row_params", no_topk)
    monkeypatch.setattr(specdec, "row_params", no_topk)
    tier = "csm-1b-int4" if workload.startswith("int4") else "csm-1b-bf16"
    with open(os.path.join(spec.HERE, "configs", tier + ".json")) as fh:
        lim = json.load(fh)["limits"]["topk_gap"] / 6
    out = run_tiny(monkeypatch, capsys, workload, limits={"topk_gap": lim})
    assert out["correct"] is False
    gap = out["checks"]["topk_gap"]
    assert gap["value"] > gap["limit"]
    assert out["checks"]["logit_gap"]["value"] <= out["checks"]["logit_gap"]["limit"]


def test_a_continuation_served_without_its_prefix(monkeypatch, capsys):
    """The server is handed each continuation without its prefix: it
    prefills and serves it as a whole prompt.  The check still teacher-forces
    prefix and continuation, and ``prefix_admits`` reads that no admission in
    the window started from a prefix (the tiny model's logits hardly depend
    on far context, so ``logit_gap`` alone need not see it)."""
    from csm_tpu_torch import serving

    real = serving.CSMServer.submit

    def without_prefix(self, *a, prefix_id=None, **k):
        return real(self, *a, **k)

    monkeypatch.setattr(serving.CSMServer, "submit", without_prefix)
    out = run_tiny(monkeypatch, capsys, "int4-serve-prefix", seconds=2.0)
    assert out["correct"] is False
    assert out["checks"]["prefix_admits"]["value"] == 0.0


@pytest.mark.parametrize("fault", ["swapped_prefix", "zeroed_prefix"])
def test_a_continuation_served_from_the_wrong_prefix(monkeypatch, capsys, fault):
    """Every admission starts from a prefix, so ``prefix_admits`` reads 1;
    ``prefix_gap_share`` sees that the served tokens do not lie nearer the
    reference behind the request's own prefix than behind another."""
    from benchmark.control import FAULTS

    with FAULTS[fault]():
        out = run_tiny(monkeypatch, capsys, "int4-serve-prefix", seconds=2.0)
    assert out["correct"] is False
    assert out["checks"]["prefix_admits"]["value"] == 1.0
    share = out["checks"]["prefix_gap_share"]
    assert share["value"] > share["limit"]


def unchanged(step_fn, state, batch):
    """A step whose update never lands: the optimizer's step is skipped."""
    real = state.optimizer.step
    state.optimizer.step = lambda *a, **k: None
    try:
        return step_fn(state, None, batch)
    finally:
        state.optimizer.step = real


def half_batch(step_fn, state, batch):
    from benchmark.control import half_batch as fault

    return fault(step_fn, state, batch)


@pytest.mark.parametrize("fault,numbers", [(unchanged, ("grad_rel", "change_rel")),
                                           (half_batch, ("gnorm_rel",))])
def test_a_broken_training_step(monkeypatch, capsys, fault, numbers):
    out = run_tiny(monkeypatch, capsys, "bf16-train-s2048", fault=fault)
    assert out["correct"] is False
    for n in numbers:
        assert out["checks"][n]["value"] > out["checks"][n]["limit"], n
