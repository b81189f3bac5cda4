"""The traffic generator: every seed gets the same lengths (and open-loop
gaps), in its own order; the same seed gives the same requests."""

import json
import os

import numpy as np
import pytest

from benchmark import spec, traffic


def cfg():
    from csm_tpu_torch.config import CSMConfig

    return CSMConfig()


def load(name):
    with open(os.path.join(spec.HERE, "traffic", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["serve-audio", "batch32-codes", "single-stream"])
def test_lengths_are_the_same_set_for_every_seed(name):
    t = load(name)
    a = traffic.requests(t, cfg(), 1, 30.0)
    b = traffic.requests(t, cfg(), 2 ** 33 + 5, 30.0)
    for key in ("budget", "greedy"):
        assert sorted(getattr(r, key) for r in a) == sorted(getattr(r, key) for r in b)
    assert sorted(len(r.ids) for r in a) == sorted(len(r.ids) for r in b)
    assert [len(r.ids) for r in a] != [len(r.ids) for r in b]
    lo, hi = t["prompt_frames"]["min"], t["prompt_frames"]["max"]
    assert all(lo <= len(r.ids) <= hi for r in a)
    assert all(t["response_frames"]["min"] <= r.budget <= t["response_frames"]["max"] for r in a)


def open_loop(arrivals):
    return dict(load("serve-audio"), loop="open", arrivals=arrivals, rate_per_s=1.6)


def test_even_arrivals_fill_the_window_at_the_rate():
    t = open_loop("even")
    a = traffic.requests(t, cfg(), 7, 30.0)
    gaps = np.diff([0.0] + [r.due for r in a])
    assert t["arrivals"] == "even" and np.allclose(gaps, 1.0 / t["rate_per_s"])
    assert len(a) == round(t["rate_per_s"] * 30) and 29.0 < a[-1].due <= 30.5


def test_poisson_arrivals_are_seeded_and_fill_the_window():
    t = open_loop("poisson")
    a = traffic.requests(t, cfg(), 7, 30.0)
    again = traffic.requests(t, cfg(), 7, 30.0)
    other = traffic.requests(t, cfg(), 8, 30.0)
    assert len(a) == round(t["rate_per_s"] * 30)
    assert [r.due for r in a] == [r.due for r in again]
    assert all(np.array_equal(x.ids, y.ids) and x.seed == y.seed for x, y in zip(a, again))
    gaps = np.diff([0.0] + [r.due for r in a])
    other_gaps = np.diff([0.0] + [r.due for r in other])
    assert np.allclose(sorted(gaps), sorted(other_gaps)) and not np.allclose(gaps, other_gaps)
    assert 25.0 < a[-1].due < 35.0 and np.all(gaps > 0)


@pytest.mark.parametrize("key,value", [("arrivals", "bursts"), ("loop", "half-open")])
def test_an_unknown_kind_of_arrivals_is_refused(key, value):
    with pytest.raises(ValueError, match=value):
        traffic.requests(dict(open_loop("even"), **{key: value}), cfg(), 7, 30.0)


def test_lognormal_quantiles_have_the_stated_median():
    q = traffic.quantiles({"dist": "lognormal", "median": 128, "sigma": 0.75, "min": 32,
                           "max": 512}, 101)
    assert q[50] == 128 and q.min() >= 32 and q.max() <= 512 and np.all(np.diff(q) >= 0)
    u = traffic.quantiles({"dist": "uniform", "min": 12, "max": 60}, 4)
    assert list(u) == [18, 30, 42, 54]


def test_prompts_are_conversations():
    t = load("serve-audio")
    ids, mask = traffic.prompt(cfg(), 130, t, np.random.default_rng(0))
    text = mask[:, 32] == 1
    assert text[:8].all() and not text[8:64].any() and text[64:72].all() and text[-8:].all()
    assert (mask[~text, :32] == 1).all() and (mask[text, :32] == 0).all()
    assert ids[~text, :32].max() < t["audio_codes"]


def test_train_batches_differ_by_step_and_repeat_by_seed():
    t = load("train-s2048")
    c = cfg()
    a0, a1 = traffic.train_batch(c, t, 5, 0), traffic.train_batch(c, t, 5, 1)
    assert a0["input_ids"].shape == (8, 1, 2048, 33)
    assert np.array_equal(a0["input_ids"], traffic.train_batch(c, t, 5, 0)["input_ids"])
    assert not np.array_equal(a0["input_ids"], a1["input_ids"])
    for i in range(8):
        for j in range(i):
            assert not np.array_equal(a0["input_ids"][i], a0["input_ids"][j])
    full = (a0["labels"][0, 0, :, :32] != -100).all(axis=-1)
    assert full.sum() == (2048 - 64) // 16


def test_train_batch_is_the_ports_recipe():
    """The copied recipe against the port's ``synthetic_conversation_batch``
    run with the same generator: the same shapes, masks and label layout."""
    from csm_tpu_torch.utils.synthetic import synthetic_conversation_batch

    t = dict(load("train-s2048"), seq_len=256, accum=2)
    c = cfg()
    mine = traffic.train_batch(c, t, 3, 0)
    ports = synthetic_conversation_batch(c, 256, accum=2, seed=np.random.default_rng([3, 0]))
    for k in mine:
        assert np.array_equal(mine[k], ports[k])
