"""The traffic generator: every seed gets the same lengths (and open-loop
gaps), in its own order; the same seed gives the same requests."""

import hashlib
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


def turn_texts(reqs) -> list:
    """Each request's own text frames: the text at the end of its prompt."""
    return [int(np.argmin(r.mask[::-1, 32] == 1)) or len(r.ids) for r in reqs]


@pytest.mark.parametrize("name", ["serve-audio", "batch32-codes", "single-stream",
                                  "serve-prefix"])
def test_lengths_are_the_same_set_for_every_seed(name):
    t = load(name)
    a = traffic.requests(t, cfg(), 1, 30.0)
    b = traffic.requests(t, cfg(), 2 ** 33 + 5, 30.0)
    for key in ("budget", "greedy"):
        assert sorted(getattr(r, key) for r in a) == sorted(getattr(r, key) for r in b)
    assert sorted(str(r.prefix) for r in a) == sorted(str(r.prefix) for r in b)
    assert [len(r.ids) for r in a] != [len(r.ids) for r in b]
    assert all(t["response_frames"]["min"] <= r.budget <= t["response_frames"]["max"] for r in a)
    if t.get("sessions"):
        # The turns' texts are one set; a turn's prompt is its session so far.
        assert sorted(turn_texts(a)) == sorted(turn_texts(b))
        lo, hi = t["turn_text_frames"]["min"], t["turn_text_frames"]["max"]
        assert all(lo <= n <= hi for n in turn_texts(a))
        return
    assert sorted(len(r.ids) for r in a) == sorted(len(r.ids) for r in b)
    lo, hi = t["prompt_frames"]["min"], t["prompt_frames"]["max"]
    assert all(lo <= len(r.ids) <= hi for r in a)


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


def digest(reqs) -> str:
    h = hashlib.sha256()
    for r in reqs:
        h.update(np.asarray([r.index, r.budget, int(r.greedy), r.seed], np.int64).tobytes())
        h.update(np.float64(r.due).tobytes())
        h.update(r.ids.tobytes())
        h.update(r.mask.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name,digest_before", [
    ("serve-audio", "9517eb3bf8ed1b3ae14b9dda9ee8209862c315124753cd79fd732ad586dd78b9"),
    ("batch32-codes", "740abcd7c520e8569d4f4918bd0221c567ae06397b1acedca36a46c1c23d0ab8"),
    ("single-stream", "840ac94488d482348d225122e46da4e6c0832a76847421d58e1c15b2a0aaebde"),
])
def test_traffic_without_prefixes_builds_the_requests_it_built_before(name, digest_before):
    """Read from the generator before it knew of prefixes, at seed 2**33 + 5."""
    reqs = traffic.requests(load(name), cfg(), 2 ** 33 + 5, 30.0)
    assert digest(reqs) == digest_before and {r.prefix for r in reqs} == {None}
    assert traffic.prefixes(load(name), cfg(), 5) == []
    poisson = traffic.requests(open_loop("poisson"), cfg(), 7, 30.0)
    assert digest(poisson) == "0a94b329aa31c9b811f3a5364e0dca3b2be0899299c868ffc512935ccb9460fc"


def test_prefixed_requests_share_the_prefixes_evenly():
    """Sessions, not single requests: each session's turns continue one
    prefix, the prefixes an equal share of the sessions; turn ``k``'s prompt
    is turn ``k - 1``'s, its response's length of audio and its own text."""
    t = load("serve-prefix")
    a = traffic.requests(t, cfg(), 2 ** 33 + 5, 30.0)
    chains = traffic.chains(a)
    assert len(a) == t["sessions"] * t["session_turns"] and len(chains) == t["sessions"]
    assert [r for c in chains for r in c] == a
    counts = np.bincount([c[0].prefix for c in chains])
    assert len(counts) == t["prefixes"] and counts.max() - counts.min() <= 1
    for c in chains:
        assert len(c) == t["session_turns"] and len({(r.session, r.prefix) for r in c}) == 1
        for prev, r in zip(c, c[1:]):
            n = len(prev.ids)
            assert np.array_equal(r.ids[:n], prev.ids) and np.array_equal(r.mask[:n], prev.mask)
            audio = r.mask[n:n + prev.budget]
            assert (audio[:, :32] == 1).all() and (audio[:, 32] == 0).all()
            assert (r.mask[n + prev.budget:, 32] == 1).all()
    assert [r.prefix for r in a] != [r.prefix for r in traffic.requests(t, cfg(), 9, 30.0)]
    again = traffic.requests(t, cfg(), 2 ** 33 + 5, 30.0)
    assert all(np.array_equal(x.ids, y.ids) and x.seed == y.seed for x, y in zip(a, again))
    with pytest.raises(ValueError, match="closed loop"):
        traffic.requests(dict(t, loop="open"), cfg(), 1, 30.0)


def test_a_request_of_no_session_is_a_chain_of_its_own():
    reqs = traffic.requests(load("serve-audio"), cfg(), 3, 30.0)
    assert traffic.chains(reqs) == [[r] for r in reqs]


def test_prefixes_are_a_speakers_turns_drawn_from_the_seed():
    t = load("serve-prefix")
    pre = traffic.prefixes(t, cfg(), 2 ** 33 + 5)
    again = traffic.prefixes(t, cfg(), 2 ** 33 + 5)
    other = traffic.prefixes(t, cfg(), 6)
    assert len(pre) == t["prefixes"]
    n = sum(a + b for a, b in t["prefix_segments"])
    for (ids, mask), (ids2, _), (ids3, _) in zip(pre, again, other):
        assert ids.shape == (n, 33) and np.array_equal(ids, ids2)
        assert not np.array_equal(ids, ids3)
        text = mask[:, 32] == 1
        # Each speaker's prompt segment: its text, one token a frame, then its audio.
        start = 0
        for n_text, n_audio in t["prefix_segments"]:
            assert text[start:start + n_text].all()
            assert not text[start + n_text:start + n_text + n_audio].any()
            start += n_text + n_audio
        assert (mask[~text, :32] == 1).all() and ids[~text, :32].max() < t["audio_codes"]
    assert not np.array_equal(pre[0][0], pre[1][0])
