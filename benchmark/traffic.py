"""The general traffic generator: requests and training batches from a
traffic file's parameters and the run's seed.

Every seed gets the same work: lengths are a fixed stratified set of
quantiles of the stated distribution (and open-loop arrivals at even gaps,
or at the stratified gaps of a Poisson process), and the seed sets only their order, the token content,
which requests are greedy, which prefix each continues and each request's
sampling noise.

A serving mix with ``sessions`` sends conversations, not single requests,
as Sesame's ``run_csm.py`` generates one: the speakers' prompt segments
(``prefix_segments``, each ``[text frames, audio frames]``; the mix
registers ``prefixes`` such sets before the window, the prefix cache), then
``session_turns`` turns, each turn's request the whole conversation after
the prefix (every earlier turn's text and spoken audio) and its own text.
A session continues one prefix, an equal share of the sessions each."""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Request:
    index: int
    due: float  # seconds after the window opens (0 in a closed loop)
    ids: np.ndarray  # [S, 33] int64
    mask: np.ndarray  # [S, 33] float32
    budget: int  # frames to generate
    greedy: bool
    seed: int  # its sampling noise
    prefix: Optional[int] = None  # the registered prefix it continues
    session: Optional[int] = None  # the conversation it is a turn of


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The values at ``(i + 0.5) / n`` of ``dist`` (``lognormal``: ``median``,
    ``sigma``; ``uniform``), clipped to ``[min, max]``, rounded to ints."""
    p = (np.arange(n) + 0.5) / n
    if dist["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in p])
        v = np.exp(math.log(dist["median"]) + dist["sigma"] * z)
    elif dist["dist"] == "uniform":
        v = dist["min"] + p * (dist["max"] - dist["min"])
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return np.clip(np.rint(v), dist["min"], dist["max"]).astype(np.int64)


def prompt(cfg, S: int, t: dict, rng) -> tuple:
    """A ``[S, 33]`` conversation context: turns of ``turn_frames`` frames,
    each ``text_frames`` text frames then audio frames, ending on the text of
    the turn to be spoken."""
    text = np.zeros(S, bool)
    for start in range(0, S, t["turn_frames"]):
        text[start:start + t["text_frames"]] = True
    text[-t["text_frames"]:] = True
    return frames(cfg, text, t, rng)


def segments(cfg, parts, t: dict, rng) -> tuple:
    """A context of segments laid out as CSM's generator lays out each
    ``Segment``: for each ``(text, audio)`` its text tokens, one a frame,
    then its audio frames."""
    return frames(cfg, np.concatenate([np.arange(a + b) < a for a, b in parts]), t, rng)


def frames(cfg, text: np.ndarray, t: dict, rng) -> tuple:
    """``(ids, mask)``, ``[S, 33]``: a text token drawn from the seed on each
    frame where ``text`` holds, 32 audio codes on each other frame."""
    S = len(text)
    W, N = cfg.audio_num_codebooks + 1, cfg.audio_num_codebooks
    ids = np.zeros((S, W), np.int64)
    mask = np.zeros((S, W), np.float32)
    ids[text, N] = rng.integers(1, cfg.text_vocab_size, int(text.sum()))
    mask[text, N] = 1.0
    ids[~text, :N] = rng.integers(0, t["audio_codes"], (int((~text).sum()), N))
    mask[~text, :N] = 1.0
    return ids, mask


def requests(t: dict, cfg, seed: int, seconds: float) -> list:
    """The run's requests.  Open loop: ``rate_per_s * seconds`` requests,
    due at even gaps (``arrivals: "even"``) or at the stratified gaps of a
    Poisson process in the seed's order (``"poisson"``).  Closed loop:
    ``pool`` requests, each sent when a client is free (``pool`` is about
    the number a window runs, so every seed runs the same mix; the driver
    starts over in the same order where a window runs more).  With
    ``sessions``: see :func:`session_requests`."""
    if t.get("sessions"):
        return session_requests(t, cfg, seed)
    rng = np.random.default_rng(seed)
    if t["loop"] == "open":
        n = int(round(t["rate_per_s"] * seconds))
        p = (np.arange(n) + 0.5) / n
        if t["arrivals"] == "even":
            gaps = np.full(n, 1.0 / t["rate_per_s"])
        elif t["arrivals"] == "poisson":
            gaps = rng.permutation(-np.log1p(-p) / t["rate_per_s"])
        else:
            raise ValueError(f"unknown arrivals {t['arrivals']!r}")
        due = np.cumsum(gaps)
    elif t["loop"] == "closed":
        n = t["pool"]
        due = np.zeros(n)
    else:
        raise ValueError(f"unknown loop {t['loop']!r}")
    lengths = rng.permutation(quantiles(t["prompt_frames"], n))
    budgets = rng.permutation(quantiles(t["response_frames"], n))
    greedy = np.zeros(n, bool)
    greedy[rng.permutation(n)[:int(round(t["greedy_share"] * n))]] = True
    seeds = rng.integers(0, 2 ** 62, n)
    out = []
    for i in range(n):
        ids, mask = prompt(cfg, int(lengths[i]), t, rng)
        out.append(Request(i, float(due[i]), ids, mask, int(budgets[i]), bool(greedy[i]),
                           int(seeds[i])))
    return out


def session_requests(t: dict, cfg, seed: int) -> list:
    """A closed loop's ``sessions`` conversations of ``session_turns`` turns,
    in the seed's order, turn by turn.  Turn ``k``'s request is the
    conversation after the prefix: turns ``0..k-1``'s text and audio, then
    its own text; it asks for its response's frames.  The audio of an
    earlier turn is its response's length of codes drawn from the seed, not
    the codes the server spoke, so the inputs do not depend on the program.
    Every seed gets the same text and response lengths, in its own order."""
    if t["loop"] != "closed":
        raise ValueError("sessions are sent in a closed loop")
    rng = np.random.default_rng(seed)
    n_s, turns = t["sessions"], t["session_turns"]
    n = n_s * turns
    texts = rng.permutation(quantiles(t["turn_text_frames"], n))
    budgets = rng.permutation(quantiles(t["response_frames"], n))
    greedy = np.zeros(n, bool)
    greedy[rng.permutation(n)[:int(round(t["greedy_share"] * n))]] = True
    seeds = rng.integers(0, 2 ** 62, n)
    which = rng.permutation(np.arange(n_s) % t["prefixes"])
    out = []
    for s in range(n_s):
        i = np.arange(s * turns, (s + 1) * turns)
        ids, mask = segments(cfg, list(zip(texts[i], budgets[i])), t, rng)
        ends = np.cumsum(texts[i] + budgets[i]) - budgets[i]
        for k, j in enumerate(i):
            out.append(Request(int(j), 0.0, ids[:ends[k]], mask[:ends[k]], int(budgets[j]),
                               bool(greedy[j]), int(seeds[j]), int(which[s]), s))
    return out


def chains(reqs: list) -> list:
    """The requests in the order a closed loop's client sends them: a
    session's turns one after another, a request of no session alone."""
    out, by = [], {}
    for r in reqs:
        if r.session is None:
            out.append([r])
        elif r.session in by:
            by[r.session].append(r)
        else:
            by[r.session] = [r]
            out.append(by[r.session])
    return out


def prefixes(t: dict, cfg, seed: int) -> list:
    """The ``(ids, mask)`` of each of the mix's ``prefixes`` shared prefixes,
    the ``prefix_segments`` drawn from the seed (none where it has none)."""
    rng = np.random.default_rng([seed, 4])
    return [segments(cfg, t["prefix_segments"], t, rng) for _ in range(t.get("prefixes", 0))]


def train_batch(cfg, t: dict, seed: int, step: int) -> dict:
    """Step ``step``'s ``[accum, batch, S, 33]`` batch: the port's synthetic
    conversation recipe (``utils/synthetic.py``, copied): ``n_text`` text
    frames, then audio frames with codebook-0 labels on every frame and all
    32 codebooks' labels on an amortized 1/ratio subset.  Every step's rows
    differ."""
    rng = np.random.default_rng([seed, step])
    accum, batch, S = t["accum"], t["batch"], t["seq_len"]
    n_text, ratio = t["n_text"], t["amortization_ratio"]
    W, N = cfg.audio_num_codebooks + 1, cfg.audio_num_codebooks
    ids = np.zeros((accum, batch, S, W), np.int64)
    mask = np.zeros((accum, batch, S, W), np.float32)
    labels = np.full((accum, batch, S, W), -100, np.int64)
    ids[..., :n_text, W - 1] = rng.integers(1, cfg.text_vocab_size, (accum, batch, n_text))
    mask[..., :n_text, W - 1] = 1
    ids[..., n_text:, :N] = rng.integers(1, cfg.audio_vocab_size, (accum, batch, S - n_text, N))
    mask[..., n_text:, :N] = 1
    labels[..., n_text:, 0] = ids[..., n_text:, 0]
    n_audio = S - n_text
    for a in rng.choice(n_audio, size=n_audio // ratio, replace=False):
        labels[..., n_text + a, :N] = ids[..., n_text + a, :N]
    return {"input_ids": ids, "attention_mask": mask, "labels": labels}
