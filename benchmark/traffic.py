"""The general traffic generator: requests and training batches from a
traffic file's parameters and the run's seed.

Every seed gets the same work: lengths are a fixed stratified set of
quantiles of the stated distribution (and open-loop arrivals at even gaps,
or at the stratified gaps of a Poisson process), and the seed sets only their order, the token content,
which requests are greedy and each request's sampling noise."""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

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
    W, N = cfg.audio_num_codebooks + 1, cfg.audio_num_codebooks
    ids = np.zeros((S, W), np.int64)
    mask = np.zeros((S, W), np.float32)
    text = np.zeros(S, bool)
    for start in range(0, S, t["turn_frames"]):
        text[start:start + t["text_frames"]] = True
    text[-t["text_frames"]:] = True
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
    starts over in the same order where a window runs more)."""
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
