"""The speculative codebook loop (csm_tpu_torch.ops.specdec) and the fast
tiers of CSMModel on the CPU.  The draft runs the fused decoder's plain
version; the output must be a fixed point of the verify pass and equal the
port's plain bf16 loop, greedy and sampled from the same generator seed (the
tiers share one noise table per frame)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu.config import CSMConfig as JaxCSMConfig
from csm_tpu.models import csm as jcsm
from csm_tpu_torch import CSMConfig, CSMModel, generation
from csm_tpu_torch.checkpoint import params_from_jax
from csm_tpu_torch.ops import fused_decoder as fd
from csm_tpu_torch.ops import specdec


@functools.lru_cache(maxsize=None)
def _model(N: int = 8):
    jcfg = JaxCSMConfig.tiny(audio_num_codebooks=N)
    jp = jcsm.init_params(jax.random.key(0), jcfg, jnp.bfloat16)
    cfg = CSMConfig.tiny(audio_num_codebooks=N)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu", torch.bfloat16)
    return cfg, tp, fd.prepare_fused_decoder(tp, cfg, head_bits=8)


def _frame_inputs(cfg, tp, B: int, seed: int):
    rng = np.random.default_rng(seed)
    last_h = torch.tensor(rng.standard_normal((B, cfg.backbone.hidden_size)),
                          dtype=torch.bfloat16)
    return last_h, last_h @ tp["codebook0_head"]


@pytest.mark.parametrize("N,B,seed,greedy", [
    (8, 1, 0, True), (8, 1, 3, True), (8, 1, 7, False), (8, 2, 11, False), (8, 3, 12, True),
    (32, 1, 13, True), (32, 2, 14, False),
])
def test_specdec_equals_the_plain_loop(N, B, seed, greedy):
    """Random-weight drafts disagree often, so the re-draft loop runs many
    rounds; its output is the plain bf16 loop's, and a fixed point of the
    verify pass."""
    cfg, tp, qdec = _model(N)
    last_h, c0 = _frame_inputs(cfg, tp, B, seed)
    temp = torch.tensor([0.8, 1.0, 0.6][:B]) if not greedy else 1.0
    topk = torch.tensor([5, 3, 9][:B]) if not greedy else 5
    kw = dict(temperature=temp, topk=topk, greedy=greedy)
    plain = generation.decode_frame(tp, cfg, last_h, c0, generator=torch.Generator().manual_seed(seed),
                                    **kw)
    spec = generation.decode_frame(tp, cfg, last_h, c0, generator=torch.Generator().manual_seed(seed),
                                   qdec=qdec, specdec=True, **kw)
    np.testing.assert_array_equal(spec.numpy(), plain.numpy())

    gum = fd.build_frame_gumbel(cfg, torch.Generator().manual_seed(seed), B, greedy, "cpu")
    tokens, rounds = specdec.decode_frame_specdec(tp, qdec, cfg, last_h, c0, gum, temp, topk,
                                                  greedy, return_rounds=True)
    assert torch.equal(tokens, spec)
    assert 1 <= rounds <= N - 1
    t, k, _ = fd.row_params(B, cfg.audio_vocab_size, temp, topk, gum)
    again = specdec.verify_codebooks(tp, cfg, last_h, tokens, gum, t[:, None], k[:, None], greedy)
    assert torch.equal(again, tokens)


def test_forced_tokens_pass_through_and_a_forced_prefix_is_kept():
    cfg, tp, qdec = _model(8)
    last_h, c0 = _frame_inputs(cfg, tp, 2, seed=4)
    gum = fd.build_frame_gumbel(cfg, torch.Generator().manual_seed(1), 2, False, "cpu")
    forced = torch.tensor(np.random.default_rng(0).integers(0, cfg.audio_vocab_size, (2, 8)))
    out = fd.decode_frame_fused(tp, qdec, cfg, last_h, c0, gum, 1.0, 5, False, forced=forced)
    assert torch.equal(out, forced)
    base = fd.decode_frame_fused(tp, qdec, cfg, last_h, c0, gum, 1.0, 5, False)
    half = torch.where(torch.arange(8) < 4, base, torch.full_like(base, -1))
    again = fd.decode_frame_fused(tp, qdec, cfg, last_h, c0, gum, 1.0, 5, False, forced=half)
    assert torch.equal(again, base)


def test_greedy_rows_draw_the_argmax():
    """A greedy row in a sampled batch is top-1 with its noise zeroed: the
    same tokens as the greedy frame."""
    cfg, tp, qdec = _model(8)
    last_h, c0 = _frame_inputs(cfg, tp, 2, seed=6)
    gum = fd.build_frame_gumbel(cfg, torch.Generator().manual_seed(2), 2, False, "cpu")
    mixed = specdec.decode_frame_specdec(tp, qdec, cfg, last_h, c0, gum, 0.8, 5, False,
                                         greedy_rows=torch.tensor([True, False]))
    greedy = specdec.decode_frame_specdec(tp, qdec, cfg, last_h, c0, gum * 0, 0.8, 5, True)
    assert torch.equal(mixed[0], greedy[0])


def _prompt(cfg, B: int, S: int, seed: int):
    rng = np.random.default_rng(seed)
    N = cfg.audio_num_codebooks
    ids = np.zeros((B, S, cfg.frame_width), np.int64)
    ids[..., :N] = rng.integers(1, cfg.audio_vocab_size, (B, S, N))
    ids[:, :2, :N] = 0
    ids[:, :2, N] = rng.integers(1, cfg.text_vocab_size, (B, 2))
    return ids, (ids > 0).astype(np.float32)


@pytest.mark.parametrize("head_bits", [16, 8])
def test_quantize_generate_runs_end_to_end(head_bits):
    """quantize(): the fused decoder (its plain version here) on every frame
    and the int8 backbone step on the frames after the prompt."""
    cfg, tp, _ = _model(32)
    model = CSMModel(cfg, tp, dtype=torch.bfloat16, device="cpu").quantize(head_bits=head_bits)
    ids, mask = _prompt(cfg, 3, 9, seed=head_bits)
    gen = torch.Generator().manual_seed(0)
    frames = model.generate(ids, mask, max_new_frames=3, temperature=0.8, topk=5,
                            stop_on_all_zeros=False, generator=gen)
    assert frames.shape == (3, 3, 32)
    assert 0 <= frames.min() and frames.max() < cfg.audio_vocab_size
    greedy = model.generate(ids, mask, max_new_frames=3, greedy=True, stop_on_all_zeros=False)
    again = model.generate(ids, mask, max_new_frames=3, greedy=True, stop_on_all_zeros=False)
    np.testing.assert_array_equal(greedy, again)


def test_exact_generate_sampled_equals_the_plain_path():
    """exact() in sampled mode: the same generator seed gives the plain bf16
    path's tokens (one noise table per frame, shared by the tiers)."""
    cfg, tp, _ = _model(32)
    ids, mask = _prompt(cfg, 2, 9, seed=5)
    kw = dict(max_new_frames=3, temperature=0.8, topk=5, stop_on_all_zeros=False)
    model = CSMModel(cfg, tp, dtype=torch.bfloat16, device="cpu")
    plain = model.generate(ids, mask, generator=torch.Generator().manual_seed(3), **kw)
    exact = model.exact().generate(ids, mask, generator=torch.Generator().manual_seed(3), **kw)
    assert exact.shape == (2, 3, 32)
    np.testing.assert_array_equal(exact, plain)
