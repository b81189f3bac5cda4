"""The fused codebook loop's plain parts (csm_tpu_torch.ops.fused_decoder)
against the JAX package's on the CPU: the bundle bit for bit, the sampler bit
for bit on shared logits and noise, and the plain version of the kernel
against csm_tpu.ops.fused_decoder.emulate_decode_codebooks, teacher-forced on
the emulator's tokens.  The kernel itself is held against this plain
version on the card (chip_smoke.py, tests/test_torch_cuda.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu.config import CSMConfig as JaxCSMConfig
from csm_tpu.models import csm as jcsm
from csm_tpu.ops import fused_decoder as jfd
from csm_tpu_torch import CSMConfig
from csm_tpu_torch.checkpoint import params_from_jax
from csm_tpu_torch.ops import fused_decoder as fd
from csm_tpu_torch.ops import quant

# One bf16 ulp relative to a value's magnitude is at most 2^-7; the bound
# below is two ulps of the row's largest logit.
BF16_ULP = 2.0 ** -8


@functools.lru_cache(maxsize=None)
def _models(N: int = 8, dtype: str = "bfloat16"):
    jcfg = JaxCSMConfig.tiny(audio_num_codebooks=N)
    jp = jcsm.init_params(jax.random.key(0), jcfg, getattr(jnp, dtype))
    cfg = CSMConfig.tiny(audio_num_codebooks=N)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu", getattr(torch, dtype))
    return jcfg, jp, cfg, tp


@pytest.mark.parametrize("head_bits", [16, 8])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prepare_fused_decoder_is_bit_equal_to_jax(head_bits, dtype):
    """Against the JAX function run eagerly.  (Compiled with jax.jit, XLA
    turns its divisions by the constant 127 into multiplications by the
    reciprocal, which moves a few scales by an f32 ulp and a few int8 values
    by one step.)"""
    jcfg, jp, cfg, tp = _models(8, dtype)
    want = jfd.prepare_fused_decoder(jp, jcfg, head_bits=head_bits)
    got = fd.prepare_fused_decoder(tp, cfg, head_bits=head_bits)
    for name in ("wqkv", "wo", "w_gu", "w_down"):
        np.testing.assert_array_equal(got["w"][name].numpy(), np.asarray(want["w"][name]), name)
        np.testing.assert_array_equal(got["s"][name].numpy(), np.asarray(want["s"][name]), name)
    np.testing.assert_array_equal(got["audio_head"].float().numpy(),
                                  np.asarray(want["audio_head"]).astype(np.float32))
    if head_bits == 8:
        np.testing.assert_array_equal(got["head_scale"].numpy(), np.asarray(want["head_scale"]))
    np.testing.assert_array_equal(got["cos"].numpy(), np.asarray(want["cos"]))
    np.testing.assert_array_equal(got["sin"].numpy(), np.asarray(want["sin"]))
    # proj_emb is a matmul in the param dtype: the frameworks sum in their
    # own order, so a bf16 value may sit one ulp away (in < 1 % of values),
    # and f32 values differ in the last bits of the sum.
    proj = np.asarray(want["proj_emb"], np.float32).reshape(got["proj_emb"].shape)
    pe = got["proj_emb"].float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_allclose(pe, proj, rtol=2.0 ** -7, atol=0)
        assert (pe != proj).mean() < 0.01
    else:
        np.testing.assert_allclose(pe, proj, rtol=0, atol=1e-6 * np.abs(proj).max())


def test_quantize_per_channel_is_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 40, 24)).astype(np.float32)
    w[1, :, 5] = 0.0  # an all-zero channel keeps scale 1
    w[2, 7, 3] = 127 * 0.5 / 0.7  # values on a rounding half
    q, s = quant.quantize_per_channel(torch.from_numpy(w))
    jq, js = jfd.quantize_per_channel(jnp.asarray(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def _bf16_logits(B: int, V: int, seed: int) -> np.ndarray:
    """bf16-valued logits on a coarse grid, so rows hold many exact ties."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal((B, V)) * 3) / 2
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("greedy", [False, True])
@pytest.mark.parametrize("topk", [1, 4, 9, 40, "per-row"])
def test_sample_row_is_bit_equal_to_jax(topk, greedy):
    B, V = 6, 40
    x = _bf16_logits(B, V, seed=7)
    x[2, :] = x[2, 0]  # a row of equal logits: every value ties at the k-th
    gum = np.random.default_rng(8).gumbel(size=(B, V)).astype(np.float32)
    temp = np.array([[1.0], [0.8], [0.5], [1.3], [2.0], [0.7]], np.float32)
    k = np.array([[1], [3], [7], [40], [12], [2]], np.int32) if topk == "per-row" else topk
    want = jfd._sample_row(jnp.asarray(x), jnp.asarray(gum), jnp.asarray(temp),
                           jnp.asarray(k) if topk == "per-row" else k, greedy)
    got = fd.sample_row(torch.from_numpy(x), torch.from_numpy(gum), torch.from_numpy(temp),
                        torch.from_numpy(k) if topk == "per-row" else k, greedy)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _frame(cfg, tp, B: int, seed: int, greedy: bool):
    """x0, c0 logits and a noise table from numpy."""
    rng = np.random.default_rng(seed)
    last_h = torch.from_numpy(rng.standard_normal((B, cfg.backbone.hidden_size)).astype(np.float32))
    last_h = last_h.to(tp["projection"].dtype)
    c0 = (last_h @ tp["codebook0_head"]).float()
    x0 = (last_h @ tp["projection"]).float()
    N, Va = cfg.audio_num_codebooks, cfg.audio_vocab_size
    gum = np.zeros((N, B, Va), np.float32) if greedy else rng.gumbel(size=(N, B, Va)).astype(np.float32)
    return x0, c0, torch.from_numpy(gum)


@functools.lru_cache(maxsize=None)
def _emulator(jcfg, greedy: bool):
    return jax.jit(functools.partial(jfd.emulate_decode_codebooks, config=jcfg, greedy=greedy,
                                     return_logits=True))


def _emulate(jcfg, jqdec, x0, c0, gum, temp, topk, greedy, forced=None):
    """The JAX emulator on one stream: (tokens [N], logits [N, Va_pad])."""
    tok, lg = _emulator(jcfg, greedy)(
        jqdec, x0=jnp.asarray(x0[None].numpy()), c0_logits=jnp.asarray(c0[None].numpy()),
        gumbel=jnp.asarray(gum[:, None].numpy()), temperature=float(temp), topk=int(topk),
        forced=None if forced is None else jnp.asarray(forced[None], jnp.int32))
    return np.asarray(tok)[0], np.asarray(lg)


def _logit_misfit(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| in units of the row's two-ulp bound (<= 1 passes)."""
    live = want > -1e8
    assert np.array_equal(live, got > -1e8)
    bound = 2 * BF16_ULP * np.abs(np.where(live, want, 0)).max(axis=-1, keepdims=True)
    return float((np.abs(got - want) * live / bound).max())


@pytest.mark.parametrize("N,head_bits,greedy", [
    (8, 16, True), (8, 16, False), (8, 8, False), (8, 8, True), (32, 16, False),
])
def test_plain_version_matches_the_emulator_teacher_forced(N, head_bits, greedy):
    """B = 1: forced onto the emulator's own tokens, the plain version's
    logits lie within two bf16 ulps of the emulator's, and its samples are
    the forced tokens."""
    jcfg, jp, cfg, tp = _models(N)
    jqdec = jfd.prepare_fused_decoder(jp, jcfg, head_bits=head_bits)
    qdec = fd.prepare_fused_decoder(tp, cfg, head_bits=head_bits)
    x0, c0, gum = _frame(cfg, tp, 1, seed=N + head_bits, greedy=greedy)
    tok, want = _emulate(jcfg, jqdec, x0[0], c0[0], gum[:, 0], 0.8, 5, greedy)
    samples, logits, draws = fd.fused_decode_codebooks(
        qdec, cfg, x0, c0, gum, torch.tensor([0.8]), torch.tensor([5]), greedy,
        forced=torch.tensor(tok[None]), return_logits=True)
    np.testing.assert_array_equal(samples[0].numpy(), tok)
    assert _logit_misfit(logits[:, 0].numpy(), want) <= 1.0
    # each draw is the sampler's pick on the plain version's own logits
    gum_pad = torch.nn.functional.pad(gum, (0, logits.shape[-1] - cfg.audio_vocab_size))
    for i in range(N):
        d = fd.sample_row(logits[i], gum_pad[i], torch.tensor([[0.8]]), torch.tensor([[5]]),
                          greedy)
        assert int(d[0]) == int(draws[0, i])


def test_batched_rows_match_the_emulator_and_their_solo_calls():
    """B = 3 with per-row temperature and top-k: each row, forced onto the
    emulator's tokens for that row, is within two ulps of the emulator, and
    equals the same row run alone."""
    jcfg, jp, cfg, tp = _models(8)
    jqdec = jfd.prepare_fused_decoder(jp, jcfg)
    qdec = fd.prepare_fused_decoder(tp, cfg)
    x0, c0, gum = _frame(cfg, tp, 3, seed=11, greedy=False)
    temp = torch.tensor([0.8, 1.0, 0.5])
    topk = torch.tensor([5, 2, 23])
    toks, wants = zip(*(_emulate(jcfg, jqdec, x0[b], c0[b], gum[:, b], temp[b], topk[b], False)
                        for b in range(3)))
    forced = torch.tensor(np.stack(toks))
    samples, logits, _ = fd.fused_decode_codebooks(qdec, cfg, x0, c0, gum, temp, topk, False,
                                                   forced=forced, return_logits=True)
    np.testing.assert_array_equal(samples.numpy(), forced.numpy())
    for b in range(3):
        assert _logit_misfit(logits[:, b].numpy(), wants[b]) <= 1.0
        solo = fd.fused_decode_codebooks(qdec, cfg, x0[b:b + 1], c0[b:b + 1], gum[:, b:b + 1],
                                         temp[b:b + 1], topk[b:b + 1], False,
                                         forced=forced[b:b + 1], return_logits=True)
        assert torch.equal(solo[1][:, 0], logits[:, b])
    # unforced, the batched call equals its rows run alone
    free = fd.fused_decode_codebooks(qdec, cfg, x0, c0, gum, temp, topk, False)
    for b in range(3):
        solo = fd.fused_decode_codebooks(qdec, cfg, x0[b:b + 1], c0[b:b + 1], gum[:, b:b + 1],
                                         temp[b:b + 1], topk[b:b + 1], False)
        assert torch.equal(solo[0], free[b])


def test_bound_sees_an_unfolded_norm():
    """Control: the plain version on a bundle whose attention norm weights
    were not folded breaks the two-ulp bound (norm weights away from 1)."""
    jcfg, jp, cfg, tp = _models(8)
    rng = np.random.default_rng(3)
    jp = dict(jp)
    jp["decoder"] = dict(jp["decoder"])
    layers = dict(jp["decoder"]["layers"])
    layers["attn_norm"] = jnp.asarray(1 + 0.2 * rng.standard_normal(layers["attn_norm"].shape),
                                      jnp.bfloat16)
    jp["decoder"]["layers"] = layers
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu", torch.bfloat16)
    jqdec = jfd.prepare_fused_decoder(jp, jcfg)
    qdec = fd.prepare_fused_decoder(tp, cfg)
    x0, c0, gum = _frame(cfg, tp, 1, seed=5, greedy=True)
    tok, want = _emulate(jcfg, jqdec, x0[0], c0[0], gum[:, 0], 1.0, 5, True)
    args = (cfg, x0, c0, gum, torch.tensor([1.0]), torch.tensor([5]), True)
    kw = dict(forced=torch.tensor(tok[None]), return_logits=True)
    assert _logit_misfit(fd.fused_decode_codebooks(qdec, *args, **kw)[1][:, 0].numpy(), want) <= 1
    unfolded = fd.prepare_fused_decoder(
        {**tp, "decoder": {**tp["decoder"], "layers": {**tp["decoder"]["layers"],
                                                       "attn_norm": torch.ones_like(
                                                           tp["decoder"]["layers"]["attn_norm"])}}},
        cfg)
    assert _logit_misfit(fd.fused_decode_codebooks(unfolded, *args, **kw)[1][:, 0].numpy(), want) > 1


def test_forced_tokens_pass_through_and_noise_table_shape():
    jcfg, jp, cfg, tp = _models(8)
    qdec = fd.prepare_fused_decoder(tp, cfg, head_bits=8)
    x0, c0, gum = _frame(cfg, tp, 2, seed=1, greedy=False)
    forced = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.audio_vocab_size, (2, 8)))
    out = fd.fused_decode_codebooks(qdec, cfg, x0, c0, gum, torch.tensor([1.0, 1.0]),
                                    torch.tensor([5, 5]), False, forced=forced)
    np.testing.assert_array_equal(out.numpy(), forced.numpy())
    g = fd.build_frame_gumbel(cfg, torch.Generator().manual_seed(0), 3, False, "cpu")
    assert g.shape == (8, 3, cfg.audio_vocab_size) and torch.isfinite(g).all()
    assert not fd.build_frame_gumbel(cfg, None, 3, True, "cpu").any()
