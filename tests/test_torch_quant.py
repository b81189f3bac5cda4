"""The int8 tiers' plain parts against the JAX package on the CPU:
csm_tpu_torch.ops.quant (W8A16 backbone weights for the plain decode step)
and the bits=8 backbone step of csm_tpu_torch.ops.bb_kernel (its bundle, and
its plain version against csm_tpu.ops.bb_kernel.emulate_bb_decode_step).
The int8 kernel itself is held against the plain version on the card
(chip_smoke.py, tests/test_torch_cuda.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu.config import CSMConfig as JaxCSMConfig
from csm_tpu.models import csm as jcsm
from csm_tpu.models import llama as jllama
from csm_tpu.ops import bb_kernel as jbk
from csm_tpu.ops import quant as jquant
from csm_tpu.ops import rope as jrope
from csm_tpu_torch import CSMConfig
from csm_tpu_torch.checkpoint import params_from_jax
from csm_tpu_torch.models import llama
from csm_tpu_torch.ops import bb_kernel, quant
from csm_tpu_torch.ops.rope import compute_rope_table


@functools.lru_cache(maxsize=None)
def _models(dtype: str = "bfloat16"):
    jcfg = JaxCSMConfig.tiny()
    jp = jcsm.init_params(jax.random.key(0), jcfg, getattr(jnp, dtype))
    # Norm weights away from 1, so that folding them shows.
    rng = np.random.default_rng(0)
    layers = dict(jp["backbone"]["layers"])
    for k in ("attn_norm", "mlp_norm"):
        layers[k] = jnp.asarray(1 + 0.1 * rng.standard_normal(layers[k].shape), layers[k].dtype)
    jp = {**jp, "backbone": {**jp["backbone"], "layers": layers,
                             "final_norm": jnp.asarray(1 + 0.1 * rng.standard_normal(
                                 jp["backbone"]["final_norm"].shape), layers["attn_norm"].dtype)}}
    cfg = CSMConfig.tiny()
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu", getattr(torch, dtype))
    return jcfg, jp, cfg, tp


def test_prepare_quantized_backbone_is_bit_equal_to_jax():
    """Against the JAX function run eagerly (compiled, XLA turns the division
    by 127 into a multiplication by its reciprocal)."""
    jcfg, jp, cfg, tp = _models()
    want = jquant.prepare_quantized_backbone(jp, jcfg)
    got = quant.prepare_quantized_backbone(tp, cfg)
    assert set(got["w"]) == set(want["w"]) == {"wqkv", "wo", "w_gu", "w_down"}
    for name in want["w"]:
        np.testing.assert_array_equal(got["w"][name].numpy(), np.asarray(want["w"][name]), name)
        np.testing.assert_array_equal(got["s"][name].numpy(), np.asarray(want["s"][name]), name)


def _unpermute(x, nq: int, nkv: int, hd: int) -> np.ndarray:
    """The JAX bundle's Q/K columns back in the standard head layout."""
    perm = np.concatenate([jbk._half_perm(nq, hd), nq * hd + jbk._half_perm(nkv, hd),
                           np.arange((nq + nkv) * hd, (nq + 2 * nkv) * hd)])
    return np.asarray(x)[..., np.argsort(perm)]


def test_prepare_streamed_backbone_bits8_is_bit_equal_to_jax():
    jcfg, jp, cfg, tp = _models()
    bc = cfg.backbone
    want = jbk.prepare_streamed_backbone(jp, jcfg, bits=8)
    got = bb_kernel.prepare_streamed_backbone(tp, cfg, bits=8)
    for key in ("w", "s"):
        np.testing.assert_array_equal(
            got[key]["wqkv"].numpy(),
            _unpermute(want[key]["wqkv"], bc.num_attention_heads, bc.num_key_value_heads, bc.head_dim))
        for name in ("wo", "w_gu", "w_down", "head"):
            np.testing.assert_array_equal(got[key][name].numpy(), np.asarray(want[key][name]), name)
    np.testing.assert_array_equal(got["final_norm"].numpy(), np.asarray(want["final_norm"]))
    with pytest.raises(ValueError, match="bits must be 4, 8, or 16"):
        bb_kernel.prepare_streamed_backbone(tp, cfg, bits=5)


def _step_inputs(cfg, B: int, W: int, seed: int):
    """h0 (an embedding sum's scale), RoPE at per-stream positions, a partly
    valid window, random bf16 K/V."""
    rng = np.random.default_rng(seed)
    bc = cfg.backbone
    h0 = (rng.standard_normal((B, bc.hidden_size)) * 0.1).astype(np.float32)
    pos = W - 1 - np.arange(B)
    table = jrope.compute_rope_table(JaxCSMConfig.tiny().backbone, cfg.max_seq_len)
    cos, sin = np.asarray(table[0])[pos], np.asarray(table[1])[pos]
    bias = np.where(rng.random((B, W)) < 0.6, 0.0, -1e9).astype(np.float32)
    shape = (bc.num_hidden_layers, B, W, bc.num_key_value_heads, bc.head_dim)
    kc = np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16).astype(jnp.float32))
    vc = np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16).astype(jnp.float32))
    return h0, cos, sin, bias, kc, vc


# The plain version and the emulator compute the same f32 arithmetic in
# another order (XLA's dots and reductions against PyTorch's).  A bf16 value
# that a difference moves across a rounding boundary is one ulp apart.
# Bounds: normed hidden (f32) within 1e-4 relative RMS; new K/V and logits
# (bf16) within two ulps of the output's largest magnitude, with at most 2 %
# of the values differing at all.
BF16_ULP = 2.0 ** -8


def _misfits(got, want) -> list:
    out = []
    for name, a, w in zip(("normed_h", "c0_logits", "new_k", "new_v"), got, want):
        a = a.float().numpy()
        w = np.asarray(w, np.float32)
        assert a.shape == w.shape, name
        d = np.abs(a - w)
        if name == "normed_h":
            bad = np.sqrt((d ** 2).sum() / (w ** 2).sum()) > 1e-4
        else:
            bad = d.max() > 2 * BF16_ULP * np.abs(w).max() or (d > 0).mean() > 0.02
        if bad:
            out.append((name, float(d.max()), float((d > 0).mean())))
    return out


def _case(B: int, W: int):
    jcfg, jp, cfg, tp = _models()
    h0, cos, sin, bias, kc, vc = _step_inputs(cfg, B, W, seed=10 + B)
    jqsb = jbk.prepare_streamed_backbone(jp, jcfg, bits=8)
    emu = jax.jit(lambda q, *a: jbk.emulate_bb_decode_step(q, jcfg, *a))
    want = emu(jqsb, *(jnp.asarray(x) for x in (h0, cos, sin, bias)),
               jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16))
    qsb = bb_kernel.prepare_streamed_backbone(tp, cfg, bits=8)
    args = (qsb, cfg, *(torch.tensor(x) for x in (h0, cos, sin, bias)),
            torch.tensor(kc).bfloat16(), torch.tensor(vc).bfloat16())
    return args, want


@pytest.mark.parametrize("B,W", [(1, 8), (2, 16), (4, 24)])
def test_bb_q_reference_matches_jax_emulator(B, W):
    args, want = _case(B, W)
    assert _misfits(bb_kernel.bb_decode_step(*args), want) == []
    before = bb_kernel.bb_decode_step_q.launches
    # On a CPU tensor the wrapper is the plain version and launches nothing.
    got = bb_kernel.bb_decode_step_q(*args)
    ref = bb_kernel.bb_decode_step_q_reference(*args)
    assert all(torch.equal(a, r) for a, r in zip(got, ref))
    assert bb_kernel.bb_decode_step_q.launches == before


def test_bb_q_bound_sees_unrounded_activations():
    """Control: the plain version with f32 (not bf16) product operands breaks
    the bound."""
    args, want = _case(4, 24)
    got = bb_kernel.bb_decode_step_q_reference(*args, act=torch.float32)
    assert _misfits(got, want) != []


@pytest.mark.parametrize("B", [1, 3])
def test_llama_decode_step_with_qlayers_matches_jax(B):
    """One cached backbone step with W8A16 layers: hidden within two bf16
    ulps of the JAX package's."""
    jcfg, jp, cfg, tp = _models()
    bc = cfg.backbone
    rng = np.random.default_rng(B)
    W, S = 16, 5
    x = rng.standard_normal((B, S + 1, bc.hidden_size)).astype(np.float32) * 0.1
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    jq = jquant.prepare_quantized_backbone(jp, jcfg)
    tq = quant.prepare_quantized_backbone(tp, cfg)
    jrt = jrope.compute_rope_table(jcfg.backbone, jcfg.max_seq_len)
    jc = jllama.KVCache.create(jcfg.backbone, B, W, dtype=jnp.bfloat16)
    tc = llama.KVCache.create(bc, B, W, dtype=torch.bfloat16)
    trt = compute_rope_table(bc, cfg.max_seq_len, torch.device("cpu"))

    def jstep(xs, cache, q):
        T = xs.shape[1]
        valid = jax.lax.dynamic_update_slice(cache.valid, jnp.ones((B, T), bool), (0, cache.index))
        cache = cache.replace(valid=valid)
        pos = jnp.broadcast_to(cache.index + jnp.arange(T), (B, T))
        bias = jllama.make_causal_bias(valid, T, q_offset=cache.index)
        return jllama.forward(jp["backbone"], jcfg.backbone, jnp.asarray(xs, jnp.bfloat16),
                              rope_table=jrt, positions=pos, attn_bias=bias, cache=cache,
                              qlayers=q)

    def tstep(xs, cache, q):
        T = xs.shape[1]
        llama.write_rows(cache.valid, torch.ones((B, T), dtype=torch.bool), cache.index)
        pos = (cache.index + torch.arange(T)).expand(B, T)
        bias = llama.make_causal_bias(cache.valid, T, q_offset=cache.index)
        return llama.forward(tp["backbone"], bc, torch.tensor(xs).bfloat16(), rope_table=trt,
                             positions=pos, attn_bias=bias, cache=cache, qlayers=q)

    _, jc = jstep(x[:, :S], jc, None)
    _, tc = tstep(x[:, :S], tc, None)
    jh, _ = jstep(x[:, S:], jc, jq)
    th, _ = tstep(x[:, S:], tc, tq)
    want = np.asarray(jh, np.float32)
    got = th.float().numpy()
    assert np.abs(got - want).max() <= 2 * BF16_ULP * np.abs(want).max()
