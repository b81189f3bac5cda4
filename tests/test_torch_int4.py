"""The int4 backbone tier (bits=4) against the JAX package on the CPU: the
packing, the bundle of csm_tpu_torch.ops.bb_kernel.prepare_streamed_backbone
bit for bit, and the plain version of the int4 step against
csm_tpu.ops.bb_kernel.emulate_bb_decode_step (which stands for the Pallas
int4 kernel on the CPU, as in the JAX package's own tests).  The CUDA kernel
itself is held against the plain version on the card (chip_smoke.py,
tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu.ops import bb_kernel as jbk
from csm_tpu_torch import CSMModel
from csm_tpu_torch.models import csm
from csm_tpu_torch.models.llama import KVCache
from csm_tpu_torch.ops import bb_kernel
from tests.test_torch_quant import _misfits, _models, _step_inputs, _unpermute


def test_pack_unpack_round_trip_over_the_full_nibble_range():
    rng = np.random.default_rng(0)
    q = rng.integers(-8, 8, (3, 16, 128)).astype(np.int8)
    q[0, :2, :2] = [[-8, 7], [7, -8]]
    p = bb_kernel.pack_int4_rows(torch.from_numpy(q))
    assert p.shape == (3, 8, 128) and p.dtype == torch.int8
    np.testing.assert_array_equal(p.numpy(), np.asarray(jbk.pack_int4_rows(jnp.asarray(q))))
    np.testing.assert_array_equal(bb_kernel.unpack_int4_rows(p).numpy(), q)
    # Byte row i is (q[2i+1] << 4) | (q[2i] & 0xF).
    b = p.numpy().view(np.uint8).astype(np.int32)
    qi = q.astype(np.int32)
    np.testing.assert_array_equal(b, ((qi[:, 1::2] & 0xF) << 4) | (qi[:, 0::2] & 0xF))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prepare_streamed_backbone_bits4_is_bit_equal_to_jax(dtype):
    """Against the JAX function run eagerly; the JAX bundle's Q/K columns are
    permuted into rotary-half order (a TPU layout), so they are put back.
    ``u`` is per input row and does not see the permutation."""
    jcfg, jp, cfg, tp = _models(dtype)
    bc = cfg.backbone
    want = jbk.prepare_streamed_backbone(jp, jcfg, bits=4)
    got = bb_kernel.prepare_streamed_backbone(tp, cfg, bits=4)
    assert set(got) == {"w", "s", "u", "final_norm"}
    assert got["w"]["wqkv"].shape[1] == bc.hidden_size // 2
    heads = (bc.num_attention_heads, bc.num_key_value_heads, bc.head_dim)
    # Unpacked before the column permutation (a byte holds one column).
    np.testing.assert_array_equal(
        bb_kernel.unpack_int4_rows(got["w"]["wqkv"]).numpy(),
        _unpermute(jbk.unpack_int4_rows(want["w"]["wqkv"]), *heads))
    np.testing.assert_array_equal(got["s"]["wqkv"].numpy(), _unpermute(want["s"]["wqkv"], *heads))
    for name in ("wo", "w_gu", "w_down", "head"):
        for key in ("w", "s"):
            np.testing.assert_array_equal(got[key][name].numpy(), np.asarray(want[key][name]),
                                          f"{key}/{name}")
    for name in ("wqkv", "wo", "w_gu", "w_down"):
        np.testing.assert_array_equal(got["u"][name].numpy(), np.asarray(want["u"][name]), name)
    np.testing.assert_array_equal(got["final_norm"].numpy(), np.asarray(want["final_norm"]))


def _case(B: int, W: int):
    jcfg, jp, cfg, tp = _models()
    h0, cos, sin, bias, kc, vc = _step_inputs(cfg, B, W, seed=30 + B)
    jqsb = jbk.prepare_streamed_backbone(jp, jcfg, bits=4)
    emu = jax.jit(lambda q, *a: jbk.emulate_bb_decode_step(q, jcfg, *a))
    want = emu(jqsb, *(jnp.asarray(x) for x in (h0, cos, sin, bias)),
               jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16))
    qsb = bb_kernel.prepare_streamed_backbone(tp, cfg, bits=4)
    args = (qsb, cfg, *(torch.tensor(x) for x in (h0, cos, sin, bias)),
            torch.tensor(kc).bfloat16(), torch.tensor(vc).bfloat16())
    return args, want


@pytest.mark.parametrize("B,W", [(1, 8), (2, 16), (4, 24)])
def test_bb_q4_reference_matches_jax_emulator(B, W):
    """Same bounds as the int8 tier (tests/test_torch_quant.py): logits and
    K/V rows within two bf16 ulps of the output's largest magnitude with at
    most 2 % of values differing, the f32 normed hidden within 1e-4 relative
    RMS; the window is partly valid."""
    args, want = _case(B, W)
    before = bb_kernel.bb_decode_step_q4.launches
    got = bb_kernel.bb_decode_step(*args)
    assert _misfits(got, want) == []
    # On a CPU tensor the wrapper is the plain version and launches nothing.
    ref = bb_kernel.bb_decode_step_q_reference(*args)
    assert all(torch.equal(a, r) for a, r in zip(bb_kernel.bb_decode_step_q4(*args), ref))
    assert bb_kernel.bb_decode_step_q4.launches == before
    with pytest.raises(ValueError, match="int8 bundle"):
        bb_kernel.bb_decode_step_q(*args)


@pytest.mark.parametrize("fault", ["no prescale", "f32 operands"])
def test_bb_q4_bound_sees_a_faulty_version(fault):
    """Controls: the plain version without the ``u`` prescale, or with f32
    (not bf16) product operands, breaks the bound."""
    args, want = _case(4, 24)
    kw = dict(prescale=False) if fault == "no prescale" else dict(act=torch.float32)
    assert _misfits(bb_kernel.bb_decode_step_q_reference(*args, **kw), want) != []


def test_int4_step_tracks_the_plain_bf16_step():
    """One cached decode step through the int4 tier against the plain bf16
    backbone: normed hidden within 0.15 of its largest magnitude, the JAX
    package's int4 budget (tests/test_bb_kernel.py)."""
    jcfg, jp, cfg, tp = _models()
    bc = cfg.backbone
    B, W, fill = 2, 16, 8
    rng = np.random.default_rng(7)
    ids = np.zeros((B, 1, cfg.frame_width), np.int64)
    ids[..., :-1] = rng.integers(1, cfg.audio_vocab_size, (B, 1, 32))
    mask = np.zeros((B, 1, cfg.frame_width), np.float32)
    mask[..., :-1] = 1.0
    kv = rng.standard_normal((2, bc.num_hidden_layers, B, fill, bc.num_key_value_heads,
                              bc.head_dim))

    def cache():
        c = KVCache.create(bc, B, W, dtype=torch.bfloat16)
        c.k[:, :, :fill] = torch.tensor(kv[0]).bfloat16()
        c.v[:, :, :fill] = torch.tensor(kv[1]).bfloat16()
        c.valid[:, :fill] = True
        c.index = fill
        return c

    qsb = bb_kernel.prepare_streamed_backbone(tp, cfg, bits=4)
    x = (torch.tensor(ids), torch.tensor(mask))
    ref = csm.forward(tp, cfg, *x, cache=cache())
    out = csm.forward(tp, cfg, *x, cache=cache(), qsb=qsb)
    ref_h = ref.last_hidden_state.double()
    diff = (out.last_hidden_state.double() - ref_h).abs().max() / ref_h.abs().max()
    assert diff < 0.15, diff
    assert out.cache.index == fill + 1


def test_quantize_bits4_generates_end_to_end(monkeypatch):
    """``CSMModel(device="cpu").quantize(bits=4).generate``: every frame after
    the first takes the int4 step (its plain version on the CPU), tokens are
    in range and the run is deterministic."""
    jcfg, jp, cfg, tp = _models()
    model = CSMModel(cfg, tp, dtype=torch.bfloat16, device="cpu").quantize(bits=4)
    assert "u" in model._qsb and model._qdec is not None and model._qbb is not None
    seen = []
    plain = bb_kernel.bb_decode_step_q_reference

    def counted(qsb, *a, **k):
        seen.append("u" in qsb)
        return plain(qsb, *a, **k)

    monkeypatch.setattr(bb_kernel, "bb_decode_step_q_reference", counted)
    rng = np.random.default_rng(3)
    B, S, F = 2, 7, 4
    ids = np.zeros((B, S, cfg.frame_width), np.int64)
    ids[..., :-1] = rng.integers(1, cfg.audio_vocab_size, (B, S, 32))
    mask = np.zeros((B, S, cfg.frame_width), np.float32)
    mask[..., :-1] = 1.0
    kw = dict(max_new_frames=F, greedy=True, stop_on_all_zeros=False)
    a = model.generate(ids, mask, **kw)
    assert seen == [True] * (F - 1)
    b = model.generate(ids, mask, **kw)
    assert a.shape == (B, F, cfg.audio_num_codebooks)
    assert 0 <= a.min() and a.max() < cfg.audio_vocab_size
    np.testing.assert_array_equal(a, b)
