"""The port's CUDA kernels on the card, held against their plain versions at
a small config whose head_dim is the kernels' 64.  Every test here is
marked ``gpu`` and skips on a host without a CUDA device.  On the GPU host
(which has no JAX, so tests/conftest.py is left out):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

chip_smoke.py holds the same kernels at full CSM-1B width.
"""

import numpy as np
import pytest
import torch

from csm_tpu_torch import CSMConfig, CSMModel
from csm_tpu_torch.config import LlamaConfig
from csm_tpu_torch.models import csm
import torch.nn.functional as F

from csm_tpu_torch.ops import bb_kernel
from csm_tpu_torch.ops import fused_decoder as fd
from csm_tpu_torch.ops import flash_attention as fa
from csm_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_reference,
    flash_bwd,
    flash_fwd,
)
from csm_tpu_torch.train import make_optimizer, make_train_step
from csm_tpu_torch.train.loop import flatten

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _config() -> CSMConfig:
    """Small, with head_dim 64 in both stacks."""
    return CSMConfig.tiny(
        backbone=LlamaConfig(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2,
                             max_position_embeddings=64),
        decoder=LlamaConfig(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                            num_attention_heads=2, num_key_value_heads=1,
                            max_position_embeddings=32),
    )


# bf16: outputs of magnitude ~1 rounded to bf16, and the kernel rounds
# unnormalised probabilities where the plain version rounds normalised ones;
# fp32: only the order of the fp32 sums differs.
@pytest.mark.parametrize("dtype,hd,tol", [
    (torch.bfloat16, 64, 2e-2), (torch.bfloat16, 32, 2e-2),
    (torch.float32, 64, 5e-5), (torch.float32, 16, 5e-5),
])
@pytest.mark.parametrize("nq,nkv", [(4, 4), (4, 2), (8, 2)])
def test_flash_kernel_matches_plain_version(cuda, nq, nkv, dtype, hd, tol):
    """Live rows within ``tol``; dead rows finite."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    B, S, T = 3, 100, 128
    q = torch.randn((B, S, nq, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, T, nkv, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, T, nkv, hd), generator=gen, device=cuda).to(dtype)
    valid = torch.zeros((B, T), dtype=torch.int32, device=cuda)
    for b in range(B):
        valid[b, 7 * b:S] = 1
    before = flash_fwd.launches
    out = flash_attention(q, k, v, valid)
    ref = flash_attention_reference(q, k, v, valid)
    torch.cuda.synchronize()
    assert flash_fwd.launches == before + 1
    assert out.dtype == dtype
    for b in range(B):
        err = (out[b, 7 * b:].float() - ref[b, 7 * b:].float()).abs().max().item()
        assert err <= tol, (b, err)
    assert torch.isfinite(out.float()).all()


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("W", [40, 1, 37])
def test_bb_kernel_matches_plain_version(cuda, B, W):
    """Same rounding points, other fp32 summation order: relative RMS error
    within 1e-2 on every output at two layers (a wrong mask, head or position
    gives 0.1-1; chip_smoke.py holds the kernel to finer limits at full
    width), at a window of 40 keys, of one key and a ragged 37; bitwise
    repeatable, and the same for a stream alone as in its batch."""
    cfg = _config()
    model = CSMModel(cfg, dtype=torch.bfloat16, seed=1, device=cuda).exact()
    bc = cfg.backbone
    gen = torch.Generator(device=cuda).manual_seed(B)
    h0 = (0.1 * torch.randn((B, bc.hidden_size), generator=gen, device=cuda)).bfloat16().float()
    cos = torch.randn((B, bc.head_dim), generator=gen, device=cuda)
    sin = torch.randn((B, bc.head_dim), generator=gen, device=cuda)
    bias = torch.where(torch.rand((B, W), generator=gen, device=cuda) < 0.6, 0.0, -1e9)
    shape = (bc.num_hidden_layers, B, W, bc.num_key_value_heads, bc.head_dim)
    kc = torch.randn(shape, generator=gen, device=cuda).bfloat16()
    vc = torch.randn(shape, generator=gen, device=cuda).bfloat16()
    args = (model._qsb, cfg, h0, cos, sin, bias.float(), kc, vc)
    before = bb_kernel.bb_decode_step.launches
    out = bb_kernel.bb_decode_step(*args)
    ref = bb_kernel.bb_decode_step_reference(*args)
    torch.cuda.synchronize()
    assert bb_kernel.bb_decode_step.launches == before + 1
    for name, a, r in zip(("normed_h", "c0_logits", "new_k", "new_v"), out, ref):
        a, r = a.float(), r.float()
        assert a.shape == r.shape and torch.isfinite(a).all(), name
        assert ((a - r).norm() / r.norm()).item() <= 1e-2, name
    _bbq_repeat_and_solo(bb_kernel.bb_decode_step, args, out)


def _rel_rms(a, r) -> float:
    return ((a.float() - r.float()).norm() / r.float().norm()).item()


def _bbq_config(name: str) -> CSMConfig:
    """``small`` is :func:`_config`; ``hd32`` has head_dim 32 and 8/2 heads
    (3 QKV tiles of 4 heads each)."""
    if name == "small":
        return _config()
    return CSMConfig.tiny(
        backbone=LlamaConfig(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                             num_attention_heads=8, num_key_value_heads=2,
                             max_position_embeddings=64),
        decoder=LlamaConfig(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                            num_attention_heads=2, num_key_value_heads=1,
                            max_position_embeddings=32),
    )


def _bbq_inputs(cfg, B: int, W: int, seed: int, dev):
    bc = cfg.backbone
    gen = torch.Generator(device=dev).manual_seed(seed)
    h0 = (0.1 * torch.randn((B, bc.hidden_size), generator=gen, device=dev)).bfloat16().float()
    cos = torch.randn((B, bc.head_dim), generator=gen, device=dev)
    sin = torch.randn((B, bc.head_dim), generator=gen, device=dev)
    bias = torch.where(torch.rand((B, W), generator=gen, device=dev) < 0.6, 0.0, -1e9).float()
    shape = (bc.num_hidden_layers, B, W, bc.num_key_value_heads, bc.head_dim)
    kc = torch.randn(shape, generator=gen, device=dev).bfloat16()
    vc = torch.randn(shape, generator=gen, device=dev).bfloat16()
    return h0, cos, sin, bias, kc, vc


def _bbq_misfit(got, want) -> bool:
    """The K1q one-layer limits: the f32 normed hidden within 2e-3 relative
    RMS, at most 10 % of the logits and 2 % of the new K/V rows one bf16
    rounding apart."""
    return (_rel_rms(got[0], want[0]) > 2e-3 or (got[1] != want[1]).float().mean() > 0.1
            or any((a != r).float().mean() > 0.02 for a, r in zip(got[2:], want[2:])))


def _bbq_repeat_and_solo(kernel, args, out) -> None:
    """A second launch bitwise equal to ``out``; stream 0 alone bitwise equal
    to stream 0 of the batch (the K splits are fixed by the shapes)."""
    qsb, cfg, h0, cos, sin, bias, kc, vc = args
    for a, b in zip(out, kernel(*args)):
        assert torch.equal(a, b)
    solo = kernel(qsb, cfg, h0[:1], cos[:1], sin[:1], bias[:1], kc[:, :1], vc[:, :1])
    for i, (a, one) in enumerate(zip(out, solo)):
        assert torch.equal(a[:, :1] if i >= 2 else a[:1], one), i


# The K1q cases: the small config at a window of 40 keys, of one key and a
# ragged 37, and a config with head_dim 32.
BBQ_CASES = [("small", 40), ("small", 1), ("small", 37), ("hd32", 37)]


@pytest.mark.parametrize("B", [1, 3, 8, 32])
@pytest.mark.parametrize("cfg_name,W", BBQ_CASES)
def test_bb_q_kernel_matches_plain_version(cuda, cfg_name, W, B):
    """The int8 step: same f32 arithmetic in another summation order, so the
    f32 normed hidden within 1e-3 relative RMS and at most 2 % (K/V) and
    10 % (logits) of the bf16 values one rounding apart; bitwise repeatable
    and the same for a stream alone as in its batch."""
    cfg = _bbq_config(cfg_name)
    model = CSMModel(cfg, dtype=torch.bfloat16, seed=1, device=cuda)
    qsb = bb_kernel.prepare_streamed_backbone(model.params, cfg, bits=8)
    args = (qsb, cfg, *_bbq_inputs(cfg, B, W, B, cuda))
    before = bb_kernel.bb_decode_step_q.launches
    out = bb_kernel.bb_decode_step(*args)
    ref = bb_kernel.bb_decode_step_q_reference(*args)
    torch.cuda.synchronize()
    assert bb_kernel.bb_decode_step_q.launches == before + 1
    for a, r in zip(out, ref):
        assert a.shape == r.shape and torch.isfinite(a.float()).all()
    assert _rel_rms(out[0], ref[0]) <= 1e-3
    assert (out[1] != ref[1]).float().mean().item() <= 0.1
    for a, r in zip(out[2:], ref[2:]):
        assert (a != r).float().mean().item() <= 0.02
    _bbq_repeat_and_solo(bb_kernel.bb_decode_step_q, args, out)


def _one_layer(qsb: dict, l: int) -> dict:
    """A quantized bundle holding only layer ``l`` of its stacked weights."""
    out = dict(qsb)
    for part in ("w", "s", "u"):
        if part in qsb:
            out[part] = {k: (v if k == "head" else v[l:l + 1]) for k, v in qsb[part].items()}
    return out


@pytest.mark.parametrize("B", [1, 3, 8, 32])
@pytest.mark.parametrize("cfg_name,W", BBQ_CASES)
def test_bb_q4_kernel_matches_plain_version_one_layer_at_a_time(cuda, cfg_name, W, B):
    """The int4 step: the full step within 5e-2 relative RMS (a gross gate:
    flipped bf16 roundings carry on through the layers); each layer alone,
    fed the plain version's residual, within the one-layer limits
    (:func:`_bbq_misfit`).  The plain version without the ``u`` prescale
    breaks the one-layer limits.  Bitwise repeatable, and the same for a
    stream alone as in its batch."""
    cfg = _bbq_config(cfg_name)
    model = CSMModel(cfg, dtype=torch.bfloat16, seed=1, device=cuda)
    qsb = bb_kernel.prepare_streamed_backbone(model.params, cfg, bits=4)
    h0, cos, sin, bias, kc, vc = _bbq_inputs(cfg, B, W, B, cuda)
    args = (qsb, cfg, h0, cos, sin, bias, kc, vc)
    before = bb_kernel.bb_decode_step_q4.launches
    out = bb_kernel.bb_decode_step(*args)
    ref = bb_kernel.bb_decode_step_q_reference(*args)
    torch.cuda.synchronize()
    assert bb_kernel.bb_decode_step_q4.launches == before + 1
    for a, r in zip(out, ref):
        assert a.shape == r.shape and torch.isfinite(a.float()).all()
    assert _rel_rms(out[0], ref[0]) <= 5e-2 and _rel_rms(out[1], ref[1]) <= 5e-2
    _bbq_repeat_and_solo(bb_kernel.bb_decode_step_q4, args, out)

    h, control_broke = h0, False
    for l in range(cfg.backbone.num_hidden_layers):
        a1 = (_one_layer(qsb, l), cfg, h, cos, sin, bias, kc[l:l + 1], vc[l:l + 1])
        r1 = bb_kernel.bb_decode_step_q_reference(*a1)
        assert not _bbq_misfit(bb_kernel.bb_decode_step_q4(*a1), r1), l
        control_broke |= _bbq_misfit(bb_kernel.bb_decode_step_q_reference(*a1, prescale=False), r1)
        h, _, _ = bb_kernel.bbq_layer_reference(qsb, cfg, l, h, cos, sin, bias, kc[l], vc[l])
    assert control_broke


def test_int4_server_runs_the_kernels_and_streams_audio(cuda):
    """A CSMServer on quantize(bits=4)'s bundles with a tiny codec: K1q-4
    for every frame step, K2 for every frame, each request's streamed PCM
    equal to the offline decode of its frames."""
    from csm_tpu_torch.codec import MimiCodec, MimiCodecConfig, random_mimi_params
    from csm_tpu_torch.serving import CSMServer

    torch.backends.cudnn.allow_tf32 = False  # fp32 convolutions, as offline decode runs them
    cfg = _config()
    model = CSMModel(cfg, dtype=torch.bfloat16, seed=2, device=cuda).quantize(bits=4)
    ccfg = MimiCodecConfig.tiny(num_quantizers=cfg.audio_num_codebooks)
    codec = MimiCodec(ccfg, random_mimi_params(ccfg, seed=1), device=cuda)
    server = CSMServer(model.params, cfg, n_slots=2, window=64, temperature=0.8, topk=5,
                       stop_on_all_zeros=False, max_new_frames=3, qdec=model._qdec,
                       qbb=model._qbb, qsb=model._qsb, codec=codec)
    rng = np.random.default_rng(3)
    bb_kernel.bb_decode_step_q4.launches = fd.fused_decode_codebooks.launches = 0
    rids = []
    for S in (5, 9, 7):
        ids = np.zeros((1, S, cfg.frame_width), np.int64)
        ids[..., :32] = rng.integers(1, cfg.audio_vocab_size, (1, S, 32))
        rids.append(server.submit(ids, (ids > 0).astype(np.float32), greedy=S == 9))
    server.run_until_idle()
    assert bb_kernel.bb_decode_step_q4.launches > 0 and fd.fused_decode_codebooks.launches > 0
    hop = 2 * ccfg.total_stride
    for rid in rids:
        frames = server.results[rid]
        assert frames.shape == (3, 32) and server.audio[rid].shape == (3 * hop,)
        np.testing.assert_allclose(server.audio[rid], codec.decode(frames.T), rtol=1e-3,
                                   atol=1e-4)


@pytest.mark.parametrize("head_bits", [16, 8])
@pytest.mark.parametrize("B", [1, 3, 32])
def test_fused_kernel_matches_plain_version_teacher_forced(cuda, B, head_bits):
    """Forced onto the plain version's tokens: at most 5 % of the kernel's
    bf16 logits one rounding apart from the plain version's (relative RMS
    within 5e-3), the forced tokens returned, and every draw before forcing
    equal to the plain sampler on the kernel's own logits, greedy and
    sampled."""
    cfg = _config()
    model = CSMModel(cfg, dtype=torch.bfloat16, seed=3, device=cuda)
    qdec = fd.prepare_fused_decoder(model.params, cfg, head_bits=head_bits)
    gen = torch.Generator(device=cuda).manual_seed(B)
    N, Va = cfg.audio_num_codebooks, cfg.audio_vocab_size
    last_h = torch.randn((B, cfg.backbone.hidden_size), generator=gen, device=cuda).bfloat16()
    x0 = (last_h @ model.params["projection"]).float()
    c0 = (last_h @ model.params["codebook0_head"]).float()
    temp = torch.full((B,), 0.8, device=cuda)
    topk = torch.full((B,), 5, dtype=torch.int32, device=cuda)
    for greedy in (True, False):
        gum = fd.build_frame_gumbel(cfg, gen, B, greedy, cuda)
        args = (qdec, cfg, x0, c0, gum, temp, topk, greedy)
        forced = fd.decode_codebooks_reference(*args, torch.full((B, N), -1, device=cuda))[0]
        _, ref_lg, _ = fd.decode_codebooks_reference(*args, forced)
        before = fd.fused_decode_codebooks.launches
        samples, lg, draws = fd.fused_decode_codebooks(*args, forced=forced, return_logits=True)
        torch.cuda.synchronize()
        assert fd.fused_decode_codebooks.launches == before + 1
        assert torch.equal(samples, forced)
        a, r = lg[..., :Va], ref_lg[..., :Va]
        assert torch.isfinite(a).all()
        assert (a != r).float().mean().item() <= 0.05 and _rel_rms(a, r) <= 5e-3
        gp = F.pad(gum, (0, lg.shape[-1] - Va))
        mine = torch.stack([fd.sample_row(lg[i], gp[i], temp[:, None], topk[:, None], greedy)
                            for i in range(N)], dim=1)
        assert torch.equal(mine, draws)


def test_quantize_and_exact_generate_run_the_kernels(cuda):
    """quantize(): one int8 backbone launch for each frame after the first
    and one fused-decoder launch per frame; exact(): the exact backbone
    kernel and at least one draft launch per frame."""
    cfg = _config()
    model = CSMModel(cfg, dtype=torch.bfloat16, seed=2, device=cuda)
    rng = np.random.default_rng(1)
    ids = np.zeros((3, 12, cfg.frame_width), np.int64)
    ids[..., :32] = rng.integers(1, cfg.audio_vocab_size, (3, 12, 32))
    mask = (ids > 0).astype(np.float32)
    kw = dict(max_new_frames=4, greedy=True, stop_on_all_zeros=False)
    fd.fused_decode_codebooks.launches = 0
    bb_kernel.bb_decode_step.launches = bb_kernel.bb_decode_step_q.launches = 0
    quantized = model.quantize().generate(ids, mask, **kw)
    assert bb_kernel.bb_decode_step_q.launches == 3 and fd.fused_decode_codebooks.launches == 4
    fd.fused_decode_codebooks.launches = 0
    exact = model.exact().generate(ids, mask, **kw)
    assert bb_kernel.bb_decode_step.launches == 3 and fd.fused_decode_codebooks.launches >= 4
    for frames in (quantized, exact):
        assert frames.shape == (3, 4, 32)
        assert 0 <= frames.min() and frames.max() < cfg.audio_vocab_size


def test_generate_runs_both_kernels(cuda):
    """Plain generation runs the flash kernel on the prefill; exact() adds
    one backbone-kernel launch for each frame after the first."""
    cfg = _config()
    model = CSMModel(cfg, dtype=torch.bfloat16, seed=2, device=cuda)
    rng = np.random.default_rng(0)
    ids = np.zeros((2, 12, cfg.frame_width), np.int64)
    ids[..., :32] = rng.integers(1, cfg.audio_vocab_size, (2, 12, 32))
    mask = (ids > 0).astype(np.float32)
    kw = dict(max_new_frames=5, greedy=True, stop_on_all_zeros=False)
    flash_fwd.launches = bb_kernel.bb_decode_step.launches = 0
    plain = model.generate(ids, mask, **kw)
    assert flash_fwd.launches == cfg.backbone.num_hidden_layers
    assert bb_kernel.bb_decode_step.launches == 0
    exact = model.exact().generate(ids, mask, **kw)
    assert bb_kernel.bb_decode_step.launches == 4
    for frames in (plain, exact):
        assert frames.shape == (2, 5, 32)
        assert 0 <= frames.min() and frames.max() < cfg.audio_vocab_size


def test_fp32_prefill_runs_the_flash_kernel(cuda):
    """The default fp32 model takes the flash kernel on its prefill too."""
    cfg = _config()
    model = CSMModel(cfg, seed=2, device=cuda)
    ids = np.zeros((1, 12, cfg.frame_width), np.int64)
    ids[..., :32] = np.random.default_rng(1).integers(1, cfg.audio_vocab_size, (1, 12, 32))
    flash_fwd.launches = 0
    frames = model.generate(ids, (ids > 0).astype(np.float32), max_new_frames=2, greedy=True,
                            stop_on_all_zeros=False)
    assert flash_fwd.launches == cfg.backbone.num_hidden_layers
    assert frames.shape == (1, 2, 32)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 8, 4, 40), dtype=torch.bfloat16, device=cuda)
    valid = torch.ones((1, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q[:, :, :2], q[:, :, :2], valid)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q.half(), q[:, :, :2].half(), q[:, :, :2].half(), valid)
    cfg = _config()
    model = CSMModel(cfg, dtype=torch.bfloat16, device=cuda).exact()
    bc = cfg.backbone
    B = bb_kernel.MAX_VALIDATED_B_EXACT + 1
    h0 = torch.zeros((B, bc.hidden_size), device=cuda)
    rope = torch.zeros((B, bc.head_dim), device=cuda)
    cache = torch.zeros((bc.num_hidden_layers, B, 8, bc.num_key_value_heads, bc.head_dim),
                        dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="unsupported B"):
        bb_kernel.bb_decode_step(model._qsb, cfg, h0, rope, rope,
                                 torch.zeros((B, 8), device=cuda), cache, cache)


# The backward kernels against the plain FA2 backward on the same forward
# output and log-sum-exp (the kernel's own): fp32 differs in the order of the
# fp32 sums only; bf16 also rounds dS and P to bf16 where the plain version
# does, and a summation-order flip of one such rounding moves a gradient
# element by one bf16 step.
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,hd", [
    (torch.bfloat16, 64), (torch.bfloat16, 16), (torch.float32, 64), (torch.float32, 32),
])
@pytest.mark.parametrize("nq,nkv", [(4, 4), (4, 2), (8, 2)])
def test_flash_backward_kernels_match_plain_version(cuda, nq, nkv, dtype, hd, causal):
    """Relative RMS of dq / dk / dv within ``BWD_TOL``; the kernel's lse on
    live rows within 1e-5; dead rows (row b's first 7b keys invalid) get
    exactly zero dq and contribute nothing to dk / dv; two runs are bitwise
    equal."""
    gen = torch.Generator(device=cuda).manual_seed(hd + nq)
    B, S = 3, 100
    q, do = (torch.randn((B, S, nq, hd), generator=gen, device=cuda).to(dtype) for _ in range(2))
    k, v = (torch.randn((B, S, nkv, hd), generator=gen, device=cuda).to(dtype) for _ in range(2))
    valid = torch.ones((B, S), dtype=torch.int32, device=cuda)
    for b in range(B):
        valid[b, :7 * b] = 0
    out, lse = flash_fwd(q, k, v, valid, causal, with_lse=True)
    ref_out, ref_lse = flash_attention_reference(q, k, v, valid, causal, return_lse=True)
    live = torch.ones((B, S), dtype=torch.bool, device=cuda)
    if causal:
        live = valid.cumsum(1) > 0
    err = (lse - ref_lse).abs().transpose(1, 2)[live].max().item()
    assert err <= 1e-5 * max(1.0, ref_lse.abs().max().item()), err
    if causal:
        assert (lse.transpose(1, 2)[~live] == fa.NEG_INF).all()
    before = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    got = flash_bwd(q, k, v, valid, out, lse, do, causal)
    again = flash_bwd(q, k, v, valid, out, lse, do, causal)
    want = flash_attention_bwd_reference(q, k, v, valid, out, lse, do, causal)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == (before[0] + 2, before[1] + 2)
    for name, a, w, a2 in zip(("dq", "dk", "dv"), got, want, again):
        assert a.dtype == dtype and a.shape == w.shape, name
        assert torch.equal(a, a2), name
        assert _rel_rms(a, w) <= BWD_TOL[dtype], (name, _rel_rms(a, w))
    if causal:
        assert (got[0][~live] == 0).all()
        masked = do * live[:, :, None, None].to(dtype)
        dead_free = flash_bwd(q, k, v, valid, out, lse, masked, causal)
        for a, w in zip(got[1:], dead_free[1:]):
            assert torch.equal(a, w)


def _train_batch(cfg, accum, B, S, seed):
    from oracle import random_csm_batch

    d = random_csm_batch(cfg, accum * B, S, seed=seed)
    return {k: torch.as_tensor(v.reshape(accum, B, S, -1), device="cuda") for k, v in d.items()}


def test_frozen_wq_gradient_reaches_wv(cuda):
    """With ``wq`` frozen and ``wv`` and the embeddings training, the
    gradient flows through the flash kernels (forward with LSE, both backward
    kernels) and equals the plain attention path's (fp32: summation order
    only)."""
    cfg = _config()
    base = CSMModel(cfg, seed=4, device=cuda).params
    batch = _train_batch(cfg, 1, 2, 48, seed=9)
    grads = {}
    for use_flash in (True, False):
        params = {k: (v.detach().clone().requires_grad_(True) if torch.is_tensor(v) else v)
                  for k, v in base.items()}
        for stack in ("backbone", "decoder"):
            layers = {k: v.detach().clone().requires_grad_(k == "wv")
                      for k, v in base[stack]["layers"].items()}
            params[stack] = {"layers": layers, "final_norm": base[stack]["final_norm"]}
        counts = (flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
        out = csm.forward(params, cfg, batch["input_ids"][0], batch["attention_mask"][0],
                          labels=batch["labels"][0], max_decoder_frames=24, use_flash=use_flash)
        out.loss.backward()
        new = (flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
        L = cfg.backbone.num_hidden_layers
        assert [n - c for n, c in zip(new, counts)] == ([L, L, L] if use_flash else [0, 0, 0])
        grads[use_flash] = {"wv": params["backbone"]["layers"]["wv"].grad,
                            "audio_embeddings": params["audio_embeddings"].grad}
    for name in ("wv", "audio_embeddings"):
        a, w = grads[True][name], grads[False][name]
        assert a is not None and a.abs().sum() > 0, name
        assert _rel_rms(a, w) <= 1e-4, (name, _rel_rms(a, w))


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_train_step_with_the_kernels_matches_plain_attention(cuda, policy):
    """A tiny fp32 train step (accum 2, B 2) through the flash kernels and
    through plain attention: the same losses and grad norm (rtol 1e-4) and
    gradients (relative RMS 1e-4); K3 runs twice per layer and microbatch
    under ``"nothing"``, once under ``"dots"``, K5a / K5b once."""
    cfg = _config()
    batch = _train_batch(cfg, 2, 2, 48, seed=11)
    res = {}
    for use_flash in (True, False):
        opt = make_optimizer(1e-3, 4)
        state = opt.init(CSMModel(cfg, seed=5, device=cuda).params)
        step = make_train_step(cfg, opt, 24, remat=True, remat_policy=policy,
                               use_flash=use_flash)
        flash_fwd.launches = fa.flash_bwd_dq.launches = fa.flash_bwd_dkv.launches = 0
        state, m = step(state, None, batch)
        torch.cuda.synchronize()
        res[use_flash] = (m, {k: p.grad.clone() for k, p in flatten(state.params).items()},
                          (flash_fwd.launches, fa.flash_bwd_dq.launches,
                           fa.flash_bwd_dkv.launches))
    L = cfg.backbone.num_hidden_layers
    fwd = {"nothing": 2, "dots": 1}[policy]
    assert res[True][2] == (2 * L * fwd, 2 * L, 2 * L)
    assert res[False][2] == (0, 0, 0)
    for k in ("loss", "backbone_loss", "decoder_loss", "grad_norm"):
        a, w = float(res[True][0][k]), float(res[False][0][k])
        assert np.isfinite(a) and abs(a - w) <= 1e-4 * abs(w), (k, a, w)
    for k, g in res[True][1].items():
        assert _rel_rms(g, res[False][1][k]) <= 1e-4, k


# ---------------------------------------------------------------------------
# q_offset (sequence parallelism)
# ---------------------------------------------------------------------------


def _poison_allocator(like: torch.Tensor) -> None:
    """Leave NaN-filled blocks of ``like``'s size in the caching allocator,
    so that an output the kernel fails to write shows up."""
    for _ in range(4):
        torch.full_like(like, float("nan"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shards", [2, 4])
def test_q_offset_kernels_match_the_unsharded_kernels(cuda, dtype, shards):
    """Each query shard at ``q_offset = shard * S_local`` over the whole
    K / V: K3's output on live rows and its lse, and K5a's dq, bitwise equal
    to the unsharded launches' rows; K5b's dk / dv summed over the shards
    within ``BWD_TOL`` of the unsharded ones, and exactly zero for the key
    blocks after the shard's last row (written, not left as garbage)."""
    gen = torch.Generator(device=cuda).manual_seed(shards)
    B, S, nq, nkv, hd = 2, 256, 8, 2, 64
    q, do = (torch.randn((B, S, nq, hd), generator=gen, device=cuda).to(dtype) for _ in range(2))
    k, v = (torch.randn((B, S, nkv, hd), generator=gen, device=cuda).to(dtype) for _ in range(2))
    valid = torch.ones((B, S), dtype=torch.int32, device=cuda)
    valid[1, :70] = 0
    live = valid.cumsum(1) > 0
    out, lse = flash_fwd(q, k, v, valid, True, with_lse=True)
    dq, dk, dv = flash_bwd(q, k, v, valid, out, lse, do)
    Sl = S // shards
    dk_sum, dv_sum = torch.zeros_like(dk, dtype=torch.float32), torch.zeros_like(dv, dtype=torch.float32)
    for s in range(shards):
        sl = slice(s * Sl, (s + 1) * Sl)
        o, l = flash_fwd(q[:, sl], k, v, valid, True, with_lse=True, q_offset=s * Sl)
        assert torch.equal(o[live[:, sl]], out[:, sl][live[:, sl]]), s
        assert torch.equal(l, lse[..., sl]), s
        _poison_allocator(dk)
        g = flash_bwd(q[:, sl], k, v, valid, o, l, do[:, sl], True, s * Sl)
        torch.cuda.synchronize()
        assert torch.equal(g[0], dq[:, sl]), s
        first_unseen = -(-(s + 1) * Sl // 64) * 64  # key blocks past the shard's last row
        assert (g[1][:, first_unseen:] == 0).all() and (g[2][:, first_unseen:] == 0).all(), s
        dk_sum += g[1].float()
        dv_sum += g[2].float()
    assert _rel_rms(dk_sum, dk) <= BWD_TOL[dtype] and _rel_rms(dv_sum, dv) <= BWD_TOL[dtype]
    # Control: shard 1 at offset 0 is another function.
    o, _ = flash_fwd(q[:, Sl:2 * Sl], k, v, valid, True, with_lse=True)
    assert not torch.equal(o, out[:, Sl:2 * Sl])


def _sp_train_rank(seed):
    """One rank of a data=1 x seq=2 mesh on the shared card: one train step
    through flash_attention_sp, its metrics, launches, parameters and the
    gradients the update used."""
    from csm_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _config()
    mesh = make_mesh(data=1, seq=2)
    batch = _train_batch(cfg, 1, 2, 64, seed=seed)
    opt = make_optimizer(1e-3, 4)
    state = opt.init(CSMModel(cfg, seed=5, device="cuda").params)
    step = make_train_step(cfg, opt, 24, remat=True, remat_policy="dots", mesh=mesh)
    flash_fwd.launches = fa.flash_bwd_dq.launches = fa.flash_bwd_dkv.launches = 0
    state, m = step(state, None, batch)
    torch.cuda.synchronize()
    return dict(metrics={k: float(v) for k, v in m.items()},
                launches=(flash_fwd.launches, fa.flash_bwd_dq.launches,
                          fa.flash_bwd_dkv.launches),
                params={k: p.detach() for k, p in flatten(state.params).items()},
                grads={k: p.grad for k, p in flatten(state.params).items()})


def test_two_rank_gloo_step_on_one_card_matches_one_process(cuda):
    """Two ranks on the same card over gloo (every collective on CUDA
    tensors): the losses and grad norm of the one-process step on the same
    global batch (rtol 1e-4: fp32, dk / dv summed across ranks), and each
    parameter's gradient within 1e-4 relative RMS of its one-process
    gradient (a fault confined to dK / dV leaves the losses as they are),
    K3 / K5a / K5b once per layer on each rank, parameters bitwise equal
    across ranks."""
    from csm_tpu_torch.parallel.launch import launch

    res = launch(_sp_train_rank, 2, 11, timeout=600.0)
    cfg = _config()
    opt = make_optimizer(1e-3, 4)
    state = opt.init(CSMModel(cfg, seed=5, device=cuda).params)
    step = make_train_step(cfg, opt, 24, remat=True, remat_policy="dots")
    state, m = step(state, None, _train_batch(cfg, 1, 2, 64, seed=11))
    L = cfg.backbone.num_hidden_layers
    for rec in res:
        assert rec["launches"] == (L, L, L)
        for k, v in m.items():
            assert abs(rec["metrics"][k] - float(v)) <= 1e-4 * abs(float(v)), k
        for k, p in flatten(state.params).items():
            g, r = torch.as_tensor(rec["grads"][k]).float(), p.grad.cpu().float()
            assert (g - r).norm() <= 1e-4 * r.norm(), k
    for k, p in res[0]["params"].items():
        np.testing.assert_array_equal(p, res[1]["params"][k], err_msg=k)


# ---------------------------------------------------------------------------
# Tensor parallelism: K3 / K5a / K5b on head shards
# ---------------------------------------------------------------------------


def _tp_forward_rank(seed):
    """One rank of a model=2 mesh on the shared card: the bf16 cached prefill
    of this rank's shards with the flash kernel (2 query / 1 KV heads a
    rank) and with the plain attention, K3's launches, and 2 greedy frames
    generated on the shards."""
    from csm_tpu_torch.generation import generate_compiled
    from csm_tpu_torch.models import llama
    from csm_tpu_torch.parallel import make_mesh, shard_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = _config()
    mesh = make_mesh(data=1, model=2)
    params = shard_params(CSMModel(cfg, dtype=torch.bfloat16, seed=seed, device="cuda").params,
                          mesh, cfg)
    b = _train_batch(cfg, 1, 2, 48, seed=seed)
    ids, mask = b["input_ids"][0], b["attention_mask"][0].float()
    nkv = llama.local_heads(params["backbone"]["layers"], cfg.backbone)[1]
    logits = {}
    with torch.no_grad():
        for flash in (True, False):
            cache = llama.KVCache.create(cfg.backbone, 2, 64, dtype=torch.bfloat16, device="cuda",
                                         num_kv_heads=nkv)
            flash_fwd.launches = 0
            out = csm.forward(params, cfg, ids, mask, cache=cache, flash_prefill=flash,
                              return_all_logits=True, mesh=mesh)
            torch.cuda.synchronize()
            logits[flash] = (out.logits.float(), flash_fwd.launches)
    flash_fwd.launches = 0
    frames, _ = generate_compiled(params, cfg, ids, mask, 48, max_new_frames=2, greedy=True,
                                  stop_on_all_zeros=False, mesh=mesh)
    torch.cuda.synchronize()
    return dict(kv_heads=nkv, flash=logits[True][0], plain=logits[False][0],
                live=(mask.sum(-1) > 0).int().cumsum(1) > 0,
                launches=(logits[True][1], logits[False][1], flash_fwd.launches), frames=frames)


def test_tp_prefill_runs_k3_on_head_shards(cuda):
    """Two ranks of a model=2 mesh on the card over gloo: each prefill runs
    K3 once per layer on its 2 query / 1 KV heads, and its logits on the
    rows that see a valid key (the kernel and the plain attention treat a
    row of padding differently) are within phase 2's bf16 limit (relative
    RMS 2e-2) of the plain attention on the same shards; both ranks' logits
    and greedy frames are bitwise equal (the row-parallel sums reach every
    rank alike)."""
    from csm_tpu_torch.parallel.launch import launch

    res = launch(_tp_forward_rank, 2, 6, timeout=600.0)
    L = _config().backbone.num_hidden_layers
    for rec in res:
        assert rec["kv_heads"] == 1
        assert rec["launches"] == (L, 0, L)
        live = torch.as_tensor(rec["live"])  # rows that see a valid key
        flash, plain = (torch.as_tensor(rec[k])[live] for k in ("flash", "plain"))
        assert _rel_rms(flash, plain) <= 2e-2
    np.testing.assert_array_equal(res[0]["flash"], res[1]["flash"])
    np.testing.assert_array_equal(res[0]["frames"], res[1]["frames"])


def _tp_train_rank(seed):
    """One rank of a model=2 mesh on the shared card: one fp32 train step on
    its shards through K3 / K5a / K5b at its head shard, its metrics,
    launches and the gathered gradients the update used."""
    from csm_tpu_torch.parallel import gather_params, make_mesh, shard_params
    from csm_tpu_torch.train.loop import map_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _config()
    mesh = make_mesh(data=1, model=2)
    batch = _train_batch(cfg, 1, 2, 64, seed=seed)
    opt = make_optimizer(1e-3, 4)
    state = opt.init(shard_params(CSMModel(cfg, seed=5, device="cuda").params, mesh, cfg))
    step = make_train_step(cfg, opt, 24, remat=True, remat_policy="dots", mesh=mesh)
    flash_fwd.launches = fa.flash_bwd_dq.launches = fa.flash_bwd_dkv.launches = 0
    state, m = step(state, None, batch)
    torch.cuda.synchronize()
    grads = gather_params(map_tree(lambda p: p.grad, state.params), mesh, cfg)
    return dict(metrics={k: float(v) for k, v in m.items()},
                launches=(flash_fwd.launches, fa.flash_bwd_dq.launches,
                          fa.flash_bwd_dkv.launches),
                grads=flatten(grads))


def test_tp_train_step_with_the_kernels_matches_one_process(cuda):
    """Two ranks of a model=2 mesh on the card over gloo, fp32: K3 / K5a /
    K5b once per layer on each rank's head shard, the losses and grad norm
    of the one-process step (rtol 1e-4) and each gathered gradient within
    1e-4 relative RMS of the one-process gradient."""
    from csm_tpu_torch.parallel.launch import launch

    res = launch(_tp_train_rank, 2, 13, timeout=600.0)
    cfg = _config()
    opt = make_optimizer(1e-3, 4)
    state = opt.init(CSMModel(cfg, seed=5, device=cuda).params)
    step = make_train_step(cfg, opt, 24, remat=True, remat_policy="dots")
    state, m = step(state, None, _train_batch(cfg, 1, 2, 64, seed=13))
    L = cfg.backbone.num_hidden_layers
    for rec in res:
        assert rec["launches"] == (L, L, L)
        for k, v in m.items():
            assert abs(rec["metrics"][k] - float(v)) <= 1e-4 * abs(float(v)), k
        for k, p in flatten(state.params).items():
            g, r = torch.as_tensor(rec["grads"][k]).float(), p.grad.cpu().float()
            assert (g - r).norm() <= 1e-4 * r.norm(), k


def test_mimi_encode_ignores_the_default_tf32(cuda):
    """The card's Mimi encode and decode are the same bits with
    ``cudnn.allow_tf32`` on (torch's default) and off: the codec runs its
    convolutions in fp32 itself (under TF32 its later residual codebooks
    drifted from the CPU's encode)."""
    from csm_tpu_torch.codec import MimiCodec, MimiCodecConfig, random_mimi_params

    cfg = MimiCodecConfig()
    codec = MimiCodec(cfg, random_mimi_params(cfg, seed=0), device=cuda)
    wave = (0.1 * np.random.default_rng(0).standard_normal(1920 * 6)).astype(np.float32)
    before = torch.backends.cudnn.allow_tf32
    out = {}
    try:
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            codes = codec.encode(wave)
            out[tf32] = (codes, codec.decode(codes))
            assert torch.backends.cudnn.allow_tf32 is tf32
    finally:
        torch.backends.cudnn.allow_tf32 = before
    np.testing.assert_array_equal(out[True][0], out[False][0])
    np.testing.assert_array_equal(out[True][1], out[False][1])


# ---------------------------------------------------------------------------
# The bf16 tensor-core kernels (K3, K5b): ragged shapes, determinism, HGMMA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 16])
def test_tensor_core_kernels_on_ragged_shapes(cuda, hd, causal):
    """S = 200 queries against T = 333 keys (neither a multiple of a tile),
    B = 3 rows left-padded by 0 / 37 / 150 keys, bf16, 8 query / 2 kv heads:
    K3's output on live rows within the prefill limit, its lse within 1e-5
    relative (dead rows exactly NEG_INF), and dq / dk / dv within
    ``BWD_TOL`` of the plain backward, bitwise equal over two runs."""
    gen = torch.Generator(device=cuda).manual_seed(hd + causal)
    B, S, T, nq, nkv = 3, 200, 333, 8, 2
    dt = torch.bfloat16
    q, do = (torch.randn((B, S, nq, hd), generator=gen, device=cuda).to(dt) for _ in range(2))
    k, v = (torch.randn((B, T, nkv, hd), generator=gen, device=cuda).to(dt) for _ in range(2))
    valid = torch.ones((B, T), dtype=torch.int32, device=cuda)
    for b, pad in enumerate((0, 37, 150)):
        valid[b, :pad] = 0
    live = valid[:, :S].cumsum(1) > 0 if causal else torch.ones((B, S), dtype=torch.bool,
                                                                  device=cuda)
    out, lse = flash_fwd(q, k, v, valid, causal, with_lse=True)
    ref_out, ref_lse = flash_attention_reference(q, k, v, valid, causal, return_lse=True)
    err = (out.float() - ref_out.float()).abs()[live].max().item()
    assert err <= 2e-2, err
    lse_err = (lse - ref_lse).abs().transpose(1, 2)[live].max().item()
    assert lse_err <= 1e-5 * max(1.0, ref_lse.abs().max().item()), lse_err
    assert (lse.transpose(1, 2)[~live] == fa.NEG_INF).all()
    got = flash_bwd(q, k, v, valid, out, lse, do, causal)
    again = flash_bwd(q, k, v, valid, out, lse, do, causal)
    want = flash_attention_bwd_reference(q, k, v, valid, out, lse, do, causal)
    torch.cuda.synchronize()
    for name, a, w, a2 in zip(("dq", "dk", "dv"), got, want, again):
        assert torch.equal(a, a2), name
        assert _rel_rms(a, w) <= BWD_TOL[dt], (name, _rel_rms(a, w))


def test_tensor_core_forward_is_deterministic(cuda):
    """Two launches of the bf16 K3 with LSE on the same inputs are bitwise
    equal (no atomics, a fixed order of every sum)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    B, S, nq, nkv, hd = 2, 384, 8, 2, 64
    q = torch.randn((B, S, nq, hd), generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((B, S, nkv, hd), generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    valid = torch.ones((B, S), dtype=torch.int32, device=cuda)
    valid[1, :40] = 0
    first = flash_fwd(q, k, v, valid, True, with_lse=True)
    second = flash_fwd(q, k, v, valid, True, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def test_bf16_kernels_run_on_the_tensor_cores(cuda):
    """The bf16 K3, K5a and K5b in the built libraries hold HGMMA (wgmma)
    instructions in all 9 instantiations; the fp32 kernels hold none; K2
    holds HMMA (mma.sync)."""
    from csm_tpu_torch.ops import _build

    sass = _build.sass_by_function(["flash_fwd", "flash_bwd", "fused_decoder"])
    for name in ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                 "flash_bwd_dkv_wgmma_kernel"):
        fns = {f: s for f, s in sass.items() if name in f}
        assert len(fns) == 9, (name, sorted(fns))  # hd 16 / 32 / 64 x groups 1 / 2 / 4
        assert all("HGMMA" in s for s in fns.values()), name
    for name in ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"):
        fns = {f: s for f, s in sass.items() if f"{name}I" in f}
        assert fns and not any("HGMMA" in s for s in fns.values()), name
    fused = [s for f, s in sass.items() if "fused_decoder_kernel" in f]
    assert len(fused) == 1 and "HMMA" in fused[0]


# ---------------------------------------------------------------------------
# K5a on the tensor cores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("nq,nkv", [(4, 4), (4, 2), (8, 2)])
@pytest.mark.parametrize("hd", [16, 32, 64])
def test_bf16_dq_kernel_on_ragged_shapes(cuda, hd, nq, nkv, causal):
    """The bf16 K5a at every head dim and group, S = 200 queries against T =
    333 keys, rows left-padded by 0 / 37 / 150 keys: dq within ``BWD_TOL``
    of the plain backward, bitwise equal over two launches, exactly zero on
    dead rows."""
    gen = torch.Generator(device=cuda).manual_seed(hd + 10 * nq + nkv + causal)
    B, S, T = 3, 200, 333
    dt = torch.bfloat16
    q, do = (torch.randn((B, S, nq, hd), generator=gen, device=cuda).to(dt) for _ in range(2))
    k, v = (torch.randn((B, T, nkv, hd), generator=gen, device=cuda).to(dt) for _ in range(2))
    valid = torch.ones((B, T), dtype=torch.int32, device=cuda)
    for b, pad in enumerate((0, 37, 150)):
        valid[b, :pad] = 0
    out, lse = flash_fwd(q, k, v, valid, causal, with_lse=True)
    delta = fa._delta(out, do)
    before = fa.flash_bwd_dq.launches
    dq = fa.flash_bwd_dq(q, k, v, valid, do, lse, delta, causal)
    again = fa.flash_bwd_dq(q, k, v, valid, do, lse, delta, causal)
    want = flash_attention_bwd_reference(q, k, v, valid, out, lse, do, causal)[0]
    torch.cuda.synchronize()
    assert fa.flash_bwd_dq.launches == before + 2
    assert dq.dtype == dt and torch.equal(dq, again)
    assert _rel_rms(dq, want) <= BWD_TOL[dt], _rel_rms(dq, want)
    if causal:
        live = valid[:, :S].cumsum(1) > 0
        assert (dq[~live] == 0).all()


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("hd,nq,nkv", [(16, 4, 4), (64, 8, 2), (32, 4, 1)])
def test_bf16_dq_shards_equal_the_unsharded_launch(cuda, hd, nq, nkv, shards):
    """K5a on query shards at ``q_offset = shard * S_local`` over the whole
    K / V: every shard's dq rows bitwise equal to the unsharded launch's."""
    gen = torch.Generator(device=cuda).manual_seed(hd + shards)
    B, S = 2, 384
    dt = torch.bfloat16
    q, do = (torch.randn((B, S, nq, hd), generator=gen, device=cuda).to(dt) for _ in range(2))
    k, v = (torch.randn((B, S, nkv, hd), generator=gen, device=cuda).to(dt) for _ in range(2))
    valid = torch.ones((B, S), dtype=torch.int32, device=cuda)
    valid[1, :90] = 0
    out, lse = flash_fwd(q, k, v, valid, True, with_lse=True)
    delta = fa._delta(out, do)
    dq = fa.flash_bwd_dq(q, k, v, valid, do, lse, delta)
    Sl = S // shards
    for s in range(shards):
        sl = slice(s * Sl, (s + 1) * Sl)
        _poison_allocator(dq)
        got = fa.flash_bwd_dq(q[:, sl], k, v, valid, do[:, sl], lse[..., sl], delta[..., sl],
                              True, s * Sl)
        torch.cuda.synchronize()
        assert torch.equal(got, dq[:, sl]), s


# ---------------------------------------------------------------------------
# K2: the fused codebook loop, redesigned
# ---------------------------------------------------------------------------

# The phase-5 limits of chip_smoke.py: full-depth logits relative RMS, and
# per decoder layer alone the share of logits differing and their relative
# RMS.
FUSED_FULL_RMS_TOL = 2e-2
FUSED_LAYER_LIMITS = {"share": 0.3, "rel_rms": 3e-3}


def _check_sync_counts(qdec, cfg, B):
    """The last launch's own counters: no grid barrier, every item of the
    frame's list run once, at most that many items that found a flag closed."""
    counts = fd.last_sync_counts()
    assert counts["grid_barriers"] == 0, counts
    assert counts["items"] == fd.item_count(qdec, cfg, B), counts
    assert 0 <= counts["closed_waits"] <= counts["items"], counts


def _fused_bundle(model, cfg, head: str) -> dict:
    """The kernel's bundle with a bf16, int8 or f32 head."""
    params = model.params
    if head == "f32":
        params = {**params, "audio_head": params["audio_head"].float()}
    return fd.prepare_fused_decoder(params, cfg, head_bits=8 if head == "int8" else 16)


def _decoder_layer(qdec: dict, l: int) -> dict:
    return {**qdec, "w": {k: v[l:l + 1] for k, v in qdec["w"].items()},
            "s": {k: v[l:l + 1] for k, v in qdec["s"].items()}}


def _fused_logits(qdec, cfg, args, B):
    """Kernel and plain logits, teacher-forced on the plain version's tokens."""
    N = cfg.audio_num_codebooks
    forced = fd.decode_codebooks_reference(qdec, cfg, *args,
                                           torch.full((B, N), -1, device="cuda"))[0]
    ref = fd.decode_codebooks_reference(qdec, cfg, *args, forced)
    got = fd.fused_decode_codebooks(qdec, cfg, *args, forced=forced, return_logits=True)
    return forced, got, ref


@pytest.mark.parametrize("head", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("B", [1, 3, 8, 32])
def test_fused_kernel_holds_the_phase5_limits(cuda, B, head):
    """Greedy and sampled, teacher-forced: full-depth logits within
    ``FUSED_FULL_RMS_TOL``, each layer alone within ``FUSED_LAYER_LIMITS``,
    forced tokens passed through, every draw bit-equal to the plain sampler
    on the kernel's own logits, two launches bitwise equal, no grid barrier
    and every item run once by the kernel's own count, and stream 0's logits
    bitwise those of the same stream launched alone."""
    cfg = _config()
    model = CSMModel(cfg, dtype=torch.bfloat16, seed=3, device=cuda)
    qdec = _fused_bundle(model, cfg, head)
    gen = torch.Generator(device=cuda).manual_seed(B)
    N, Va, L = cfg.audio_num_codebooks, cfg.audio_vocab_size, cfg.decoder.num_hidden_layers
    last_h = torch.randn((B, cfg.backbone.hidden_size), generator=gen, device=cuda).bfloat16()
    x0 = (last_h @ model.params["projection"]).float()
    c0 = (last_h @ model.params["codebook0_head"]).float()
    temp = torch.full((B,), 0.8, device=cuda)
    topk = torch.full((B,), 5, dtype=torch.int32, device=cuda)
    for greedy in (True, False):
        gum = fd.build_frame_gumbel(cfg, gen, B, greedy, cuda)
        args = (x0, c0, gum, temp, topk, greedy)
        forced, (samples, lg, draws), ref = _fused_logits(qdec, cfg, args, B)
        torch.cuda.synchronize()
        _check_sync_counts(qdec, cfg, B)
        assert torch.equal(samples, forced)
        a, r = lg[..., :Va], ref[1][..., :Va]
        assert torch.isfinite(a).all() and _rel_rms(a, r) <= FUSED_FULL_RMS_TOL
        gp = F.pad(gum, (0, lg.shape[-1] - Va))
        mine = torch.stack([fd.sample_row(lg[i], gp[i], temp[:, None], topk[:, None], greedy)
                            for i in range(N)], dim=1)
        assert torch.equal(mine, draws)
        again = fd.fused_decode_codebooks(qdec, cfg, *args, forced=forced, return_logits=True)
        assert all(torch.equal(x, y) for x, y in zip((samples, lg, draws), again))
        solo = fd.fused_decode_codebooks(qdec, cfg, x0[:1], c0[:1], gum[:, :1], temp[:1],
                                         topk[:1], greedy, forced=forced[:1], return_logits=True)
        assert torch.equal(solo[1][:, 0], lg[:, 0])
        for l in range(L):
            _, got, want = _fused_logits(_decoder_layer(qdec, l), cfg, args, B)
            a, r = got[1][..., :Va], want[1][..., :Va]
            assert (a != r).float().mean().item() <= FUSED_LAYER_LIMITS["share"], l
            assert _rel_rms(a, r) <= FUSED_LAYER_LIMITS["rel_rms"], l


@pytest.mark.parametrize("head", ["bf16", "int8"])
def test_fused_kernel_mixed_greedy_rows_and_forced_prefix(cuda, head):
    """B = 32, every other row greedy (top-1, no noise) and row b's first b %
    7 codebooks forced: the forced prefix passed through, every draw bit-equal
    to the sampler on the kernel's logits with its row's settings (greedy rows:
    the first-index argmax), the logits within ``FUSED_FULL_RMS_TOL`` of the
    plain version teacher-forced on the kernel's own codes, and the counters
    as in every launch."""
    B = 32
    cfg = _config()
    model = CSMModel(cfg, dtype=torch.bfloat16, seed=5, device=cuda)
    qdec = _fused_bundle(model, cfg, head)
    gen = torch.Generator(device=cuda).manual_seed(7)
    N, Va = cfg.audio_num_codebooks, cfg.audio_vocab_size
    last_h = torch.randn((B, cfg.backbone.hidden_size), generator=gen, device=cuda).bfloat16()
    x0 = (last_h @ model.params["projection"]).float()
    c0 = (last_h @ model.params["codebook0_head"]).float()
    greedy_rows = torch.arange(B, device=cuda) % 2 == 0
    temp, topk, gum = fd.row_params(B, Va, 0.9, 5, fd.build_frame_gumbel(cfg, gen, B, False, cuda),
                                    greedy_rows)
    col = torch.arange(N, device=cuda)[None, :]
    prefix = (torch.arange(B, device=cuda) % 7)[:, None]
    codes = torch.randint(0, Va, (B, N), generator=gen, device=cuda)
    forced = torch.where(col < prefix, codes, torch.full_like(codes, -1))
    args = (x0, c0, gum, temp, topk, False)
    samples, lg, draws = fd.fused_decode_codebooks(qdec, cfg, *args, forced=forced,
                                                   return_logits=True)
    torch.cuda.synchronize()
    _check_sync_counts(qdec, cfg, B)
    assert torch.equal(samples[col < prefix], codes[col < prefix])
    assert torch.equal(samples[col >= prefix], draws[col >= prefix])
    gp = F.pad(gum, (0, lg.shape[-1] - Va))
    mine = torch.stack([fd.sample_row(lg[i], gp[i], temp[:, None], topk[:, None], False)
                        for i in range(N)], dim=1)
    assert torch.equal(mine, draws)
    greedy_draws = torch.stack([fd.first_argmax(lg[i]) for i in range(N)], dim=1)
    assert torch.equal(draws[greedy_rows], greedy_draws[greedy_rows])
    ref = fd.decode_codebooks_reference(qdec, cfg, *args, samples)
    a, r = lg[..., :Va], ref[1][..., :Va]
    assert torch.isfinite(a).all() and _rel_rms(a, r) <= FUSED_FULL_RMS_TOL


@pytest.mark.parametrize("B", [1, 32])
def test_fused_kernel_is_one_cuda_kernel(cuda, B):
    """A frame is one launch of ``fused_decoder_kernel``; its stage trace
    stamps block 0's clock in order through every stage of the list, and its
    item trace holds every item's stage in list order, the last the last
    codebook's draws, and its times in order.  A short item trace is refused."""
    from torch.profiler import ProfilerActivity, profile

    cfg = _config()
    model = CSMModel(cfg, dtype=torch.bfloat16, seed=1, device=cuda)
    qdec = _fused_bundle(model, cfg, "bf16")
    gen = torch.Generator(device=cuda).manual_seed(B)
    N, Va, L = cfg.audio_num_codebooks, cfg.audio_vocab_size, cfg.decoder.num_hidden_layers
    last_h = torch.randn((B, cfg.backbone.hidden_size), generator=gen, device=cuda).bfloat16()
    x0 = (last_h @ model.params["projection"]).float()
    c0 = (last_h @ model.params["codebook0_head"]).float()
    temp = torch.full((B,), 0.8, device=cuda)
    topk = torch.full((B,), 5, dtype=torch.int32, device=cuda)
    gum = fd.build_frame_gumbel(cfg, gen, B, False, cuda)
    args = (qdec, cfg, x0, c0, gum, temp, topk, False)
    fd.fused_decode_codebooks(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            fd.fused_decode_codebooks(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    assert 0 < sum("fused_decoder_kernel" in n for n in names) <= 4, names
    stamps = torch.zeros((fd.stage_count(N, L),), dtype=torch.int64, device=cuda)
    fd.fused_decode_codebooks(*args, stage_ns=stamps)
    d = stamps.diff()
    assert stamps[0].item() > 0 and bool((d >= 0).all())
    S = fd.TRACE_SLOTS
    items = torch.zeros((S * fd.item_count(qdec, cfg, B),), dtype=torch.int64, device=cuda)
    fd.fused_decode_codebooks(*args, item_ns=items)
    rows = items.view(-1, S)
    assert bool((rows[:, 0].diff() >= 0).all())
    assert rows[-1, 0].item() == fd.stage_count(N, L) - 2
    assert bool((rows[:, 1] > 0).all() and (rows[:, 2] >= rows[:, 1]).all()
                and (rows[:, S - 1] >= rows[:, 2]).all())
    with pytest.raises(ValueError, match="item trace"):
        fd.fused_decode_codebooks(*args, item_ns=items[:S])
    with pytest.raises(ValueError, match="B=33, outside 1..32"):
        fd.fused_decode_codebooks(qdec, cfg, x0[:1].expand(33, -1), c0[:1].expand(33, -1),
                                  gum[:, :1].expand(-1, 33, -1), temp[:1].expand(33),
                                  topk[:1].expand(33), False)


# ---------------------------------------------------------------------------
# K1q-8 / K1q-4: one persistent launch a step
# ---------------------------------------------------------------------------


def _cuda_kernels(fn) -> int:
    """CUDA kernels one call of ``fn`` launches, counted by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation)


@pytest.mark.parametrize("bits,B", [(8, 1), (8, 32), (4, 1), (4, 32), (16, 1), (16, 8)])
def test_bbq_step_is_one_cuda_kernel(cuda, bits, B):
    """A step of every tier is one persistent launch; its stage trace stamps
    block 0's clock in order through every stage, and its item trace holds
    every item's stage in list order and its times in order."""
    cfg = _config()
    model = CSMModel(cfg, dtype=torch.bfloat16, seed=1, device=cuda)
    qsb = bb_kernel.prepare_streamed_backbone(model.params, cfg, bits=bits)
    kernel = bb_kernel.bb_decode_step
    args = (qsb, cfg, *_bbq_inputs(cfg, B, 40, B, cuda))
    kernel(*args)
    # chip_smoke's bound, over 4 steps: the profiler has been seen to drop a
    # kernel now and then.
    assert 0 < _cuda_kernels(lambda: [kernel(*args) for _ in range(4)]) / 4 <= 2
    L = cfg.backbone.num_hidden_layers
    stamps = torch.zeros((bb_kernel.stage_count(L),), dtype=torch.int64, device=cuda)
    kernel(*args, stage_ns=stamps)
    d = stamps.diff()
    assert stamps[0].item() > 0 and bool((d >= 0).all())
    S = bb_kernel.TRACE_SLOTS
    items = torch.zeros((S * bb_kernel.item_count(qsb, cfg, B),), dtype=torch.int64, device=cuda)
    kernel(*args, item_ns=items)
    rows = items.view(-1, S)
    assert bool((rows[:, 0].diff() >= 0).all()) and rows[-1, 0].item() == 5 * L + 2
    assert bool((rows[:, 1] > 0).all() and (rows[:, 2] >= rows[:, 1]).all()
                and (rows[:, S - 1] >= rows[:, 2]).all())


@pytest.mark.parametrize("source,name,n", [("bb_decode_q", "bbq_step_kernel", 2),
                                           ("bb_decode", "bb_step_kernel", 1)])
def test_bbq_kernels_run_on_the_tensor_cores(cuda, source, name, n):
    """Every instantiation of the persistent steps (int8 and int4; exact)
    holds HMMA (mma.sync)."""
    from csm_tpu_torch.ops import _build

    sass = _build.sass_by_function([source])
    fns = {f: s for f, s in sass.items() if name in f}
    assert len(fns) == n and all("HMMA" in s for s in fns.values()), sorted(sass)


@pytest.mark.parametrize("bits,b_max", [(8, bb_kernel.MAX_VALIDATED_B),
                                        (16, bb_kernel.MAX_VALIDATED_B_EXACT)])
def test_bbq_wrapper_raises_on_what_the_kernel_does_not_take(cuda, bits, b_max):
    cfg = _config()
    model = CSMModel(cfg, dtype=torch.bfloat16, seed=1, device=cuda)
    qsb = bb_kernel.prepare_streamed_backbone(model.params, cfg, bits=bits)
    step = bb_kernel.bb_decode_step
    args = _bbq_inputs(cfg, b_max + 1, 8, 0, cuda)
    with pytest.raises(ValueError, match=f"B={b_max + 1}, outside 1..{b_max}"):
        step(qsb, cfg, *args)
    h0, cos, sin, bias, kc, vc = _bbq_inputs(cfg, 1, 8, 0, cuda)
    with pytest.raises(ValueError, match="bf16 KV cache"):
        step(qsb, cfg, h0, cos, sin, bias, kc.float(), vc.float())
    short = torch.zeros((bb_kernel.TRACE_SLOTS,), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="item trace"):
        step(qsb, cfg, h0, cos, sin, bias, kc, vc, item_ns=short)
    with pytest.raises(ValueError, match="window"):
        step(qsb, cfg, *_bbq_inputs(cfg, 1, 16384, 0, cuda))


def test_dataset_encodes_audio_with_the_cards_mimi(cuda, tmp_path):
    """``CSMAudioTextDataset`` whose processor holds a ``MimiCodec`` on the
    card (tiny, 32 quantizers, random weights) on a 48 kHz stereo WAV written
    here: the same frames as with the codec on the CPU (text and mask
    exactly, codes on at least 99 %), codes in range, the audio span ending
    in the zero EOS frame."""
    import json

    from csm_tpu_torch.codec import MimiCodec, MimiCodecConfig, random_mimi_params
    from csm_tpu_torch.data import CSMAudioTextDataset, CSMProcessor
    from csm_tpu_torch.data.audio_io import save_wav

    class CharTokenizer:
        bos_token_id, eos_token_id = 1, 2

        def encode(self, text, add_special_tokens=True):
            return [1, *(10 + ord(c) % 80 for c in text), 2]

    mcfg = MimiCodecConfig.tiny(num_quantizers=32)
    params = random_mimi_params(mcfg, seed=0)
    wav = str(tmp_path / "clip.wav")
    wave = 0.3 * np.random.default_rng(0).standard_normal((2, 2 * 48000))
    save_wav(wav, wave.astype(np.float32), 48000)
    row = {"messages": [
        {"role": "speaker_0", "content": [{"type": "text", "text": "hello"}]},
        {"role": "speaker_1", "content": [{"type": "text", "text": "hi"},
                                          {"type": "audio", "url": wav}]}]}
    (tmp_path / "d.jsonl").write_text(json.dumps(row) + "\n")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        items = {dev: CSMAudioTextDataset(
            str(tmp_path / "d.jsonl"), num_train_epochs=2, seed=3,
            processor=CSMProcessor(CharTokenizer(), MimiCodec(mcfg, params, device=dev)))[1]
            for dev in (cuda, "cpu")}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    card, host = items[cuda], items["cpu"]
    np.testing.assert_array_equal(card["attention_mask"], host["attention_mask"])
    np.testing.assert_array_equal(card["input_ids"][:, 32], host["input_ids"][:, 32])
    audio = card["attention_mask"][:, 0] == 1
    codes = card["input_ids"][audio, :32]
    assert audio.sum() == 25 + 1 and (codes[-1] == 0).all()
    assert codes.min() >= 0 and codes.max() < mcfg.codebook_size
    assert (codes == host["input_ids"][audio, :32]).mean() >= 0.99


def _text_prompt(cfg, B=1, S=32, seed=4):
    rng = np.random.default_rng(seed)
    ids = np.zeros((B, S, 33), np.int64)
    ids[..., 32] = rng.integers(1, cfg.text_vocab_size, (B, S))
    mask = np.zeros((B, S, 33), np.float32)
    mask[..., 32] = 1
    return ids, mask


def test_attention_switch_launch_counts(cuda):
    """The uncached forward launches K3 once a layer under ``"auto"`` and
    ``"flash"`` (bitwise the same logits) and never under ``"xla"`` (the
    plain attention, within the gross 5e-2 relative RMS of chip_smoke's
    phase 3)."""
    from csm_tpu_torch.ops import attention

    cfg = _config()
    model = CSMModel(cfg, dtype=torch.bfloat16, seed=1, device=cuda)
    ids, mask = (torch.as_tensor(x, device=cuda) for x in _text_prompt(cfg, B=2))
    logits, launches = {}, {}
    try:
        for impl in ("auto", "flash", "xla"):
            attention.set_attention_impl(impl)
            before = flash_fwd.launches
            logits[impl] = csm.forward(model.params, cfg, ids, mask).logits.float()
            launches[impl] = flash_fwd.launches - before
    finally:
        attention.set_attention_impl("auto")
    L = cfg.backbone.num_hidden_layers
    assert launches == {"auto": L, "flash": L, "xla": 0}
    assert torch.equal(logits["auto"], logits["flash"])
    rms = ((logits["xla"] - logits["auto"]).norm() / logits["xla"].norm()).item()
    assert rms < 5e-2, rms


def test_trace_names_the_ports_kernels(cuda, tmp_path):
    """``utils.trace`` around a ``quantize(bits=4)`` generate writes a trace
    whose kernel events name K3 (bf16), K1q and K2."""
    import glob
    import json

    from csm_tpu_torch.utils import trace

    cfg = _config()
    model = CSMModel(cfg, dtype=torch.bfloat16, seed=2, device=cuda).quantize(bits=4)
    ids, mask = _text_prompt(cfg)
    model.generate(ids, mask, max_new_frames=2, greedy=True, stop_on_all_zeros=False)
    with trace(str(tmp_path), name="generate"):
        model.generate(ids, mask, max_new_frames=4, greedy=True, stop_on_all_zeros=False)
        torch.cuda.synchronize()
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = " ".join(e["name"] for e in events if e.get("cat") == "kernel")
    for name in ("flash_fwd_wgmma_kernel", "bbq_step_kernel", "fused_decoder_kernel"):
        assert name in kernels, name
    assert any(e.get("name") == "generate" for e in events)


def test_warmup_generation_launches_the_tiers_kernels(cuda):
    """On the card the warm-up builds and loads every kernel library, then
    runs each (B, S, frames) through K3, K1q-4 and K2; a later seeded call
    is bitwise the one before the warm-up."""
    from csm_tpu_torch.ops import _build
    from csm_tpu_torch.utils.warmup import warmup_generation

    cfg = _config()
    model = CSMModel(cfg, dtype=torch.bfloat16, seed=2, device=cuda).quantize(bits=4)
    ids, mask = _text_prompt(cfg)

    def run():
        g = torch.Generator(device=cuda)
        g.manual_seed(5)
        return model.generate(ids, mask, max_new_frames=4, generator=g)

    before = run()
    wrappers = (flash_fwd, bb_kernel.bb_decode_step_q4, fd.fused_decode_codebooks)
    counts = [w.launches for w in wrappers]
    n = warmup_generation(model.params, cfg, batch_sizes=(1, 2), prompt_buckets=(32,),
                          frame_budgets=(4,), qdec=model._qdec, qbb=model._qbb,
                          qsb=model._qsb)
    assert n == 2
    assert all(w.launches > c for w, c in zip(wrappers, counts))
    assert set(_build._loaded) >= {"flash_fwd", "flash_bwd", "bb_decode", "bb_decode_q",
                                   "fused_decoder"}
    np.testing.assert_array_equal(run(), before)
