"""The frozen plain reference against the port's plain path at
``CSMConfig.tiny()`` in float32: prefill and decode-position c0 logits, a
frame's decoder logits, Mimi PCM, the loss and its gradients; and the
quantized bundles it works out again against the port's own."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import spec, traffic, weights
from benchmark.reference import csm as ref
from benchmark.reference import mimi as ref_mimi
from benchmark.shapes import leaves

CSM = spec.family({})


@pytest.fixture(scope="module")
def setup():
    from csm_tpu_torch.config import CSMConfig

    cfg = CSMConfig.tiny(max_seq_len=128)
    params = weights.model_params(CSM, cfg, 3, torch.float32, "cpu")
    rng = np.random.default_rng(0)
    t = {"turn_frames": 16, "text_frames": 2, "audio_codes": cfg.audio_vocab_size}
    ids, mask = traffic.prompt(cfg, 20, t, rng)
    frames = rng.integers(0, cfg.audio_vocab_size, (6, 32))
    return cfg, params, torch.as_tensor(ids), torch.as_tensor(mask), torch.as_tensor(frames)


def close(a, b, tol=2e-5):
    return float((a - b).abs().max()) <= tol * max(1.0, float(b.abs().max()))


def test_c0_logits_equal_the_ports_forward(setup):
    from csm_tpu_torch.models import csm

    cfg, params, ids, mask, frames = setup
    w = ref.serve_weights(params, cfg, "exact")
    c0, rest = ref.served_logits(params, cfg, w, ids, mask, frames)
    S, F = ids.shape[0], frames.shape[0]
    full_ids = torch.zeros((S + F - 1, 33), dtype=torch.long)
    full_mask = torch.zeros(full_ids.shape)
    full_ids[:S], full_mask[:S] = ids, mask
    full_ids[S:, :32], full_mask[S:, :32] = frames[:-1], 1.0
    out = csm.forward(params, cfg, full_ids[None], full_mask[None], return_all_logits=True,
                      use_flash=False)
    assert close(c0, out.logits[0, S - 1:])
    # The decoder's logits of each frame, teacher-forced on its codebooks.
    dec = csm._decoder_logits(params, cfg, out.last_hidden_state.new_tensor(
        _hidden(params, cfg, full_ids, full_mask)[S - 1:]), frames)
    assert close(rest, dec)


def _hidden(params, cfg, ids, mask):
    from csm_tpu_torch.models import csm

    h, _ = csm.backbone_forward(params, cfg, ids[None], mask[None], use_flash=False)
    return h[0]


def test_mimi_pcm_equals_the_ports_decode():
    from csm_tpu_torch.codec.mimi import MimiCodecConfig, mimi_decode

    mc = MimiCodecConfig.tiny(num_quantizers=32)
    d = dataclasses.asdict(mc)
    ns = ref_mimi.config(d)
    p = weights.mimi_decoder_params(ns, 5, "cpu")
    codes = torch.as_tensor(np.random.default_rng(1).integers(0, mc.codebook_size + 3, (2, 32, 7)))
    want = mimi_decode(mc, p, codes)[:, 0]
    got = ref_mimi.decode(ns, p, codes)
    assert got.shape == want.shape == (2, 7 * 1920)
    assert close(got, want, 1e-5)


def test_loss_and_gradients_equal_the_ports(setup):
    from csm_tpu_torch.models import csm

    cfg, _, _, _, _ = setup
    t = {"accum": 1, "batch": 1, "seq_len": 96, "n_text": 16, "amortization_ratio": 16}
    b = {k: torch.as_tensor(v) for k, v in traffic.train_batch(cfg, t, 4, 0).items()}
    mine = {n: p.clone().requires_grad_(True)
            for n, p in leaves(weights.model_params(CSM, cfg, 9, torch.float32, "cpu"))}
    ports = {n: p.detach().clone().requires_grad_(True) for n, p in mine.items()}
    from benchmark.shapes import nest

    loss, bb, dl = ref.train_loss(nest(mine), cfg, b["input_ids"][0, 0], b["attention_mask"][0, 0],
                                  b["labels"][0, 0], 7, lambda w: w)
    loss.backward()
    out = csm.forward(nest(ports), cfg, b["input_ids"][0], b["attention_mask"][0],
                      labels=b["labels"][0], max_decoder_frames=7, use_flash=False)
    out.loss.backward()
    assert float(loss.detach()) == pytest.approx(float(out.loss.detach()), rel=1e-5)
    assert float(dl.detach()) == pytest.approx(float(out.decoder_loss.detach()), rel=1e-5)
    for n in mine:
        g, want = mine[n].grad, ports[n].grad
        assert close(g, want, 1e-4), n


def test_bundles_worked_out_again_equal_the_ports():
    from csm_tpu_torch.config import CSMConfig
    from csm_tpu_torch.ops.bb_kernel import prepare_streamed_backbone, unpack_int4_rows
    from csm_tpu_torch.ops.fused_decoder import prepare_fused_decoder

    cfg = CSMConfig.tiny()
    params = weights.model_params(CSM, cfg, 2, torch.bfloat16, "cpu")
    w = ref.serve_weights(params, cfg, "int4")
    q4 = prepare_streamed_backbone(params, cfg, bits=4)
    for fam in ref.FAMILIES:
        port = unpack_int4_rows(q4["w"][fam]).float() * q4["s"][fam] * q4["u"][fam].transpose(-1, -2)
        assert torch.allclose(w["step"][fam], port, rtol=1e-6, atol=0)
    head = (q4["w"]["head"].float() * q4["s"]["head"])[:, :cfg.audio_vocab_size]
    assert torch.allclose(w["step"]["head"], head, rtol=1e-6, atol=0)
    qd = prepare_fused_decoder(params, cfg, head_bits=16)
    for fam in ref.FAMILIES:
        assert torch.allclose(w["decoder"][fam], qd["w"][fam].float() * qd["s"][fam], rtol=1e-6,
                              atol=0)
    assert torch.equal(w["decoder"]["head"], qd["audio_head"][..., :cfg.audio_vocab_size].float())
