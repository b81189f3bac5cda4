"""The yardstick against hand counts at CSM-1B shapes, and against the
sizes of the port's own bundles at a tiny configuration."""

import pytest
import torch

from benchmark import spec
from benchmark import yardstick as ys
from benchmark.shapes import csm_shapes, layer_params

csm = spec.family({})  # what a configuration without a "family" key runs


def csm1b():
    from csm_tpu_torch.config import CSMConfig

    return CSMConfig()


def test_peaks_and_bound():
    assert ys.PEAK_FLOPS["bfloat16"] == 989e12 and ys.HBM_BYTES_PER_S == 3.35e12
    assert ys.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert ys.bound_s(0, 989e12) == pytest.approx(1.0)
    assert ys.bound_s(3.35e9, 989e12) == pytest.approx(1.0)


def test_layer_params_by_hand():
    cfg = csm1b()
    # Backbone layer: q 2048x2048, k/v 2048x512 each, o 2048x2048, MLP 3 x 2048x8192, 2 norms.
    per_layer = 2048 * 2048 * 2 + 2048 * 512 * 2 + 3 * 2048 * 8192 + 2 * 2048
    assert layer_params(cfg.backbone) == 16 * per_layer == 973_144_064
    # Decoder layer: q/o 1024x1024, k/v 1024x256, MLP 3 x 1024x8192, 2 norms.
    assert layer_params(cfg.decoder) == 4 * (1024 * 1024 * 2 + 1024 * 256 * 2 + 3 * 1024 * 8192
                                             + 2 * 1024)


def test_shapes_are_the_ports():
    from csm_tpu_torch.parallel.mesh import param_shapes

    cfg = csm1b()
    assert csm_shapes(cfg) == param_shapes(cfg)


def test_prefill_flops_equal_the_ports():
    from csm_tpu_torch.utils.measure import prefill_flops

    cfg = csm1b()
    for S in (128, 512, 2048):
        assert csm.prefill_flops(cfg, S) == prefill_flops(None, cfg, S)
    # By hand at S = 128: 2 N S + 2 * 2 * S^2 / 2 * 32 * 64 * 16.
    assert csm.prefill_flops(cfg, 128) == 2 * 973_144_064 * 128 + 2 * 128 * 128 * 32 * 64 * 16


def test_k2_work_by_hand():
    cfg = csm1b()
    elems = 4 * (1024 * 1536 + 1024 * 1024 + 1024 * 16384 + 8192 * 1024)  # int8, 1 byte each
    scales = 4 * 4 * (1536 + 1024 + 16384 + 1024)
    b, f = csm.k2_work(cfg, 8, head_bits=16)
    want = 31 * (elems + scales) + 31 * 1024 * 2051 * 2 + 31 * 8 * 1024 * 2 + \
        4 * (32 * 8 * 2051 + 8 * 2051 + 8 * 1024 + 16) + 8 * 8 * 32
    assert b == want
    assert f == 2 * 8 * 31 * (elems + 1024 * 2051)
    b8, _ = csm.k2_work(cfg, 8, head_bits=8)
    assert b - b8 == 31 * 1024 * 2051 - 31 * 2051 * 4


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_bb_work_matches_the_ports_bundle(bits):
    """At a tiny configuration the weight bytes are those of the port's own
    bundle tensors (the c0 head at its real columns)."""
    from csm_tpu_torch.config import CSMConfig
    from csm_tpu_torch.models.csm import init_params
    from csm_tpu_torch.ops.bb_kernel import prepare_streamed_backbone

    cfg = CSMConfig.tiny()
    qsb = prepare_streamed_backbone(init_params(cfg, 0, torch.bfloat16, "cpu"), cfg, bits=bits)
    D, Va = cfg.backbone.hidden_size, cfg.audio_vocab_size

    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    fams = ("wqkv", "wo", "w_gu", "w_down")
    if bits == 16:
        w = nb(*(qsb[k] for k in fams), qsb["attn_nw"], qsb["mlp_nw"], qsb["final_norm"]) + \
            D * Va * 2
    else:
        w = nb(*(qsb["w"][k] for k in fams), *(qsb["s"][k] for k in fams), qsb["final_norm"]) + \
            D * Va + Va * 4
        if bits == 4:
            w += nb(*(qsb["u"][k] for k in fams))
    b, _ = csm.bb_work(cfg, 1, 64, 0, bits)
    L, hd, nkv = cfg.backbone.num_hidden_layers, cfg.backbone.head_dim, \
        cfg.backbone.num_key_value_heads
    io = 4 * (D + 2 * hd + 64 + D + Va) + 2 * 2 * L * nkv * hd
    assert b == w + io


def test_k2_work_matches_the_ports_bundle():
    from csm_tpu_torch.config import CSMConfig
    from csm_tpu_torch.models.csm import init_params
    from csm_tpu_torch.ops.fused_decoder import prepare_fused_decoder

    cfg = CSMConfig.tiny()
    qdec = prepare_fused_decoder(init_params(cfg, 0, torch.bfloat16, "cpu"), cfg)
    mats = [qdec["w"][k] for k in ("wqkv", "wo", "w_gu", "w_down")]
    w = 31 * (sum(m.numel() for m in mats) + sum(s.numel() * 4 for s in qdec["s"].values()))
    b, f = csm.k2_work(cfg, 1)
    Dd, Va = cfg.decoder.hidden_size, cfg.audio_vocab_size
    assert b == w + 31 * Dd * Va * 2 + 31 * Dd * 2 + 4 * (32 * Va + Va + Dd + 2) + 8 * 32
    assert f == 2 * 31 * (sum(m.numel() for m in mats) + Dd * Va)


def test_flash_work_by_hand():
    cfg = csm1b()
    w = csm.flash_train_work(cfg, 1, 2048)
    pairs = 2048 * 2049 // 2
    assert w["fwd"][1] == 4 * 64 * 32 * pairs
    assert w["dq"][1] == 6 * 64 * 32 * pairs and w["dkv"][1] == 8 * 64 * 32 * pairs
    q = 2048 * 32 * 64 * 2
    kv = 2048 * 8 * 64 * 2
    assert w["fwd"][0] == 2 * q + 2 * kv + 2048 * 4 + 2048 * 32 * 4
    # Operations bound every one at this shape.
    for b, f in w.values():
        assert f / 989e12 > b / 3.35e12


def test_frame_and_train_flops_by_hand():
    cfg = csm1b()
    N_bb, N_dec = 973_144_064, layer_params(cfg.decoder)
    f = csm.frame_flops(cfg, 100)
    want = 2 * (N_bb + 2048 * 2051 + 2048 * 1024) + 4 * 64 * 32 * 16 * 100 + \
        31 * 2 * (N_dec + 1024 * 2051 + 2048 * 1024) + sum(4 * 128 * 8 * 4 * p for p in range(1, 33))
    assert f == want
    t = csm.train_sequence_flops(cfg, 2048, 124)
    fwd = csm.prefill_flops(cfg, 2048) + 2 * 2048 * 2051 * 2048 + 124 * (
        2 * (N_dec + 2048 * 1024) * 33 + 2 * 1024 * 2051 * 31
        + 2 * 2 * 33 * 33 * 8 * 128 * 4 / 2)
    assert t == pytest.approx(3 * fwd, rel=1e-12)
    # About 6 N tokens: 1.2e13 a sequence at S = 2048.
    assert 1.1e13 < t < 1.6e13
