"""The port's own copies of the numpy-only batch functions and collator are
byte-equal to the JAX package's, and its pattern overfit sharpens a tiny
model on the CPU."""

import numpy as np
import pytest
import torch

from csm_tpu.config import CSMConfig as JaxCSMConfig
from csm_tpu.data.collator import CSMDataCollator as JaxCollator
from csm_tpu.utils.overfit import pattern_batch as jpattern_batch
from csm_tpu.utils.synthetic import synthetic_conversation_batch as jsynthetic
from csm_tpu_torch import CSMConfig
from csm_tpu_torch.data import CSMDataCollator
from csm_tpu_torch.models import csm
from csm_tpu_torch.utils.overfit import overfit, pattern_batch
from csm_tpu_torch.utils.synthetic import synthetic_conversation_batch
from oracle import random_csm_batch


def _same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("kw", [
    dict(seq_len=24), dict(seq_len=40, batch=3, n_text=5, accum=2, phase=3),
])
@pytest.mark.parametrize("size", ["tiny", "csm-1b"])
def test_pattern_batch_is_byte_equal(size, kw):
    cfg, jcfg = (CSMConfig.tiny(), JaxCSMConfig.tiny()) if size == "tiny" else (
        CSMConfig(), JaxCSMConfig())
    _same(pattern_batch(cfg, **kw), jpattern_batch(jcfg, **kw))


@pytest.mark.parametrize("kw", [
    dict(seq_len=64, n_text=8), dict(seq_len=96, accum=2, batch=2, amortization_ratio=4, seed=7),
])
def test_synthetic_batch_is_byte_equal(kw):
    _same(synthetic_conversation_batch(CSMConfig(), **kw), jsynthetic(JaxCSMConfig(), **kw))


@pytest.mark.parametrize("kw", [
    dict(text_pad_token_id=5), dict(text_pad_token_id=0, pad_to_multiple=8),
    dict(text_pad_token_id=3, pad_to_length=20),
])
def test_collator_is_byte_equal(kw):
    cfg = CSMConfig.tiny()
    feats = [{k: v[0] for k, v in random_csm_batch(cfg, 1, s, seed=s).items()}
             for s in (7, 12, 9)]
    _same(CSMDataCollator(**kw)(feats), JaxCollator(**kw)(feats))
    assert CSMDataCollator(text_pad_token_id=0)([]) == {}
    with pytest.raises(ValueError, match="pad_to_length"):
        CSMDataCollator(text_pad_token_id=0, pad_to_length=8)(feats)


def test_overfit_loss_falls():
    """30 steps on one pattern batch: the loss falls well below its start,
    and the returned tensors share storage with the trained ones."""
    cfg = CSMConfig.tiny()
    params = csm.init_params(cfg, seed=0, device="cpu")
    b = {k: torch.as_tensor(v) for k, v in pattern_batch(cfg, 16, batch=2).items()}
    with torch.no_grad():
        start = float(csm.forward(params, cfg, b["input_ids"][0], b["attention_mask"][0],
                                  labels=b["labels"][0], max_decoder_frames=32).loss)
    trained, loss = overfit(params, cfg, steps=30, lr=3e-3, seq_len=16, batch=2, verbose=False)
    assert np.isfinite(loss) and loss < 0.7 * start, (start, loss)
    assert trained["projection"].data_ptr() == params["projection"].data_ptr()
    assert not trained["projection"].requires_grad
