"""The port's attention switch (``csm_tpu_torch.ops.attention.
set_attention_impl`` / ``CSM_TPU_ATTENTION``) against the JAX package's, on
the CPU at ``CSMConfig.tiny()`` in fp32 from ``init_params(key(0))``.

Under ``"flash"`` both packages send the uncached forward through their
flash route (the JAX package's Pallas kernel in interpret mode, the port's
kernels' plain versions): logits within the fixtures' rtol 2e-4 / atol
2e-5.  Under ``"xla"`` the port's forward is bitwise its ``use_flash=False``
forward.  Every test resets both switches in ``finally``."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu.config import CSMConfig as JaxCSMConfig
from csm_tpu.models import csm as jcsm
from csm_tpu.ops import attention as jattention
from csm_tpu.ops import flash_attention as jfa
from csm_tpu_torch import CSMConfig
from csm_tpu_torch.checkpoint import params_from_jax
from csm_tpu_torch.models import csm, llama
from csm_tpu_torch.ops import attention

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-4, 2e-5


def _prompt(cfg, B=2, S=16, seed=3):
    """Text-only ``[B, S, 33]`` prompts, row 1 left-padded by 3 frames."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((B, S, 33), np.int64)
    ids[..., 32] = rng.integers(1, cfg.text_vocab_size, (B, S))
    mask = np.zeros((B, S, 33), np.float32)
    mask[..., 32] = 1
    mask[1, :3] = 0
    return ids, mask


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxCSMConfig.tiny()
    jparams = jcsm.init_params(jax.random.key(0), jcfg)
    cfg = CSMConfig.tiny()
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


@pytest.mark.parametrize("impl", ["auto", "flash", "xla"])
def test_set_attention_impl_takes_the_three_values(impl):
    try:
        attention.set_attention_impl(impl)
        assert attention._impl == impl
    finally:
        attention.set_attention_impl("auto")


@pytest.mark.parametrize("impl", ["pallas", "", "FLASH"])
def test_set_attention_impl_refuses_another_value(impl):
    with pytest.raises(ValueError):
        attention.set_attention_impl(impl)
    assert attention._impl == "auto"


_READ = r"""
from csm_tpu_torch.config import CSMConfig
from csm_tpu_torch.models import csm
from csm_tpu_torch.ops import attention
cfg = CSMConfig.tiny()
params = csm.init_params(cfg, 0, device="cpu")
layers = params["backbone"]["layers"]
print(attention._impl, attention.flash_eligible(16, cfg.backbone, layers))
"""


@pytest.mark.parametrize("value,want", [("xla", "xla False"), ("flash", "flash True"),
                                        (None, "auto False")])
def test_environment_sets_the_default_at_import(value, want):
    """In a fresh interpreter: ``CSM_TPU_ATTENTION`` is the default, read at
    import (``auto`` without it); on the CPU only ``"flash"`` takes the
    flash route."""
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "CSM_TPU_ATTENTION")}
    env["PYTHONPATH"] = REPO
    if value is not None:
        env["CSM_TPU_ATTENTION"] = value
    res = subprocess.run([sys.executable, "-c", _READ], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().splitlines()[-1] == want


def test_environment_refuses_another_value():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, CSM_TPU_ATTENTION="pallas")
    res = subprocess.run([sys.executable, "-c", "import csm_tpu_torch.ops.attention"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "ValueError: pallas" in res.stderr


def _jax_flash_logits(jcfg, jparams, ids, mask):
    """The JAX forward under its ``"flash"`` switch, the Pallas kernel in
    interpret mode (as tests/test_flash_attention.py runs it)."""
    orig = jfa.flash_attention

    def interp(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    jfa.flash_attention = interp
    jattention.set_attention_impl("flash")
    try:
        return np.asarray(jcsm.forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask)).logits)
    finally:
        jattention.set_attention_impl("auto")
        jfa.flash_attention = orig


def test_flash_forward_matches_jax_flash(weights, monkeypatch):
    jcfg, jparams, cfg, params = weights
    ids, mask = _prompt(cfg)
    calls = []
    plain = llama.flash_attention

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return plain(*args, **kw)

    monkeypatch.setattr(llama, "flash_attention", counting)
    try:
        attention.set_attention_impl("flash")
        got = csm.forward(params, cfg, torch.as_tensor(ids), torch.as_tensor(mask)).logits
    finally:
        attention.set_attention_impl("auto")
    assert len(calls) == cfg.backbone.num_hidden_layers
    want = _jax_flash_logits(jcfg, jparams, ids, mask)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_flash_prefill_takes_the_flash_route_on_the_cpu(weights, monkeypatch):
    """The cached prefill under ``"flash"`` takes the flash op on the CPU and
    gives the plain prefill's logits within the tolerance; under ``"auto"``
    the CPU takes the plain attention."""
    from csm_tpu_torch.models.llama import KVCache

    _, _, cfg, params = weights
    ids, mask = _prompt(cfg)
    calls = []
    plain = llama.flash_attention
    monkeypatch.setattr(llama, "flash_attention",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))

    def prefill():
        cache = KVCache.create(cfg.backbone, 2, 128, dtype=torch.float32, device="cpu")
        return csm.forward(params, cfg, torch.as_tensor(ids), torch.as_tensor(mask),
                           cache=cache, flash_prefill=True).logits

    want = prefill()
    assert not calls
    try:
        attention.set_attention_impl("flash")
        got = prefill()
    finally:
        attention.set_attention_impl("auto")
    assert len(calls) == cfg.backbone.num_hidden_layers
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


def test_xla_is_bitwise_the_plain_forward(weights):
    _, _, cfg, params = weights
    ids, mask = (torch.as_tensor(x) for x in _prompt(cfg))
    want = csm.forward(params, cfg, ids, mask, use_flash=False).logits
    try:
        attention.set_attention_impl("xla")
        got = csm.forward(params, cfg, ids, mask).logits
    finally:
        attention.set_attention_impl("auto")
    assert torch.equal(got, want)


def test_xla_raises_no_head_shard_error(weights):
    """A head shard the kernels do not take raises under ``"flash"`` (as on
    the card under ``"auto"``) and takes the plain attention under
    ``"xla"``."""
    _, _, cfg, params = weights
    layers = dict(params["backbone"]["layers"])
    hd = cfg.backbone.head_dim
    # 3 query heads over 1 KV head: a group of 3, which the kernels do not take.
    layers["wq"] = layers["wq"][..., :3 * hd]
    layers["wk"] = layers["wk"][..., :hd]
    try:
        attention.set_attention_impl("flash")
        with pytest.raises(ValueError, match="head shard"):
            attention.flash_eligible(16, cfg.backbone, layers)
        attention.set_attention_impl("xla")
        assert not attention.flash_eligible(16, cfg.backbone, layers)
    finally:
        attention.set_attention_impl("auto")
