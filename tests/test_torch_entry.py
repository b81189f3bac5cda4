"""The port's driver entry points (``csm_tpu_torch.entry``, the counterpart
of ``__graft_entry__.py``) on the CPU.

``dryrun_multichip(4, device="cpu", params=...)`` runs on four spawned gloo
ranks (data 1 x seq 2 x model 2) from the JAX package's
``init_params(key(0))`` and is held against the JAX step built as
``__graft_entry__.dryrun_multichip`` builds it, on the same mesh of the
virtual CPU devices: loss, backbone and decoder losses within rtol 2e-4 /
atol 2e-5 (the fixtures' tolerance).  ``entry()`` needs the card; its forward
runs here at ``CSMConfig.tiny()`` only (CSM-1B is left to the card)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu.config import CSMConfig as JaxCSMConfig
from csm_tpu.models import csm as jcsm
from csm_tpu_torch import CSMConfig
from csm_tpu_torch import entry as entry_mod
from csm_tpu_torch.entry import dryrun_batch, dryrun_multichip, entry, mesh_axes

RTOL, ATOL = 2e-4, 2e-5
LOSSES = ("loss", "backbone_loss", "decoder_loss")


def test_entry_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun_multichip(2)


def test_entry_forward_at_tiny_width(monkeypatch):
    """``fn(*example_args)`` on zero weights: finite c0 logits of shape
    ``[1, audio_vocab_size]`` (all zero), from a ``[1, 128, 33]`` prompt."""
    monkeypatch.setattr(entry_mod, "CSMConfig", CSMConfig.tiny)
    fn, args = entry(device="cpu")
    params, ids, mask = args
    assert ids.shape == mask.shape == (1, 128, 33)
    assert params["backbone"]["final_norm"].dtype == torch.bfloat16
    logits = fn(*args)
    assert logits.shape == (1, CSMConfig.tiny().audio_vocab_size)
    assert torch.isfinite(logits.float()).all() and not logits.any()


@pytest.mark.parametrize("n,want", [(1, (1, 1, 1)), (2, (1, 1, 2)), (3, (3, 1, 1)),
                                    (4, (1, 2, 2)), (8, (2, 2, 2))])
def test_mesh_axes_follow_the_jax_rule(n, want):
    assert tuple(mesh_axes(n).values()) == want
    assert list(mesh_axes(n)) == ["data", "seq", "model"]


def test_dryrun_batch_is_the_jax_batch():
    cfg = CSMConfig.tiny()
    b = dryrun_batch(cfg, 2)
    rng = np.random.default_rng(0)
    want = np.concatenate([rng.integers(0, cfg.audio_vocab_size, (2, 2, 16, 32)),
                           rng.integers(0, cfg.text_vocab_size, (2, 2, 16, 1))], axis=-1)
    np.testing.assert_array_equal(b["input_ids"], want)
    np.testing.assert_array_equal(b["labels"], want)
    assert b["attention_mask"].shape == (2, 2, 16, 33) and b["attention_mask"].all()


@functools.lru_cache(maxsize=None)
def _jax_dryrun(n_devices: int) -> dict:
    """The JAX step of ``__graft_entry__.dryrun_multichip(n_devices)``, built
    as it builds it, its metrics at full precision."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from csm_tpu.parallel.mesh import make_mesh, param_sharding
    from csm_tpu.train.loop import TrainState, make_optimizer, make_train_step

    model_axis = 2 if n_devices % 2 == 0 else 1
    seq_axis = 2 if n_devices % 4 == 0 else 1
    mesh = make_mesh(data=n_devices // (model_axis * seq_axis), model=model_axis,
                     seq=seq_axis)
    config = JaxCSMConfig.tiny()
    dp = int(mesh.shape["data"])
    accum, B, S = 2, dp, 16
    rng = np.random.default_rng(0)
    batch = {
        "input_ids": jnp.asarray(np.concatenate([
            rng.integers(0, config.audio_vocab_size, (accum, B, S, 32)),
            rng.integers(0, config.text_vocab_size, (accum, B, S, 1)),
        ], axis=-1)),
        "attention_mask": jnp.ones((accum, B, S, config.frame_width), jnp.float32),
    }
    batch["labels"] = batch["input_ids"]
    optimizer = make_optimizer(1e-4, total_steps=10)
    step_fn = make_train_step(config, optimizer, max_decoder_frames=8,
                              sp_mesh=mesh if seq_axis > 1 else None,
                              decoder_frame_sharding=("data", "seq"))
    with mesh:
        params = jcsm.init_params(jax.random.key(0), config)
        params = jax.device_put(params, param_sharding(mesh, params))
        opt_state = jax.jit(optimizer.init)(params)
        state = TrainState(params=params, opt_state=opt_state, step=jnp.int32(0))
        mb_sharding = NamedSharding(mesh, P(None, "data", "seq"))
        batch = {k: jax.device_put(v, mb_sharding) for k, v in batch.items()}
        _, metrics = jax.jit(step_fn)(state, None, batch)
    return dict(mesh=dict(mesh.shape), **{k: float(metrics[k]) for k in LOSSES})


def test_dryrun_matches_the_jax_dryrun(capsys):
    jparams = jax.tree.map(np.asarray, jcsm.init_params(jax.random.key(0), JaxCSMConfig.tiny()))
    got = dryrun_multichip(4, device="cpu", params=jparams)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    want = _jax_dryrun(4)
    assert line.startswith(f"dryrun_multichip ok: mesh={want['mesh']} loss=")
    for k in LOSSES:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)
    assert np.isfinite(got["grad_norm"])
