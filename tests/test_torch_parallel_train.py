"""The port's data- and sequence-parallel train step and trainer on spawned
``gloo`` ranks on the CPU, against the JAX package's ``make_train_step(...,
sp_mesh=make_mesh(data=d, seq=s, model=1))`` on the 8-device virtual CPU
mesh of tests/conftest.py and against the port's one-process step, on the
same weights (``params_from_jax``) and global batch (``random_csm_batch``).
CSMConfig.tiny(), fp32.

Tolerances (tests/test_torch_train.py's): losses and grad norm rtol 1e-5;
gradients rtol 1e-4 / atol 1e-6; updated parameters rtol 1e-4 / atol 1e-6
where ``|g| > 1e-6`` (Adam's first update ``lr * g / (|g| + eps)`` flips
with the last bit of a gradient near eps).  The ranks' parameters are
compared bitwise: the summed gradients are the same bits on every rank.

Ranks import this module; JAX is imported only inside the reference
functions."""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from csm_tpu_torch import CSMConfig
from csm_tpu_torch.checkpoint import params_from_jax
from csm_tpu_torch.data import CSMDataCollator
from csm_tpu_torch.models import csm
from csm_tpu_torch.parallel import make_mesh
from csm_tpu_torch.parallel.launch import launch, to_numpy
from csm_tpu_torch.train import CSMTrainer, TrainingArguments, make_optimizer, make_train_step
from csm_tpu_torch.train.loop import flatten
from oracle import random_csm_batch

LAUNCH_TIMEOUT = 120.0
OPT = dict(learning_rate=1e-3, total_steps=10, weight_decay=0.01, max_grad_norm=1e3)
MAX_DEC = 10
METRICS = ("loss", "backbone_loss", "decoder_loss", "grad_norm")


def _close(a, b, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


@functools.lru_cache(maxsize=None)
def _jax_params():
    import jax

    from csm_tpu.config import CSMConfig as JaxCSMConfig
    from csm_tpu.models import csm as jcsm

    jcfg = JaxCSMConfig.tiny()
    return jcfg, jax.tree.map(np.asarray, jcsm.init_params(jax.random.key(0), jcfg))


def _global_batch(accum=2, B=2, S=16, seed=3):
    """``[accum, B, S, 33]``; row 0 of each microbatch starts with an audio
    frame whose labels are all present, so its decoder frame wraps to
    ``S - 1`` (the last seq rank)."""
    cfg = CSMConfig.tiny()
    d = random_csm_batch(cfg, accum * B, S, seed=seed)
    N = cfg.audio_num_codebooks
    rng = np.random.default_rng(seed)
    for b in range(0, accum * B, B):
        d["input_ids"][b, 0] = 0
        d["input_ids"][b, 0, :N] = rng.integers(1, cfg.audio_vocab_size, N)
        d["attention_mask"][b, 0] = 0
        d["attention_mask"][b, 0, :N] = 1
        d["labels"][b, 0] = -100
        d["labels"][b, 0, :N] = d["input_ids"][b, 0, :N]
    return {k: v.reshape(accum, B, S, -1) for k, v in d.items()}


@functools.lru_cache(maxsize=None)
def _jax_step(data, seq):
    """The JAX train step with ``sp_mesh`` over ``data`` x ``seq`` virtual
    devices: metrics and the updated parameters (flat)."""
    import jax
    import jax.numpy as jnp

    from csm_tpu.parallel.mesh import make_mesh as jmake_mesh
    from csm_tpu.train import loop as jloop

    jcfg, np_params = _jax_params()
    jopt = jloop.make_optimizer(**OPT)
    jp = jax.tree.map(jnp.asarray, np_params)
    state = jloop.TrainState(params=jp, opt_state=jopt.init(jp), step=jnp.int32(0))
    step = jax.jit(jloop.make_train_step(jcfg, jopt, MAX_DEC, remat=False,
                                         sp_mesh=jmake_mesh(data=data, seq=seq, model=1)))
    new, m = step(state, None, {k: jnp.asarray(v) for k, v in _global_batch().items()})
    return ({k: float(m[k]) for k in METRICS},
            flatten(jax.tree.map(np.asarray, new.params)))


@functools.lru_cache(maxsize=None)
def _one_process_step():
    """The port's step in this process: metrics, gradients, parameters."""
    cfg = CSMConfig.tiny()
    opt = make_optimizer(**OPT)
    state = opt.init(params_from_jax(_jax_params()[1], cfg, "cpu"))
    step = make_train_step(cfg, opt, MAX_DEC, remat=False)
    state, m = step(state, None, {k: torch.as_tensor(v) for k, v in _global_batch().items()})
    flat = flatten(state.params)
    return ({k: float(m[k]) for k in METRICS},
            {k: p.grad.numpy().copy() for k, p in flat.items()},
            {k: p.detach().numpy().copy() for k, p in flat.items()})


def _train_rank(data, seq, np_params, batch, remat_policy, use_flash):
    cfg = CSMConfig.tiny()
    mesh = make_mesh(data=data, seq=seq)
    opt = make_optimizer(**OPT)
    state = opt.init(params_from_jax(np_params, cfg, "cpu"))
    step = make_train_step(cfg, opt, MAX_DEC, remat=remat_policy is not None,
                           remat_policy=remat_policy or "auto", use_flash=use_flash, mesh=mesh)
    state, m = step(state, None, {k: torch.as_tensor(v) for k, v in batch.items()})
    flat = flatten(state.params)
    return dict(metrics={k: float(m[k]) for k in METRICS}, coords=mesh.coords,
                grads={k: p.grad for k, p in flat.items()},
                params={k: p.detach() for k, p in flat.items()})


@pytest.mark.parametrize("data,seq,remat_policy,use_flash", [
    (1, 2, "dots", True),     # flash_attention_sp, selective remat
    (2, 1, None, True),       # data parallel only
    (2, 2, "nothing", True),  # both axes, full remat
    (1, 2, None, False),      # plain attention over the gathered K / V
])
def test_sharded_step_matches_jax_and_one_process(data, seq, remat_policy, use_flash):
    """One step, accum 2, global B 2, S 16 on ``data`` x ``seq`` ranks: rank
    0's losses and grad norm equal the JAX step's (with its ``sp_mesh``) and
    the one-process step's; its gradients the one-process gradients; its
    updated parameters the JAX step's; every rank's parameters are rank 0's
    bit for bit."""
    _, np_params = _jax_params()
    res = launch(_train_rank, data * seq, data, seq, np_params, _global_batch(), remat_policy,
                 use_flash, timeout=LAUNCH_TIMEOUT)
    jm, jparams = _jax_step(data, seq)
    om, ograds, _ = _one_process_step()
    r0 = res[0]
    for k in METRICS:
        _close(r0["metrics"][k], jm[k], 1e-5, msg=f"{k} vs JAX")
        _close(r0["metrics"][k], om[k], 1e-5, msg=f"{k} vs one process")
    for name, g in ograds.items():
        _close(r0["grads"][name], g, 1e-4, 1e-6, msg=f"grad {name}")
        big = np.abs(g) > 1e-6
        _close(r0["params"][name][big], jparams[name][big], 1e-4, 1e-6, msg=f"param {name}")
    for r, rec in enumerate(res[1:], start=1):
        assert rec["metrics"] == r0["metrics"], r
        for name, p in rec["params"].items():
            np.testing.assert_array_equal(p, r0["params"][name], err_msg=f"rank {r} {name}")


def _lora_step(np_params, mesh_shape):
    """One LoRA step (rank 2 adapters on wq, wv) on the port: metrics and
    the adapters' gradients and values; ``mesh_shape`` (data, seq) or None
    for one process."""
    from csm_tpu_torch.train.lora import init_lora_params

    cfg = CSMConfig.tiny()
    base = params_from_jax(np_params, cfg, "cpu")
    adapters = init_lora_params(torch.Generator().manual_seed(42), base, 2, ("wq", "wv"))
    opt = make_optimizer(**OPT)
    state = opt.init(adapters)
    mesh = None if mesh_shape is None else make_mesh(data=mesh_shape[0], seq=mesh_shape[1])
    step = make_train_step(cfg, opt, MAX_DEC, lora_cfg={"alpha": 16.0, "rank": 2}, remat=False,
                           mesh=mesh)
    state, m = step(state, base, {k: torch.as_tensor(v) for k, v in _global_batch().items()})
    flat = flatten(state.params)
    return dict(metrics={k: float(m[k]) for k in METRICS},
                grads={k: p.grad.clone() for k, p in flat.items()},
                params={k: p.detach().clone() for k, p in flat.items()})


def test_sharded_lora_step_matches_one_process():
    """LoRA on a data=1 x seq=2 mesh: the replicated adapters get the
    one-process step's gradients (their sum over the ranks) and losses, and
    stay bitwise equal across ranks."""
    _, np_params = _jax_params()
    res = launch(_lora_step, 2, np_params, (1, 2), timeout=LAUNCH_TIMEOUT)
    one = to_numpy(_lora_step(np_params, None))
    for k in METRICS:
        _close(res[0]["metrics"][k], one["metrics"][k], 1e-5, msg=k)
    for name, g in one["grads"].items():
        _close(res[0]["grads"][name], g, 1e-4, 1e-6, msg=f"grad {name}")
        np.testing.assert_array_equal(res[0]["params"][name], res[1]["params"][name])


# ---------------------------------------------------------------------------
# CSMTrainer on two ranks
# ---------------------------------------------------------------------------


class ItemsDataset:
    """Given ``[S, 33]`` items, epoch-repeated like the real dataset."""

    amortization_ratio = 4

    def __init__(self, items, epochs=1):
        self.data = items
        self.epochs = epochs

    def __len__(self):
        return len(self.data) * self.epochs

    def __getitem__(self, idx):
        return self.data[idx % len(self.data)]


def _items(cfg, n=4, seq=12):
    out = []
    for i in range(n):
        d = random_csm_batch(cfg, 1, seq, seed=100 + i)
        out.append({k: d[k][0] for k in ("input_ids", "attention_mask", "labels")})
    return out


def _args(out_dir, **kw):
    base = dict(output_dir=out_dir, learning_rate=5e-3, per_device_train_batch_size=1,
                gradient_accumulation_steps=2, max_seq_length=16, save_strategy="no", seed=42)
    base.update(kw)
    return base


def _trainer(cfg, np_params, out_dir, **kw):
    items = _items(cfg)
    return CSMTrainer(cfg, params_from_jax(np_params, cfg, "cpu"),
                      TrainingArguments(**_args(out_dir, **kw)), ItemsDataset(items),
                      eval_dataset=ItemsDataset(items[:3]),
                      data_collator=CSMDataCollator(text_pad_token_id=0, pad_to_length=16),
                      device="cpu")


def _trainer_rank(np_params, out_dir):
    """2 steps of a seq=2 trainer (its mesh made from the arguments), its
    evaluation, a checkpoint, and a resume onto other weights."""
    cfg = CSMConfig.tiny()
    trainer = _trainer(cfg, np_params, out_dir, mesh_seq=2)
    trainer.train()
    eval_loss = trainer.evaluate()
    trainer.save_checkpoint(trainer.state.step)
    saved = flatten(trainer.model_params())
    other = csm.init_params(cfg, seed=7)
    resumed = CSMTrainer(cfg, other, dataclasses.replace(trainer.args, resume_from_checkpoint=True),
                         trainer.train_dataset, data_collator=trainer.data_collator, device="cpu")
    at = resumed._maybe_resume()
    same = all(torch.equal(p, saved[k]) for k, p in flatten(resumed.model_params()).items())
    return dict(log=trainer._metrics_log, eval_loss=eval_loss, at=at, restored=same,
                mesh=dict(trainer.mesh.shape), global_batch=trainer.global_batch,
                rank=dist.get_rank())


def test_trainer_on_two_ranks_matches_jax_and_resumes(tmp_path):
    """``CSMTrainer`` with ``mesh_seq=2`` on 2 ranks: 2 steps whose losses
    equal the JAX trainer's on the same mesh shape (rtol 1e-4, as
    tests/test_torch_train.py holds the one-device trainers) and the port's
    one-process trainer's (rtol 1e-5); the same global eval loss on both
    ranks and in one process; one checkpoint, written by rank 0 and restored
    on every rank."""
    import jax
    import jax.numpy as jnp

    from csm_tpu.data.collator import CSMDataCollator as JaxCollator
    from csm_tpu.parallel.mesh import make_mesh as jmake_mesh
    from csm_tpu.train import loop as jloop
    from csm_tpu.train.args import TrainingArguments as JaxArgs

    jcfg, np_params = _jax_params()
    out_dir = str(tmp_path / "ranks")
    res = launch(_trainer_rank, 2, np_params, out_dir, timeout=LAUNCH_TIMEOUT)

    cfg = CSMConfig.tiny()
    single = _trainer(cfg, np_params, str(tmp_path / "single"))
    single.train()
    single_eval = single.evaluate()
    jtrainer = jloop.CSMTrainer(
        jcfg, jax.tree.map(jnp.asarray, np_params),
        JaxArgs(**_args(str(tmp_path / "jax"), mesh_data=1, mesh_seq=2, mesh_model=1)),
        ItemsDataset(_items(cfg)), data_collator=JaxCollator(text_pad_token_id=0, pad_to_length=16),
        mesh=jmake_mesh(data=1, seq=2, model=1))
    jtrainer.train()

    assert [r["rank"] for r in res] == [0, 1]
    for rec in res:
        assert rec["mesh"] == {"data": 1, "seq": 2, "model": 1} and rec["global_batch"] == 1
        assert rec["at"] == 2 and rec["restored"]
        assert len(rec["log"]) == len(jtrainer._metrics_log) == len(single._metrics_log) == 2
        _close(rec["eval_loss"], single_eval, 1e-5, msg="eval loss")
        for mine, jax_, one in zip(rec["log"], jtrainer._metrics_log, single._metrics_log):
            for k in ("loss", "backbone_loss", "decoder_loss"):
                _close(mine[k], jax_[k], 1e-4, msg=f"step {mine['step']} {k} vs JAX")
                _close(mine[k], one[k], 1e-5, msg=f"step {mine['step']} {k} vs one process")
    assert os.listdir(os.path.join(out_dir, "checkpoints")) == ["2"]
