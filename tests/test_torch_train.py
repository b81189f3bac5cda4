"""The port's training path (csm_tpu_torch.train, models.llama remat) on the
CPU against the JAX package's: CSMConfig.tiny(), fp32, the same weights
(csm_tpu.models.csm.init_params through params_from_jax) and the same numpy
batches.  On the CPU both take plain attention (the JAX train step takes XLA
attention there); the flash kernels' path is held to the plain one on the
card (tests/test_torch_cuda.py).

Tolerances: losses and grad norm rtol 1e-5, gradients rtol 1e-4 / atol 1e-6
(fp32, another summation order).  Adam's first update is ``lr * g / (|g| +
eps)``, which flips with the last bit of a gradient near eps, so updated
parameters are compared where ``|g| > 1e-6``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from csm_tpu.config import CSMConfig as JaxCSMConfig
from csm_tpu.data.collator import CSMDataCollator as JaxCollator
from csm_tpu.models import csm as jcsm
from csm_tpu.train import loop as jloop
from csm_tpu.train import lora as jlora
from csm_tpu_torch import CSMConfig, CSMModel
from csm_tpu_torch.checkpoint import latest_step, load_checkpoint, params_from_jax
from csm_tpu_torch.data import CSMDataCollator
from csm_tpu_torch.models import csm, llama
from csm_tpu_torch.ops import flash_attention as fa
from csm_tpu_torch.train import CSMTrainer, TrainingArguments, make_optimizer, make_train_step
from csm_tpu_torch.train.args import parse_args
from csm_tpu_torch.train.loop import flatten, global_norm
from csm_tpu_torch.train.lora import apply_lora, init_lora_params, merge_lora
from csm_tpu_torch.train.reporting import make_reporter
from oracle import random_csm_batch


class SyntheticDataset:
    """Fixed random conversations, epoch-repeated like the real dataset (as
    tests/test_train_loop.py's)."""

    amortization_ratio = 4

    def __init__(self, cfg, n=4, seq=12, epochs=4):
        self.data = [random_csm_batch(cfg, 1, seq, seed=100 + i) for i in range(n)]
        self.epochs = epochs
        self.loaded = []

    def __len__(self):
        return len(self.data) * self.epochs

    def __getitem__(self, idx):
        self.loaded.append(idx)
        d = self.data[idx % len(self.data)]
        return {k: d[k][0] for k in ("input_ids", "attention_mask", "labels")}


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxCSMConfig.tiny()
    jp = jcsm.init_params(jax.random.key(0), jcfg)
    np_params = jax.tree.map(np.asarray, jp)
    return jcfg, np_params, CSMConfig.tiny()


def _port_params(tiny):
    _, np_params, cfg = tiny
    return params_from_jax(np_params, cfg, "cpu")


def _batch(cfg, accum=2, B=2, S=16, seed=3):
    d = random_csm_batch(cfg, accum * B, S, seed=seed)
    return {k: v.reshape(accum, B, S, -1) for k, v in d.items()}


def _close(a, b, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


def _args(tmp_path, **kw):
    base = dict(output_dir=str(tmp_path), learning_rate=5e-3, per_device_train_batch_size=1,
                gradient_accumulation_steps=2, max_seq_length=16, save_strategy="no", seed=42)
    base.update(kw)
    return TrainingArguments(**base)


def _trainer(tiny, tmp_path, ds=None, eval_ds=None, **kw):
    cfg = tiny[2]
    ds = ds if ds is not None else SyntheticDataset(cfg, n=4, seq=12, epochs=2)
    return CSMTrainer(cfg, _port_params(tiny), _args(tmp_path, **kw), ds, eval_dataset=eval_ds,
                      data_collator=CSMDataCollator(text_pad_token_id=0, pad_to_length=16),
                      device="cpu")


# ---------------------------------------------------------------------------
# The train step against JAX's
# ---------------------------------------------------------------------------


def test_one_step_matches_jax(tiny):
    """One step, accum 2, B 2, S 16: the losses, grad norm, gradients and the
    AdamW update equal the JAX train step's."""
    jcfg, np_params, cfg = tiny
    batch = _batch(cfg)
    max_dec = 10
    kw = dict(learning_rate=1e-3, total_steps=10, weight_decay=0.01, max_grad_norm=1e3)
    jopt = jloop.make_optimizer(**kw)
    jp = jax.tree.map(jnp.asarray, np_params)
    jstate = jloop.TrainState(params=jp, opt_state=jopt.init(jp), step=jnp.int32(0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep = jax.jit(jloop.make_train_step(jcfg, jopt, max_dec, remat=False))
    jnew, jm = jstep(jstate, None, jbatch)

    def jloss(p):
        total = 0.0
        for a in range(2):
            out = jcsm.forward(p, jcfg, jbatch["input_ids"][a], jbatch["attention_mask"][a],
                               labels=jbatch["labels"][a], max_decoder_frames=max_dec)
            total = total + out.loss
        return total / 2

    jgrads = jax.tree.map(np.asarray, jax.jit(jax.grad(jloss))(jp))

    opt = make_optimizer(**kw)
    state = opt.init(params_from_jax(np_params, cfg, "cpu"))
    step = make_train_step(cfg, opt, max_dec, remat=False)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    state, m = step(state, None, tbatch)
    assert state.step == 1
    for k in ("loss", "backbone_loss", "decoder_loss", "grad_norm"):
        _close(float(m[k]), float(jm[k]), 1e-5, msg=k)
    jflat = flatten(jax.tree.map(lambda x: x, jgrads))
    jnew_flat = flatten(jax.tree.map(np.asarray, jnew.params))
    for name, p in flatten(state.params).items():
        g = p.grad.numpy()
        _close(g, jflat[name], 1e-4, 1e-6, msg=f"grad {name}")
        big = np.abs(jflat[name]) > 1e-6
        _close(p.detach().numpy()[big], jnew_flat[name][big], 1e-6, 1e-7, msg=f"param {name}")


@pytest.mark.parametrize("warmup", [0, 2])
def test_schedule_matches_optax(warmup):
    """The learning rate of each of 6 updates, read off the JAX optimizer as
    its update of a unit gradient over the same chain's at lr 1: optax's
    ``join_schedules`` indexing, lr 0 first with warmup."""
    jopt = jloop.make_optimizer(0.1, total_steps=6, warmup_steps=warmup)
    unit = optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(1.0, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0))
    p = {"w": jnp.zeros((1,), jnp.float32)}
    g = {"w": jnp.ones((1,), jnp.float32)}
    st, su = jopt.init(p), unit.init(p)
    want = []
    for _ in range(6):
        upd, st = jopt.update(g, st, p)
        ref, su = unit.update(g, su, p)
        want.append(float(upd["w"][0]) / float(ref["w"][0]))
    got = [make_optimizer(0.1, total_steps=6, warmup_steps=warmup).lr(t) for t in range(6)]
    _close(got, want, 1e-6, 1e-9)
    assert (got[0] == 0.0) == (warmup > 0)


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_matches_optax(scale):
    rng = np.random.default_rng(4)
    grads = [rng.standard_normal(s).astype(np.float32) * scale for s in ((3, 4), (5,), (2, 2, 2))]
    clip = optax.clip_by_global_norm(1.0)
    want, _ = clip.update([jnp.asarray(g) for g in grads], clip.init(None))
    tg = [torch.as_tensor(g.copy()) for g in grads]
    norm = make_optimizer(1.0, 1, max_grad_norm=1.0).clip_(tg)
    _close(float(norm), float(optax.global_norm([jnp.asarray(g) for g in grads])), 1e-6)
    assert (float(norm) < 1.0) == (scale == 0.1)
    for a, b in zip(tg, want):
        _close(a.numpy(), b, 1e-6, 1e-7)


def test_bf16_compute_keeps_fp32_grads(tiny):
    cfg = tiny[2]
    opt = make_optimizer(1e-3, 4)
    state = opt.init(_port_params(tiny))
    before = {k: v.detach().clone() for k, v in flatten(state.params).items()}
    step = make_train_step(cfg, opt, 10, compute_dtype=torch.bfloat16, remat=False)
    state, m = step(state, None, {k: torch.as_tensor(v) for k, v in _batch(cfg).items()})
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    for name, p in flatten(state.params).items():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
    assert not torch.equal(before["projection"], state.params["projection"].detach())


# ---------------------------------------------------------------------------
# Remat
# ---------------------------------------------------------------------------


def _step_grads(tiny, **kw):
    cfg = tiny[2]
    opt = make_optimizer(1e-3, 4)
    state = opt.init(_port_params(tiny))
    step = make_train_step(cfg, opt, 10, **kw)
    state, m = step(state, None, {k: torch.as_tensor(v) for k, v in _batch(cfg).items()})
    return {k: p.grad.clone() for k, p in flatten(state.params).items()}, float(m["loss"])


@pytest.mark.parametrize("policy", ["nothing", "dots", "auto"])
def test_remat_policies_give_the_no_remat_grads(tiny, policy):
    want, loss = _step_grads(tiny, remat=False)
    got, loss2 = _step_grads(tiny, remat=True, remat_policy=policy)
    _close(loss2, loss, 1e-6)
    for k in want:
        _close(got[k].numpy(), want[k].numpy(), 1e-6, 1e-9, msg=k)


@pytest.mark.parametrize("policy,forwards", [("nothing", 2), ("dots", 1)])
def test_dots_keeps_the_flash_output(tiny, monkeypatch, policy, forwards):
    """Through the flash op (on the CPU: its plain versions), ``"nothing"``
    re-runs each layer's flash forward in the backward and ``"dots"`` keeps
    its output; the gradients equal those without remat."""
    cfg = tiny[2]
    calls = []
    orig = fa.flash_attention_reference

    def spy(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention_reference", spy)
    rng = np.random.default_rng(6)
    B, S, D = 2, 16, cfg.backbone.hidden_size
    x = torch.as_tensor(rng.standard_normal((B, S, D)).astype(np.float32))
    valid = torch.ones((B, S), dtype=torch.int32)
    valid[1, :5] = 0
    rope = csm.compute_rope_table(cfg.backbone, S, torch.device("cpu"))
    pos = torch.arange(S).expand(B, S)
    grads = []
    for remat in (False, True):
        params = {k: (v.requires_grad_(True) if torch.is_tensor(v) else v)
                  for k, v in _port_params(tiny)["backbone"].items()}
        params["layers"] = {k: v.requires_grad_(True) for k, v in params["layers"].items()}
        calls.clear()
        h, _ = llama.forward(params, cfg.backbone, x, rope_table=rope, positions=pos,
                             attn_bias=None, flash_key_valid=valid, remat=remat,
                             remat_policy=policy)
        (h * valid[..., None]).square().sum().backward()
        L = cfg.backbone.num_hidden_layers
        assert len(calls) == (forwards if remat else 1) * L
        grads.append(params["layers"]["wq"].grad)
    _close(grads[1].numpy(), grads[0].numpy(), 1e-6, 1e-9)


def test_remat_policy_typo_raises(tiny):
    cfg = tiny[2]
    opt = make_optimizer(1e-3, 1)
    for bad in ("dot", "Dots"):
        with pytest.raises(ValueError, match="remat_policy"):
            make_train_step(cfg, opt, max_decoder_frames=2, remat_policy=bad)
    p = _port_params(tiny)
    x = torch.zeros((1, 4, cfg.backbone.hidden_size))
    rope = csm.compute_rope_table(cfg.backbone, 4, torch.device("cpu"))
    with pytest.raises(ValueError, match="remat_policy"):
        llama.forward(p["backbone"], cfg.backbone, x, rope_table=rope,
                      positions=torch.arange(4)[None], attn_bias=None, remat=True,
                      remat_policy="everything")


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------


def test_lora_init_is_identity(tiny):
    params = _port_params(tiny)
    lora = init_lora_params(torch.Generator().manual_seed(1), params, rank=4)
    assert lora["backbone"]["wq"]["A"].shape == (2, 64, 4)
    assert (lora["decoder"]["wv"]["B"] == 0).all()
    merged = apply_lora(params, lora, alpha=16.0, rank=4)
    for k, v in flatten(params).items():
        assert torch.equal(flatten(merged)[k], v), k


def test_lora_merge_matches_jax(tiny):
    """On JAX-initialized adapters with a nonzero B: ``apply_lora`` and
    ``merge_lora`` equal JAX's."""
    jcfg, np_params, cfg = tiny
    jl = jax.tree.map(lambda x: x + 0.01, jlora.init_lora_params(jax.random.key(2), np_params, 2))
    want = flatten(jax.tree.map(np.asarray, jlora.merge_lora(np_params, jl, 8.0, 2)))
    lora = jax.tree.map(lambda x: torch.tensor(np.asarray(x)), jl)
    params = _port_params(tiny)
    for merged in (apply_lora(params, lora, 8.0, 2), merge_lora(params, lora, 8.0, 2)):
        for k, v in flatten(merged).items():
            _close(v.numpy(), want[k], 1e-6, 1e-8, msg=k)
    assert not torch.equal(flatten(merged)["backbone.layers.wq"],
                           flatten(params)["backbone.layers.wq"])


def test_lora_step_updates_only_the_adapters(tiny):
    cfg = tiny[2]
    base = _port_params(tiny)
    before = {k: v.clone() for k, v in flatten(base).items()}
    lora = init_lora_params(torch.Generator().manual_seed(3), base, rank=2, targets=("wq", "wv"))
    opt = make_optimizer(1e-3, 4)
    state = opt.init(lora)
    step = make_train_step(cfg, opt, 10, lora_cfg={"alpha": 16.0, "rank": 2}, remat=False)
    b0 = state.params["backbone"]["wv"]["B"].detach().clone()
    state, m = step(state, base, {k: torch.as_tensor(v) for k, v in _batch(cfg).items()})
    assert np.isfinite(float(m["loss"]))
    for k, v in flatten(base).items():
        assert torch.equal(v, before[k]) and not v.requires_grad, k
    assert not torch.equal(state.params["backbone"]["wv"]["B"].detach(), b0)
    assert set(flatten(state.params)) == {f"{s}.{t}.{m}" for s in ("backbone", "decoder")
                                          for t in ("wq", "wv") for m in ("A", "B")}


# ---------------------------------------------------------------------------
# CSMTrainer
# ---------------------------------------------------------------------------


def test_trainer_matches_jax_trainer(tiny, tmp_path):
    """Three steps (6 items, accum 2) of the port's trainer and of JAX's
    (mesh data=1, model=1) on the same dataset: the same losses."""
    from csm_tpu.parallel.mesh import make_mesh
    from csm_tpu.train.args import TrainingArguments as JaxArgs

    jcfg, np_params, cfg = tiny
    common = dict(learning_rate=5e-3, per_device_train_batch_size=1,
                  gradient_accumulation_steps=2, max_seq_length=16, save_strategy="no", seed=42)
    jargs = JaxArgs(output_dir=str(tmp_path / "jax"), mesh_data=1, mesh_model=1, **common)
    jtrainer = jloop.CSMTrainer(
        jcfg, jax.tree.map(jnp.asarray, np_params), jargs, SyntheticDataset(jcfg, n=3, epochs=2),
        data_collator=JaxCollator(text_pad_token_id=0, pad_to_length=16),
        mesh=make_mesh(data=1, model=1),
    )
    jtrainer.train()
    trainer = _trainer(tiny, tmp_path / "port", ds=SyntheticDataset(cfg, n=3, epochs=2))
    assert trainer.total_steps == jtrainer.total_steps == 3
    assert trainer._max_dec == jtrainer._max_dec
    trainer.train()
    assert len(trainer._metrics_log) == len(jtrainer._metrics_log) == 3
    for a, b in zip(trainer._metrics_log, jtrainer._metrics_log):
        for k in ("loss", "backbone_loss", "decoder_loss"):
            _close(a[k], b[k], 1e-4, msg=f"step {a['step']} {k}")


def test_epoch_to_steps_rescheduling(tiny, tmp_path):
    # 4 items / (bs 1 x accum 2) = 2 steps per old epoch
    trainer = _trainer(tiny, tmp_path, save_strategy="epoch")
    assert trainer.steps_per_old_epoch == 2 and trainer.save_steps == 2
    assert trainer.total_steps == 4
    assert _trainer(tiny, tmp_path, save_strategy="steps", save_steps=3).save_steps == 6


def test_partial_accumulation_window_is_trained(tiny, tmp_path):
    ds = SyntheticDataset(tiny[2], n=5, epochs=1)  # 5 items, 4 per step
    trainer = _trainer(tiny, tmp_path, ds=ds, per_device_train_batch_size=2)
    assert trainer.total_steps == 2
    trainer.train()
    assert trainer.state.step == 2
    assert sorted(set(ds.loaded)) == [0, 1, 2, 3, 4]


def test_checkpoint_rotation_and_resume_fast_forward(tiny, tmp_path):
    """Saves every old epoch (2 steps) keep the newest ``save_total_limit``;
    a resumed trainer restores params, moments and step and never loads the
    items of the steps already done."""
    trainer = _trainer(tiny, tmp_path, save_strategy="steps", save_steps=1, save_total_limit=2)
    assert trainer.save_steps == 2
    trainer.train()  # 8 items, 2 per step: 4 steps, saved at 2 and 4
    ckpt = str(tmp_path / "checkpoints")
    trainer.save_checkpoint(6)  # rotation drops 2
    assert latest_step(ckpt) == 6
    assert sorted(int(d) for d in os.listdir(ckpt)) == [4, 6]
    saved = load_checkpoint(ckpt)
    assert saved["step"] == 6
    assert torch.equal(saved["params"]["projection"], trainer.state.params["projection"].detach())

    ds = SyntheticDataset(tiny[2], n=4, epochs=4)  # 16 items: 8 steps
    resumed = _trainer(tiny, tmp_path, ds=ds, resume_from_checkpoint=True)
    assert resumed._maybe_resume() == 6 and resumed.state.step == 6
    assert torch.equal(resumed.state.params["projection"].detach(),
                       trainer.state.params["projection"].detach())
    a = trainer.state.optimizer.state_dict()["state"]
    b = resumed.state.optimizer.state_dict()["state"]
    assert all(torch.equal(a[i]["exp_avg"], b[i]["exp_avg"]) for i in a)
    resumed.train()
    assert min(ds.loaded) >= 12 and resumed.state.step == 8


def test_evaluate_is_token_weighted_with_a_partial_batch(tiny, tmp_path):
    """Batch 2 over 3 ragged items: the trailing item is padded with a
    label-masked copy, and ``eval_loss`` equals the per-item forwards
    aggregated by target count."""
    cfg = tiny[2]
    train_ds = SyntheticDataset(cfg, n=4, epochs=1)
    train_ds.amortization_ratio = 1  # decoder-frame cap covers every frame
    eval_ds = SyntheticDataset(cfg, n=3, epochs=1)
    eval_ds.data = [random_csm_batch(cfg, 1, s, seed=200 + s) for s in (8, 11, 14)]
    trainer = _trainer(tiny, tmp_path, ds=train_ds, eval_ds=eval_ds,
                       per_device_train_batch_size=2)
    got = trainer.evaluate()
    coll = CSMDataCollator(text_pad_token_id=0, pad_to_length=16)
    sums = np.zeros(4)
    for i in range(3):
        b = {k: torch.as_tensor(v) for k, v in coll([eval_ds[i]]).items()}
        with torch.no_grad():
            out = csm.forward(trainer.model_params(), cfg, b["input_ids"], b["attention_mask"],
                              labels=b["labels"])
        sums += [float(out.backbone_loss) * float(out.backbone_targets),
                 float(out.backbone_targets),
                 float(out.decoder_loss) * float(out.decoder_targets),
                 float(out.decoder_targets)]
    _close(got, sums[0] / sums[1] + sums[2] / sums[3], 1e-5)
    eval_ds.data = eval_ds.data[:2]
    assert abs(trainer.evaluate() - got) > 1e-9


def test_prefetch_keeps_training_deterministic(tiny, tmp_path):
    """Prefetched and synchronous runs give the same losses (rtol 1e-6, as
    the JAX package's test: the CPU's BLAS may split a product among its
    threads differently under load)."""
    losses = []
    for depth in (0, 2):
        trainer = _trainer(tiny, tmp_path / f"d{depth}", dataloader_prefetch=depth)
        losses.append([m["loss"] for m in (trainer.train(), *trainer._metrics_log)])
    _close(losses[0], losses[1], 1e-6)


def test_save_model_loads_with_from_pretrained(tiny, tmp_path):
    trainer = _trainer(tiny, tmp_path)
    trainer.train()
    trainer.save_model(str(tmp_path / "model"))
    model = CSMModel.from_pretrained(str(tmp_path / "model"), device="cpu")
    for k, v in flatten(trainer.model_params()).items():
        assert torch.equal(flatten(model.params)[k], v), k


def test_lora_trainer_saves_the_merged_model_and_adapters(tiny, tmp_path):
    trainer = _trainer(tiny, tmp_path, lora_rank=2, lora_targets="wq,wv")
    trainer.train()
    assert trainer.state.step == 4
    merged = trainer.model_params()
    assert not torch.equal(merged["backbone"]["layers"]["wv"],
                           trainer.base_params["backbone"]["layers"]["wv"])
    trainer.save_model(str(tmp_path / "model"))
    model = CSMModel.from_pretrained(str(tmp_path / "model"), device="cpu")
    for k, v in flatten(merged).items():
        assert torch.equal(flatten(model.params)[k], v), k
    adapters = load_checkpoint(str(tmp_path / "model" / "adapters"))["lora"]
    assert torch.equal(adapters["decoder"]["wq"]["B"],
                       trainer.state.params["decoder"]["wq"]["B"].detach())


def test_args_defaults_and_unported_mesh(tmp_path):
    _, _, targs = parse_args(["--output_dir", str(tmp_path), "--no-gradient_checkpointing"])
    assert targs.learning_rate == 5e-6 and targs.gradient_accumulation_steps == 8
    assert targs.gradient_checkpointing is False and targs.save_total_limit == 3
    assert targs.gradient_checkpointing_policy == "auto"
    assert (targs.mesh_data, targs.mesh_seq, targs.mesh_model) == (None, 1, 1)
    # Data, sequence and tensor parallelism are all ported.
    _, _, targs = parse_args(["--mesh_data", "2", "--mesh_seq", "2"])
    assert (targs.mesh_data, targs.mesh_seq) == (2, 2)
    assert TrainingArguments(mesh_model=2).mesh_model == 2
    _, _, targs = parse_args(["--mesh_model", "2"])
    assert (targs.mesh_data, targs.mesh_seq, targs.mesh_model) == (None, 1, 2)
    with pytest.raises(ValueError, match="mesh_seq"):
        TrainingArguments(mesh_seq=0)
    with pytest.raises(ValueError, match="mesh_model"):
        TrainingArguments(mesh_model=0)


def test_report_to_unknown_raises(tmp_path):
    with pytest.raises(ValueError, match="report_to"):
        make_reporter("wandb", str(tmp_path))
    make_reporter("none", str(tmp_path)).close()


def test_global_norm_sums_in_fp32():
    t = [torch.full((3,), 2.0, dtype=torch.bfloat16), torch.ones(2)]
    assert float(global_norm(t)) == pytest.approx(np.sqrt(14.0))
