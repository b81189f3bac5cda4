"""The port's tensor parallelism (the ``model`` mesh axis) on spawned ``gloo``
ranks on the CPU, against the JAX package on the 8-device virtual CPU mesh of
tests/conftest.py and against the port in one process, on the same weights
(``csm_tpu.models.csm.init_params(key(0))`` through ``params_from_jax``).
CSMConfig.tiny(), fp32: the backbone's 4 query / 2 KV heads shard at
``model=2``; the decoder's 2 / 1 keep replicated attention (the head-granular
rule of ``csm_tpu_torch.parallel.mesh``), its MLP shards; the 736-row audio
table shards, the 97-row text table and the 23-wide heads replicate.

Tolerances: generation tokens exactly; prefill logits rtol 2e-4 / atol 2e-5
(the golden-fixture tolerance); embedded frames bit for bit (each id's row
comes from one rank, then the one-process sum); train steps as
tests/test_torch_parallel_train.py (losses and grad norm rtol 1e-5, gathered
gradients and parameters rtol 1e-4 / atol 1e-6).

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
from csm_tpu_torch.checkpoint import load_checkpoint, params_from_jax
from csm_tpu_torch.checkpoint.safetensors_io import load_file
from csm_tpu_torch.data import CSMDataCollator
from csm_tpu_torch.generation import decode_frame, generate_compiled
from csm_tpu_torch.models import csm, llama
from csm_tpu_torch.parallel import Mesh, gather_params, make_mesh, param_sharding, shard_params
from csm_tpu_torch.parallel.launch import launch, to_numpy
from csm_tpu_torch.train import CSMTrainer, TrainingArguments, make_optimizer, make_train_step
from csm_tpu_torch.train.loop import flatten, map_tree
from oracle import random_csm_batch
from test_torch_parallel_train import (
    MAX_DEC,
    METRICS,
    OPT,
    ItemsDataset,
    _args,
    _close,
    _global_batch,
    _items,
    _jax_params,
    _one_process_step,
)

LAUNCH_TIMEOUT = 120.0
GEN_FRAMES = 3
# The decoder's attention projections: sharded by the JAX package's
# partitioner at model=2, replicated by the port (2 query / 1 KV head).
HEAD_GRANULAR = {f"decoder.layers.{w}" for w in ("wq", "wk", "wv", "wo")}


def _mesh_at(model_index: int, model: int = 2) -> Mesh:
    """A (1, 1, model) mesh at ``model_index`` without process groups (what
    ``shard_params`` reads)."""
    return Mesh(shape={"data": 1, "seq": 1, "model": model},
                coords={"data": 0, "seq": 0, "model": model_index},
                groups={"data": None, "seq": None, "model": None, "batch": None},
                rank=model_index)


def _gen_inputs():
    cfg = CSMConfig.tiny()
    d = random_csm_batch(cfg, 2, 10, seed=3)
    return d["input_ids"], d["attention_mask"].astype(np.float32)


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------


def test_shard_params_matches_jax_layout_and_concatenates_back():
    """Each leaf's shard at model=2 has the shape of the JAX package's
    addressable shards under ``shard_params(..., make_mesh(1, model=2))``,
    but for the named head-granular difference; the two ranks' shards
    concatenated along the cut dimension are the whole tensor bit for bit."""
    import jax

    from csm_tpu.parallel.mesh import make_mesh as jmake_mesh
    from csm_tpu.parallel.mesh import shard_params as jshard_params

    cfg = CSMConfig.tiny()
    jcfg, np_params = _jax_params()
    jflat = flatten(jshard_params(jax.tree.map(jax.numpy.asarray, np_params),
                                  jmake_mesh(data=1, model=2)))
    full = params_from_jax(np_params, cfg, "cpu")
    shards = [flatten(shard_params(full, _mesh_at(i), cfg)) for i in range(2)]
    specs = flatten(param_sharding(_mesh_at(0), full, cfg))
    assert specs == flatten(param_sharding(_mesh_at(0), config=cfg))
    n_cut = 0
    for name, whole in flatten(full).items():
        jshapes = {s.data.shape for s in jflat[name].addressable_shards}
        assert len(jshapes) == 1, name
        jshape = jshapes.pop()
        if name in HEAD_GRANULAR:
            assert tuple(shards[0][name].shape) == tuple(whole.shape), name
            assert jshape != tuple(whole.shape), name
        else:
            assert tuple(shards[0][name].shape) == jshape, name
        spec = specs[name]
        if "model" in spec:
            n_cut += 1
            d = spec.index("model")
            assert torch.equal(torch.cat([s[name] for s in shards], dim=d), whole), name
        else:
            assert all(s[name] is whole for s in shards), name
    # backbone: 7 matrices; decoder: its MLP's 3; the audio table.
    assert n_cut == 11


def test_head_rule_shards_csm_1b_attention_and_keeps_the_raw_table():
    """At CSM-1B width both stacks' attention shards at model=2 (32/8 and
    8/2 heads); at model=8 the backbone's does (32/8) and the decoder's (8 /
    2) does not; the raw table stays the JAX package's."""
    from csm_tpu.parallel import mesh as jmesh

    cfg = CSMConfig()
    two = param_sharding(_mesh_at(0), config=cfg)
    assert two["backbone"]["layers"]["wk"] == two["decoder"]["layers"]["wk"] == (
        None, None, "model")
    assert two["text_embeddings"] == two["audio_embeddings"] == ("model", None)
    assert two["codebook0_head"] == (None, None) and two["audio_head"] == (None, None, None)
    eight = param_sharding(_mesh_at(0, 8), config=cfg)
    assert eight["backbone"]["layers"]["wo"] == (None, "model", None)
    assert eight["decoder"]["layers"]["wo"] == (None, None, None)
    assert eight["decoder"]["layers"]["w_down"] == (None, "model", None)
    assert param_sharding()["decoder"]["layers"]["wo"] == tuple(
        jmesh._specs()["decoder"]["layers"]["wo"])
    with pytest.raises(ValueError, match="config"):
        param_sharding(_mesh_at(0), flatten(csm.init_params(CSMConfig.tiny())))


def test_kernel_bundles_and_shards_without_a_mesh_raise():
    """Under a model mesh the kernel bundles raise, naming the plain tier;
    shards without their mesh raise instead of running as whole weights."""
    cfg = CSMConfig.tiny()
    mesh = _mesh_at(0)
    full = csm.init_params(cfg)
    ids, mask = (torch.as_tensor(x) for x in _gen_inputs())
    for kw in (dict(qsb={}), dict(qdec={}), dict(qbb={}), dict(specdec=True)):
        with pytest.raises(ValueError, match="plain tier"):
            generate_compiled(full, cfg, ids, mask, 10, max_new_frames=1, greedy=True, mesh=mesh,
                              **kw)
    with pytest.raises(ValueError, match="plain tier"):
        csm.forward(full, cfg, ids, mask, qsb={}, mesh=mesh)
    with pytest.raises(ValueError, match="plain tier"):
        decode_frame(full, cfg, torch.zeros(2, 64), torch.zeros(2, 23), greedy=True, qdec={},
                     mesh=mesh)
    local = shard_params(full, mesh, cfg)
    with pytest.raises(ValueError, match="mesh"):
        csm.forward(local, cfg, ids, mask)


# ---------------------------------------------------------------------------
# Generation on (1, 1, 2)
# ---------------------------------------------------------------------------


def _jax_generate():
    import jax
    import jax.numpy as jnp

    from csm_tpu.generation import generate_compiled as jgenerate_compiled

    jcfg, np_params = _jax_params()
    ids, mask = _gen_inputs()
    frames, _ = jgenerate_compiled(
        jax.tree.map(jnp.asarray, np_params), jcfg, jnp.asarray(ids), jnp.asarray(mask),
        jnp.int32(ids.shape[1]), jax.random.key(7), max_new_frames=GEN_FRAMES, temperature=1.0,
        topk=5, greedy=True, stop_on_all_zeros=False)
    return np.asarray(frames)


def _jax_prefill_logits():
    import jax
    import jax.numpy as jnp

    from csm_tpu.models import csm as jcsm
    from csm_tpu.models.llama import KVCache as JaxKVCache

    jcfg, np_params = _jax_params()
    ids, mask = _gen_inputs()
    cache = JaxKVCache.create(jcfg.backbone, ids.shape[0], 128, dtype=jnp.float32)
    out = jcsm.forward(jax.tree.map(jnp.asarray, np_params), jcfg, jnp.asarray(ids),
                       jnp.asarray(mask), cache=cache, return_all_logits=True)
    return np.asarray(out.logits)


def _generation_run(params, cfg, mesh):
    """Greedy and sampled frames, the cached prefill's logits and the
    embedded frames (fp32 and bf16) of the test prompt, on ``params`` (this
    rank's shards under ``mesh``, or whole)."""
    ids, mask = (torch.as_tensor(x) for x in _gen_inputs())
    S = ids.shape[1]
    kw = dict(max_new_frames=GEN_FRAMES, topk=5, stop_on_all_zeros=False, mesh=mesh)
    greedy, _ = generate_compiled(params, cfg, ids, mask, S, greedy=True, **kw)
    sampled, _ = generate_compiled(params, cfg, ids, mask, S, temperature=0.9,
                                   generator=torch.Generator().manual_seed(11), **kw)
    nkv = llama.local_heads(params["backbone"]["layers"], cfg.backbone)[1]
    cache = llama.KVCache.create(cfg.backbone, ids.shape[0], 128, dtype=torch.float32,
                                 num_kv_heads=nkv)
    with torch.no_grad():
        logits = csm.forward(params, cfg, ids, mask, cache=cache, return_all_logits=True,
                             mesh=mesh).logits
        embedded = {str(dt): csm.embed_frames(map_tree(lambda t: t.to(dt), params), cfg, ids,
                                              mask.to(dt), mesh).float()
                    for dt in (torch.float32, torch.bfloat16)}
    return dict(greedy=greedy, sampled=sampled, logits=logits, embedded=embedded,
                kv_heads=nkv)


def _generation_rank(np_params):
    cfg = CSMConfig.tiny()
    mesh = make_mesh(data=1, model=2)
    full = params_from_jax(np_params, cfg, "cpu")
    local = shard_params(full, mesh, cfg)
    back = gather_params(local, mesh, cfg)
    rec = _generation_run(local, cfg, mesh)
    rec.update(gathered_equal=all(torch.equal(back_t, flatten(full)[k])
                                  for k, back_t in flatten(back).items()),
               mesh=dict(mesh.shape), coords=mesh.coords,
               group_sizes={a: (1 if g is None else dist.get_world_size(g))
                            for a, g in mesh.groups.items()})
    return rec


@pytest.fixture(scope="module")
def tp_generation():
    _, np_params = _jax_params()
    ranks = launch(_generation_rank, 2, np_params, timeout=LAUNCH_TIMEOUT)
    one = to_numpy(_generation_run(params_from_jax(np_params, CSMConfig.tiny(), "cpu"),
                                   CSMConfig.tiny(), None))
    return ranks, one


def test_make_mesh_builds_the_model_groups(tp_generation):
    ranks, _ = tp_generation
    for r, rec in enumerate(ranks):
        assert rec["mesh"] == {"data": 1, "seq": 1, "model": 2}
        assert rec["coords"] == {"data": 0, "seq": 0, "model": r}
        assert rec["group_sizes"] == {"data": 1, "seq": 1, "model": 2, "batch": 1}
        assert rec["kv_heads"] == 1


def test_gather_params_inverts_shard_params(tp_generation):
    ranks, _ = tp_generation
    assert all(rec["gathered_equal"] for rec in ranks)


def test_tp_greedy_tokens_equal_jax(tp_generation):
    ranks, one = tp_generation
    want = _jax_generate()
    for rec in ranks:
        np.testing.assert_array_equal(rec["greedy"], want)
    np.testing.assert_array_equal(one["greedy"], want)


def test_tp_prefill_logits_match_jax(tp_generation):
    ranks, _ = tp_generation
    want = _jax_prefill_logits()
    for rec in ranks:
        _close(rec["logits"], want, 2e-4, 2e-5, msg="prefill logits")
    np.testing.assert_array_equal(ranks[0]["logits"], ranks[1]["logits"])


def test_tp_embedded_frames_equal_one_process_bitwise(tp_generation):
    ranks, one = tp_generation
    for rec in ranks:
        for dt, h in one["embedded"].items():
            np.testing.assert_array_equal(rec["embedded"][dt], h, err_msg=dt)


def test_tp_sampled_tokens_equal_one_process_and_agree_across_ranks(tp_generation):
    ranks, one = tp_generation
    np.testing.assert_array_equal(ranks[0]["sampled"], ranks[1]["sampled"])
    np.testing.assert_array_equal(ranks[0]["sampled"], one["sampled"])
    assert not np.array_equal(one["sampled"], one["greedy"])


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_tp_step():
    """The JAX train step on parameters placed by its ``shard_params`` on
    ``make_mesh(data=2, model=2)``, the batch on ``data`` (as its trainer
    places them): metrics and the updated parameters (flat)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from csm_tpu.parallel.mesh import make_mesh as jmake_mesh
    from csm_tpu.parallel.mesh import shard_params as jshard_params
    from csm_tpu.train import loop as jloop

    jcfg, np_params = _jax_params()
    mesh = jmake_mesh(data=2, model=2)
    jopt = jloop.make_optimizer(**OPT)
    with mesh:
        jp = jshard_params(jax.tree.map(jnp.asarray, np_params), mesh)
        state = jloop.TrainState(params=jp, opt_state=jax.jit(jopt.init)(jp), step=jnp.int32(0))
        batch = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, PartitionSpec(None, "data")))
                 for k, v in _global_batch().items()}
        step = jax.jit(jloop.make_train_step(jcfg, jopt, MAX_DEC, remat=False))
        new, m = step(state, None, batch)
    return ({k: float(m[k]) for k in METRICS},
            flatten(jax.tree.map(np.asarray, new.params)))


def _tp_train_rank(data, seq, np_params, batch, remat_policy, use_flash):
    cfg = CSMConfig.tiny()
    mesh = make_mesh(data=data, seq=seq, model=2)
    opt = make_optimizer(**OPT)
    state = opt.init(shard_params(params_from_jax(np_params, cfg, "cpu"), mesh, cfg))
    step = make_train_step(cfg, opt, MAX_DEC, remat=remat_policy is not None,
                           remat_policy=remat_policy or "auto", use_flash=use_flash, mesh=mesh)
    state, m = step(state, None, {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = gather_params(map_tree(lambda p: p.grad, state.params), mesh, cfg)
    params = gather_params(map_tree(lambda p: p.detach(), state.params), mesh, cfg)
    return dict(metrics={k: float(m[k]) for k in METRICS}, coords=mesh.coords,
                grads=flatten(grads), params=flatten(params))


def _check_step(res, om, ograds, want_params):
    r0 = res[0]
    for k in METRICS:
        _close(r0["metrics"][k], om[k], 1e-5, msg=f"{k} vs one process")
    for name, g in ograds.items():
        _close(r0["grads"][name], g, 1e-4, 1e-6, msg=f"grad {name}")
        big = np.abs(g) > 1e-6
        _close(r0["params"][name][big], want_params[name][big], 1e-4, 1e-6, msg=f"param {name}")
    for r, rec in enumerate(res[1:], start=1):
        assert rec["metrics"] == r0["metrics"], r
        for name, p in rec["params"].items():
            np.testing.assert_array_equal(p, r0["params"][name], err_msg=f"rank {r} {name}")


def test_dp_tp_step_matches_jax():
    """One step, accum 2, global B 2, S 16 on data=2 x model=2 ranks (full
    remat): rank 0's losses and grad norm equal the JAX step's on
    ``make_mesh(data=2, model=2)`` and the one-process step's, its gathered
    gradients the one-process ones, its gathered parameters the JAX step's;
    every rank's gathered parameters are rank 0's bit for bit."""
    _, np_params = _jax_params()
    res = launch(_tp_train_rank, 4, 2, 1, np_params, _global_batch(), "nothing", True,
                 timeout=LAUNCH_TIMEOUT)
    jm, jparams = _jax_tp_step()
    om, ograds, _ = _one_process_step()
    for k in METRICS:
        _close(res[0]["metrics"][k], jm[k], 1e-5, msg=f"{k} vs JAX")
    _check_step(res, om, ograds, jparams)


def test_sp_tp_step_matches_one_process():
    """The same step on seq=2 x model=2 ranks (flash_attention_sp's plain
    versions on the CPU, selective remat) against the one-process step."""
    _, np_params = _jax_params()
    res = launch(_tp_train_rank, 4, 1, 2, np_params, _global_batch(), "dots", True,
                 timeout=LAUNCH_TIMEOUT)
    om, ograds, oparams = _one_process_step()
    assert [r["coords"]["seq"] for r in res] == [0, 0, 1, 1]
    _check_step(res, om, ograds, oparams)


LORA_TARGETS = ("wq", "wv", "wo", "w_down")


def _tp_lora_step(np_params, tp: bool):
    """One LoRA step (rank 2 adapters on column- and row-parallel targets)
    on a model=2 mesh (the base cut by ``shard_params``) or in one process:
    metrics and the adapters' gradients and values."""
    from csm_tpu_torch.train.lora import init_lora_params

    cfg = CSMConfig.tiny()
    base = params_from_jax(np_params, cfg, "cpu")
    adapters = init_lora_params(torch.Generator().manual_seed(42), base, 2, LORA_TARGETS)
    mesh = make_mesh(data=1, model=2) if tp else None
    if tp:
        base = shard_params(base, mesh, cfg)
    opt = make_optimizer(**OPT)
    state = opt.init(adapters)
    step = make_train_step(cfg, opt, MAX_DEC, lora_cfg={"alpha": 16.0, "rank": 2}, remat=False,
                           mesh=mesh)
    state, m = step(state, base, {k: torch.as_tensor(v) for k, v in _global_batch().items()})
    flat = flatten(state.params)
    return dict(metrics={k: float(m[k]) for k in METRICS},
                grads={k: p.grad.clone() for k, p in flat.items()},
                params={k: p.detach().clone() for k, p in flat.items()})


def test_tp_lora_step_matches_one_process():
    """LoRA over a model=2 base: the whole adapters get the one-process
    gradients (each rank's share summed over ``model``; the decoder's
    replicated attention targets need no sum) and losses, and stay bitwise
    equal across ranks."""
    _, np_params = _jax_params()
    res = launch(_tp_lora_step, 2, np_params, True, timeout=LAUNCH_TIMEOUT)
    one = to_numpy(_tp_lora_step(np_params, False))
    for k in METRICS:
        _close(res[0]["metrics"][k], one["metrics"][k], 1e-5, msg=k)
    for name, g in one["grads"].items():
        _close(res[0]["grads"][name], g, 1e-4, 1e-6, msg=f"grad {name}")
        np.testing.assert_array_equal(res[0]["params"][name], res[1]["params"][name])


# ---------------------------------------------------------------------------
# CSMTrainer on (1, 1, 2)
# ---------------------------------------------------------------------------


def _trainer(np_params, out_dir, **kw):
    cfg = CSMConfig.tiny()
    items = _items(cfg)
    return CSMTrainer(cfg, params_from_jax(np_params, cfg, "cpu"),
                      TrainingArguments(**_args(out_dir, **kw)), ItemsDataset(items),
                      eval_dataset=ItemsDataset(items[:3]),
                      data_collator=CSMDataCollator(text_pad_token_id=0, pad_to_length=16),
                      device="cpu")


def _whole_moments(trainer):
    return [(st["exp_avg"], st["exp_avg_sq"])
            for _, st in sorted(trainer._whole_state()["opt_state"]["state"].items())]


def _tp_trainer_rank(np_params, out_dir, lora_rank):
    """2 steps of a model=2 trainer (its mesh from the arguments), its
    evaluation, a checkpoint and the model saved; then a model=2 resume onto
    other weights (LoRA: adapters over the same base, which the checkpoint
    does not hold)."""
    trainer = _trainer(np_params, out_dir, mesh_model=2, lora_rank=lora_rank)
    trainer.train()
    eval_loss = trainer.evaluate()
    trainer.save_checkpoint(trainer.state.step)
    trainer.save_model(os.path.join(out_dir, "model"))
    whole = flatten(trainer.model_params())
    cfg = CSMConfig.tiny()
    start = params_from_jax(np_params, cfg, "cpu") if lora_rank else csm.init_params(cfg, seed=7)
    resumed = CSMTrainer(cfg, start,
                         dataclasses.replace(trainer.args, resume_from_checkpoint=True),
                         trainer.train_dataset, data_collator=trainer.data_collator, device="cpu")
    at = resumed._maybe_resume()
    same = all(torch.equal(p, whole[k]) for k, p in flatten(resumed.model_params()).items())
    same_moments = all(torch.equal(a, b) for x, y in zip(_whole_moments(resumed),
                                                         _whole_moments(trainer))
                       for a, b in zip(x, y))
    local_shape = tuple(trainer.state.params["backbone"]["layers"]["wq"].shape) if not lora_rank \
        else tuple(trainer.base_params["backbone"]["layers"]["wq"].shape)
    return dict(log=trainer._metrics_log, eval_loss=eval_loss, at=at, restored=same,
                restored_moments=same_moments, mesh=dict(trainer.mesh.shape),
                local_wq=local_shape)


@pytest.mark.parametrize("lora_rank", [0, 2])
def test_trainer_on_a_model_axis_saves_like_one_process_and_resumes(tmp_path, lora_rank):
    """``CSMTrainer`` with ``mesh_model=2`` (LoRA: adapters over a sharded
    base): losses and eval loss equal the one-process trainer's (rtol
    1e-5); the checkpoint holds the whole state, which resumes on
    (1, 1, 2) (parameters and gathered moments bitwise) and in one process;
    the one-process trainer resumed from it saves the model bit for bit as
    the model=2 trainer did."""
    _, np_params = _jax_params()
    out_dir = str(tmp_path / "tp")
    res = launch(_tp_trainer_rank, 2, np_params, out_dir, lora_rank, timeout=LAUNCH_TIMEOUT)
    single = _trainer(np_params, str(tmp_path / "single"), lora_rank=lora_rank)
    single.train()
    single_eval = single.evaluate()
    for rec in res:
        assert rec["mesh"] == {"data": 1, "seq": 1, "model": 2}
        assert rec["local_wq"] == (2, 64, 32)
        assert rec["at"] == 2 and rec["restored"] and rec["restored_moments"]
        assert len(rec["log"]) == len(single._metrics_log) == 2
        _close(rec["eval_loss"], single_eval, 1e-5, msg="eval loss")
        for mine, one in zip(rec["log"], single._metrics_log):
            for k in ("loss", "backbone_loss", "decoder_loss"):
                _close(mine[k], one[k], 1e-5, msg=f"step {mine['step']} {k}")
    assert os.listdir(os.path.join(out_dir, "checkpoints")) == ["2"]
    saved = load_checkpoint(os.path.join(out_dir, "checkpoints"))
    if not lora_rank:
        assert tuple(saved["params"]["backbone"]["layers"]["wq"].shape) == (2, 64, 64)
        assert tuple(saved["opt_state"]["state"][0]["exp_avg"].shape) == tuple(
            flatten(saved["params"])["audio_embeddings"].shape)
    one = _trainer(np_params, out_dir, lora_rank=lora_rank, resume_from_checkpoint=True)
    assert one._maybe_resume() == 2
    one.save_model(str(tmp_path / "one_model"))
    got = load_file(os.path.join(out_dir, "model", "model.safetensors"))
    want = load_file(str(tmp_path / "one_model" / "model.safetensors"))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
