"""The port's parallel pieces on the CPU: the plain versions of K3 / K5a /
K5b under a ``q_offset`` against the JAX package's Pallas kernels in
interpret mode, ``flash_attention_sp`` on spawned ``gloo`` ranks against the
unsharded attention, the mesh, the launcher and the environment bootstrap.

Ranks are started by ``csm_tpu_torch.parallel.launch`` (``spawn``, a file
rendezvous, one thread each, a time limit on every launch) and import this
module: it imports JAX only inside the functions that compute the JAX
references, never at the top.

Tolerances: the plain versions against Pallas, fp32 rtol 1e-4 / atol 1e-5
(tests/test_torch_flash_backward.py: the same sums in another order);
``flash_attention_sp`` against the unsharded plain attention, output within
1e-6 and gradients rtol 1e-5 / atol 1e-6 (tests/test_flash_attention.py's
for the JAX ``flash_attention_sp``: the per-row work is the same, dK / dV
are summed across ranks in another order)."""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from csm_tpu_torch.ops import flash_attention as fa
from csm_tpu_torch.parallel import Mesh, batch_sharding, make_mesh, maybe_init_distributed
from csm_tpu_torch.parallel import mesh as pmesh
from csm_tpu_torch.parallel.launch import launch

LAUNCH_TIMEOUT = 120.0
RTOL, ATOL = 1e-4, 1e-5
B, S, NQ, NKV, HD, BLOCK, SHARDS = 2, 64, 4, 2, 16, 16, 4


def _inputs(seed: int, pad: int = 5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, NQ, HD)).astype(np.float32)
    k = rng.standard_normal((B, S, NKV, HD)).astype(np.float32)
    v = rng.standard_normal((B, S, NKV, HD)).astype(np.float32)
    cot = rng.standard_normal((B, S, NQ, HD)).astype(np.float32)
    valid = np.ones((B, S), np.int32)
    valid[:, :pad] = 0  # left padding: rows before the first valid key are dead
    return q, k, v, valid, cot


def _close(a, b, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


def _jax_shard(q, k, v, valid, cot, shard: int):
    """The JAX package's kernel on one query shard (interpret mode): output
    and the gradients of ``sum(out * cot)`` in q, k, v."""
    import jax
    import jax.numpy as jnp

    from csm_tpu.ops.flash_attention import flash_attention as jflash

    Sl = S // SHARDS
    sl = slice(shard * Sl, (shard + 1) * Sl)
    off = jnp.int32(shard * Sl)

    def run(qs, kk, vv):
        return jflash(qs, kk, vv, jnp.asarray(valid), block_q=BLOCK, block_k=BLOCK,
                      interpret=True, q_offset=off)

    qs = jnp.asarray(q[:, sl])
    out = run(qs, jnp.asarray(k), jnp.asarray(v))
    grads = jax.grad(lambda *a: jnp.sum(run(*a) * cot[:, sl]), argnums=(0, 1, 2))(
        qs, jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("shard", range(SHARDS))
def test_plain_q_offset_matches_pallas(shard):
    """Shard ``shard`` of 4 (16 rows at ``q_offset = 16 * shard``) against
    the full K / V: the plain forward on live rows, and the gradients
    through the op ``csm_tpu_torch::flash_attn`` (plain log-sum-exp and FA2
    backward on the CPU), against the Pallas kernels and ``jax.grad``."""
    q, k, v, valid, cot = _inputs(8)
    Sl = S // SHARDS
    sl = slice(shard * Sl, (shard + 1) * Sl)
    want_out, want_grads = _jax_shard(q, k, v, valid, cot, shard)

    qs, kk, vv = (torch.tensor(x, requires_grad=True) for x in (q[:, sl], k, v))
    out = fa.flash_attention(qs, kk, vv, torch.as_tensor(valid), True, q_offset=shard * Sl)
    (out * torch.as_tensor(cot[:, sl])).sum().backward()
    live = np.cumsum(valid, axis=1)[:, sl] > 0
    _close(out.detach().numpy()[live], want_out[live], msg="out")
    for name, got, want in zip(("dq", "dk", "dv"), (qs.grad, kk.grad, vv.grad), want_grads):
        _close(got.numpy(), want, msg=name)
    if shard == 0:
        # Keys after the shard's last row get exactly zero gradient.
        assert not kk.grad[:, Sl:].any() and not vv.grad[:, Sl:].any()


def test_q_offset_shards_reassemble_the_unsharded_plain_version():
    """Forward with log-sum-exp and the backward, shard by shard, equal the
    unsharded plain version's rows (dq) and sum to its dk / dv."""
    q, k, v, valid, cot = (torch.as_tensor(x) for x in _inputs(3))
    out, lse = fa.flash_attention_reference(q, k, v, valid, True, True)
    dq, dk, dv = fa.flash_attention_bwd_reference(q, k, v, valid, out, lse, cot)
    Sl = S // SHARDS
    dk_sum, dv_sum = torch.zeros_like(dk), torch.zeros_like(dv)
    for s in range(SHARDS):
        sl = slice(s * Sl, (s + 1) * Sl)
        o, l = fa.flash_fwd(q[:, sl], k, v, valid, True, with_lse=True, q_offset=s * Sl)
        torch.testing.assert_close(l, lse[..., sl], rtol=0, atol=1e-5)
        torch.testing.assert_close(o, out[:, sl], rtol=0, atol=1e-6)
        g = fa.flash_bwd(q[:, sl], k, v, valid, o, l, cot[:, sl], True, s * Sl)
        torch.testing.assert_close(g[0], dq[:, sl], rtol=1e-5, atol=1e-6)
        dk_sum += g[1]
        dv_sum += g[2]
    torch.testing.assert_close(dk_sum, dk, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dv_sum, dv, rtol=1e-5, atol=1e-6)


def test_q_offset_only_with_causal():
    q, k, v, valid, _ = (torch.as_tensor(x) for x in _inputs(0))
    for causal, off in ((False, 16), (True, -1)):
        with pytest.raises(ValueError, match="q_offset"):
            fa.flash_attention(q, k, v, valid, causal, q_offset=off)


# ---------------------------------------------------------------------------
# flash_attention_sp on spawned ranks
# ---------------------------------------------------------------------------


def _group_ranks(mesh: Mesh) -> dict:
    return {a: (None if mesh.group(a) is None else dist.get_process_group_ranks(mesh.group(a)))
            for a in ("data", "seq", "model", "batch")}


def _sp_rank(n, data, q, k, v, valid, cot):
    """One rank of a ``data`` x ``n / data`` mesh: its rows and frames through
    ``flash_attention_sp``, the gradients of ``sum(out * cot)``."""
    mesh = make_mesh(data=data, seq=n // data)
    rows, frames = batch_sharding(mesh, q.shape[0], q.shape[1])
    qs, ks, vs = (torch.tensor(x[rows, frames], requires_grad=True) for x in (q, k, v))
    out = fa.flash_attention_sp(qs, ks, vs, torch.as_tensor(valid[rows, frames]), mesh)
    (out * torch.as_tensor(cot[rows, frames])).sum().backward()
    return dict(out=out, dq=qs.grad, dk=ks.grad, dv=vs.grad, coords=mesh.coords,
                groups=_group_ranks(mesh))


@pytest.mark.parametrize("n,data", [(2, 1), (4, 1), (4, 2)])
def test_flash_attention_sp_matches_unsharded(n, data):
    """``n`` ranks, ``n / data`` of them on ``seq``: the gathered output
    within 1e-6 of the unsharded plain attention, gradients rtol 1e-5 /
    atol 1e-6; each rank's coordinates and groups as
    ``np.arange(n).reshape(data, seq, 1)`` lays them."""
    q, k, v, valid, cot = _inputs(9, pad=3)
    res = launch(_sp_rank, n, n, data, q, k, v, valid, cot, timeout=LAUNCH_TIMEOUT)
    seq = n // data
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    want = fa.flash_attention(tq, tk, tv, torch.as_tensor(valid))
    (want * torch.as_tensor(cot)).sum().backward()
    grid = np.arange(n).reshape(data, seq)
    got = {name: np.zeros_like(x) for name, x in (("out", q), ("dq", q), ("dk", k), ("dv", v))}
    for r, rec in enumerate(res):
        assert rec["coords"] == pmesh.mesh_coords(r, data, seq, 1)
        d, s = rec["coords"]["data"], rec["coords"]["seq"]
        assert rec["groups"]["seq"] == sorted(grid[d].tolist())
        assert rec["groups"]["data"] == (None if data == 1 else sorted(grid[:, s].tolist()))
        assert rec["groups"]["batch"] == list(range(n)) and rec["groups"]["model"] is None
        Bl, Sl = B // data, S // seq
        for name in got:
            got[name][d * Bl:(d + 1) * Bl, s * Sl:(s + 1) * Sl] = rec[name]
    _close(got["out"], want.detach().numpy(), rtol=0, atol=1e-6, msg="out")
    for name, t in (("dq", tq), ("dk", tk), ("dv", tv)):
        _close(got[name], t.grad.numpy(), rtol=1e-5, atol=1e-6, msg=name)


# ---------------------------------------------------------------------------
# Launcher, mesh, bootstrap
# ---------------------------------------------------------------------------


def _failing_rank(how):
    if how == "raises" and dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    if how == "hangs" and dist.get_rank() == 1:
        time.sleep(120)
    dist.barrier()
    return dist.get_rank()


def _ok_rank():
    return dict(rank=dist.get_rank(), world=dist.get_world_size(),
                backend=dist.get_backend(), threads=torch.get_num_threads(),
                x=torch.arange(3, dtype=torch.bfloat16) * dist.get_rank())


def test_launch_returns_each_ranks_result_as_numpy():
    res = launch(_ok_rank, 2, timeout=LAUNCH_TIMEOUT)
    assert [r["rank"] for r in res] == [0, 1]
    assert all(r["world"] == 2 and r["backend"] == "gloo" and r["threads"] == 1 for r in res)
    np.testing.assert_array_equal(res[1]["x"], np.arange(3, dtype=np.float32))


@pytest.mark.parametrize("how,match,timeout", [("raises", "rank 1 fails on purpose", 60.0),
                                               ("hangs", "timed out", 15.0)])
def test_launch_fails_on_a_rank_error_or_a_hang(how, match, timeout):
    """A rank's exception fails the launch at once; a hung rank fails it at
    the time limit (before gloo's own 60 s), and every rank is killed."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=match):
        launch(_failing_rank, 2, how, timeout=timeout)
    assert time.monotonic() - t0 < timeout + 15.0


def _mesh_rank(data, seq, model):
    mesh = make_mesh(data=data, seq=seq, model=model)
    return dict(shape=mesh.shape, coords=mesh.coords,
                members={a: (None if g is None else dist.get_process_group_ranks(g))
                         for a, g in mesh.groups.items()})


def test_mesh_coords_and_unported_axes():
    """The rank order of every axis, and make_mesh with a model axis: the
    model group joins the ranks that share data and seq, the batch group
    those that share the model index."""
    assert [pmesh.mesh_coords(r, 2, 2, 1) for r in range(4)] == [
        {"data": 0, "seq": 0, "model": 0}, {"data": 0, "seq": 1, "model": 0},
        {"data": 1, "seq": 0, "model": 0}, {"data": 1, "seq": 1, "model": 0}]
    assert [pmesh.mesh_coords(r, 2, 1, 2) for r in range(4)] == [
        {"data": 0, "seq": 0, "model": 0}, {"data": 0, "seq": 0, "model": 1},
        {"data": 1, "seq": 0, "model": 0}, {"data": 1, "seq": 0, "model": 1}]
    res = launch(_mesh_rank, 4, 2, 1, 2, timeout=LAUNCH_TIMEOUT)
    for r, rec in enumerate(res):
        assert rec["shape"] == {"data": 2, "seq": 1, "model": 2}
        assert rec["members"]["model"] == [r - r % 2, r - r % 2 + 1]
        assert rec["members"]["batch"] == rec["members"]["data"] == [r % 2, r % 2 + 2]
        assert rec["members"]["seq"] is None
    if not dist.is_initialized():
        with pytest.raises(RuntimeError, match="process group"):
            make_mesh(data=2)


def test_batch_sharding_takes_this_ranks_rows_and_frames():
    mesh = Mesh(shape={"data": 2, "seq": 2, "model": 1}, coords=pmesh.mesh_coords(3, 2, 2, 1),
                groups={}, rank=3)
    rows, frames = batch_sharding(mesh, 4, 16)
    assert (rows, frames) == (slice(2, 4), slice(8, 16))
    batch = {"input_ids": np.arange(2 * 4 * 16).reshape(2, 4, 16)}
    got = pmesh.shard_batch(batch, mesh, batch_dim=1)["input_ids"]
    np.testing.assert_array_equal(got, batch["input_ids"][:, 2:4, 8:16])
    placed = pmesh.put_global_batch({"x": batch["input_ids"][0]}, mesh, "cpu")["x"]
    assert torch.equal(placed, torch.as_tensor(batch["input_ids"][0, 2:4, 8:16]))
    with pytest.raises(ValueError, match="split"):
        batch_sharding(mesh, 3, 16)


def test_param_sharding_is_the_jax_table():
    """The tensor-parallel layout kept as data equals the JAX package's,
    fitted alike (the 2051-wide heads replicate on a 2-way model axis)."""
    from csm_tpu.parallel import mesh as jmesh

    def as_tuples(tree):
        if isinstance(tree, dict):
            return {k: as_tuples(v) for k, v in tree.items()}
        return tuple(tree)

    assert pmesh.param_sharding() == as_tuples(jmesh._specs())
    head = np.zeros((64, 2051))
    assert pmesh._fit_spec((None, "model"), head.shape, {"model": 2}) == (None, None)
    assert pmesh._fit_spec((None, None, "model"), (2, 64, 128), {"model": 2}) == (
        None, None, "model")
    assert tuple(jmesh._fit_spec(jmesh._specs()["codebook0_head"], head.shape,
                                 type("M", (), {"shape": {"model": 2}})())) == (None, None)


@pytest.mark.parametrize("env,want", [
    ({"CSM_TPU_COORDINATOR": "localhost:1234", "CSM_TPU_NUM_PROCESSES": "2",
      "CSM_TPU_PROCESS_ID": "1"},
     dict(init_method="tcp://localhost:1234", world_size=2, rank=1)),
    ({"CSM_TPU_MULTIHOST": "1", "LOCAL_WORLD_SIZE": "2"}, dict(init_method="env://")),
    ({}, None),
])
def test_maybe_init_distributed_reads_its_environment(monkeypatch, env, want):
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _clear_launch_env(monkeypatch)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert maybe_init_distributed() is (want is not None)
    if want is None:
        assert calls == []
        return
    (backend, kw), = calls
    assert backend == "gloo"  # no card of its own for each rank
    assert {k: kw[k] for k in want} == want and kw["timeout"].total_seconds() > 0


_LAUNCH_ENV = ("CSM_TPU_COORDINATOR", "CSM_TPU_NUM_PROCESSES", "CSM_TPU_PROCESS_ID",
               "CSM_TPU_MULTIHOST", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def _clear_launch_env(monkeypatch):
    for name in _LAUNCH_ENV:
        monkeypatch.delenv(name, raising=False)


_HOST_OF_16 = {"CSM_TPU_COORDINATOR": "host0:1234", "CSM_TPU_NUM_PROCESSES": "16",
               "CSM_TPU_PROCESS_ID": "11"}


@pytest.mark.parametrize("env,share,want", [
    # Two hosts of 8 cards: the local rank picks the card.
    (dict(_HOST_OF_16, LOCAL_RANK="3", LOCAL_WORLD_SIZE="8"), False, ("nccl", 3)),
    ({"CSM_TPU_MULTIHOST": "1", "WORLD_SIZE": "16", "RANK": "11", "LOCAL_RANK": "3",
      "LOCAL_WORLD_SIZE": "8"}, False, ("nccl", 3)),
    # One host, a card a rank.
    ({"CSM_TPU_COORDINATOR": "localhost:1234", "CSM_TPU_NUM_PROCESSES": "8",
      "CSM_TPU_PROCESS_ID": "5"}, False, ("nccl", 5)),
    # 16 ranks taken to be on one host of 8 cards: refused, not piled onto cuda:0.
    (_HOST_OF_16, False, RuntimeError),
    # Sharing asked for: gloo, no card set.
    (_HOST_OF_16, True, ("gloo", None)),
    ({"CSM_TPU_MULTIHOST": "1", "WORLD_SIZE": "16", "RANK": "2"}, True, ("gloo", None)),
])
def test_maybe_init_distributed_places_ranks_on_cards(monkeypatch, env, share, want):
    calls, devices = [], []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append(backend))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "set_device", devices.append)
    _clear_launch_env(monkeypatch)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="share_device"):
            maybe_init_distributed(share_device=share)
        assert calls == [] and devices == []
        return
    assert maybe_init_distributed(share_device=share)
    backend, device = want
    assert calls == [backend]
    assert devices == ([] if device is None else [device])
