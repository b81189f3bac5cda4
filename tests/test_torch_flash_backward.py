"""The port's flash-attention forward with log-sum-exp, its backward and the
differentiable op, on the CPU, against the JAX package's Pallas kernels run
in interpret mode (the shapes of tests/test_flash_attention.py: B 2, S 64,
4/2 heads, hd 16, row 1 left-padded by 16).

Tolerance fp32 rtol 1e-4 / atol 1e-5: the two differ only in the order of
their fp32 sums (the Pallas kernels sum block by block)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu.ops.flash_attention import _flash_fwd_call
from csm_tpu.ops.flash_attention import flash_attention as jflash
from csm_tpu_torch.ops import flash_attention as fa
from csm_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_reference,
)

RTOL, ATOL = 1e-4, 1e-5
B, S, NQ, NKV, HD, BLOCK = 2, 64, 4, 2, 16, 16


def _inputs(seed: int, pad: int = 16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, NQ, HD)).astype(np.float32)
    k = rng.standard_normal((B, S, NKV, HD)).astype(np.float32)
    v = rng.standard_normal((B, S, NKV, HD)).astype(np.float32)
    dout = rng.standard_normal((B, S, NQ, HD)).astype(np.float32)
    valid = np.ones((B, S), np.int32)
    valid[1, :pad] = 0
    return q, k, v, valid, dout


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


def _live(valid: np.ndarray, causal: bool) -> np.ndarray:
    """[B, S] rows with at least one visible key."""
    if not causal:
        return np.repeat(valid.any(axis=1, keepdims=True), S, axis=1)
    return np.cumsum(valid, axis=1) > 0


def _close(a, b, msg="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_lse_matches_pallas_forward(causal):
    """The Pallas residual is ``[B, nkv, g*S]`` with rows ordered
    ``i*g*bq + gi*bq + qi``; reordered by ``block_q`` it is ``[B, nq, S]``.
    Dead rows give exactly ``NEG_INF`` in both."""
    q, k, v, valid, _ = _inputs(0)
    jout, jlse = _flash_fwd_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(valid), causal, BLOCK, BLOCK, True, with_lse=True)
    g = NQ // NKV
    jlse = (np.asarray(jlse).reshape(B, NKV, S // BLOCK, g, BLOCK)
            .transpose(0, 1, 3, 2, 4).reshape(B, NQ, S))
    out, lse = flash_attention_reference(*_t(q, k, v, valid), causal=causal, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, NQ, S)
    live = _live(valid, causal)
    _close(lse.numpy().transpose(0, 2, 1)[live], jlse.transpose(0, 2, 1)[live], "lse")
    dead = ~live
    if dead.any():
        assert (lse.numpy().transpose(0, 2, 1)[dead] == NEG_INF).all()
        assert (jlse.transpose(0, 2, 1)[dead] == NEG_INF).all()
    _close(out.numpy()[live], np.asarray(jout)[live], "out on live rows")


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_pallas_vjp(causal):
    """``jax.vjp`` of the Pallas flash (both backward kernels) against the
    plain FA2 backward on the port's own forward, with a cotangent that is
    nonzero on dead rows too: both zero those rows' contributions."""
    q, k, v, valid, dout = _inputs(1)
    _, vjp = jax.vjp(lambda a, b, c: jflash(a, b, c, jnp.asarray(valid), causal=causal,
                                             block_q=BLOCK, block_k=BLOCK, interpret=True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv, tvalid, tdout = _t(q, k, v, valid, dout)
    out, lse = flash_attention_reference(tq, tk, tv, tvalid, causal=causal, return_lse=True)
    got = flash_attention_bwd_reference(tq, tk, tv, tvalid, out, lse, tdout, causal=causal)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32
        _close(a.numpy(), w, name)


def test_dead_rows_get_exactly_zero_grads():
    """Rows with no visible key (row 1's first 16, causal) contribute
    exactly nothing: dq is 0 there, and dk/dv equal those of the same
    cotangent with the dead rows zeroed, bit for bit."""
    q, k, v, valid, dout = _inputs(2)
    tq, tk, tv, tvalid, tdout = _t(q, k, v, valid, dout)
    out, lse = flash_attention_reference(tq, tk, tv, tvalid, return_lse=True)
    dq, dk, dv = flash_attention_bwd_reference(tq, tk, tv, tvalid, out, lse, tdout)
    assert (dq[1, :16] == 0).all() and dq[1, 16:].abs().sum() > 0
    masked = tdout * torch.as_tensor(valid, dtype=torch.float32)[:, :, None, None]
    _, dk0, dv0 = flash_attention_bwd_reference(tq, tk, tv, tvalid, out, lse, masked)
    assert torch.equal(dk, dk0) and torch.equal(dv, dv0)
    # The Pallas kernels agree: their dead rows' dq is 0 as well.
    _, vjp = jax.vjp(lambda a, b, c: jflash(a, b, c, jnp.asarray(valid), block_q=BLOCK,
                                             block_k=BLOCK, interpret=True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    assert (np.asarray(vjp(jnp.asarray(dout))[0])[1, :16] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_autograd_op_gives_the_plain_backward(causal, dtype):
    """On the CPU the op runs the plain versions: its gradients are the plain
    backward's, bit for bit."""
    q, k, v, valid, dout = _inputs(3)
    tq, tk, tv, tdout = (x.to(dtype) for x in _t(q, k, v, dout))
    tvalid = torch.as_tensor(valid)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    out = flash_attention(*leaves, tvalid, causal=causal)
    assert out.dtype == dtype and out.grad_fn is not None
    grads = torch.autograd.grad(out, leaves, tdout)
    ref_out, lse = flash_attention_reference(tq, tk, tv, tvalid, causal=causal, return_lse=True)
    assert torch.equal(out.detach(), ref_out)
    want = flash_attention_bwd_reference(tq, tk, tv, tvalid, ref_out, lse, tdout, causal=causal)
    for g, w in zip(grads, want):
        assert g.dtype == dtype and torch.equal(g, w)


def test_autograd_op_matches_autograd_through_the_plain_forward():
    """On live rows, with the dead rows' cotangent zero (as the training loss
    gives them), the op's gradients equal autograd's through the plain
    forward (whose dv spreads a dead row's cotangent; with zero cotangent
    both agree)."""
    q, k, v, valid, dout = _inputs(4)
    live = torch.as_tensor(_live(valid, True), dtype=torch.float32)[:, :, None, None]
    tvalid = torch.as_tensor(valid)
    cot = torch.as_tensor(dout) * live
    results = []
    for fn in (flash_attention, flash_attention_reference):
        leaves = [x.requires_grad_(True) for x in _t(q, k, v)]
        out = fn(*leaves, tvalid)
        results.append(torch.autograd.grad(out, leaves, cot))
    for name, a, b in zip(("dq", "dk", "dv"), *results):
        _close(a.numpy(), b.numpy(), name)


def test_no_grad_call_takes_the_forward_alone(monkeypatch):
    """Without a gradient the forward runs once with no log-sum-exp; with
    one the op keeps it."""
    calls = []
    orig = fa.flash_attention_reference

    def spy(*args, **kwargs):
        calls.append(kwargs.get("return_lse", False))
        return orig(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention_reference", spy)
    q, k, v, valid, _ = _inputs(5)
    tq, tk, tv, tvalid = _t(q, k, v, valid)
    with torch.no_grad():
        flash_attention(tq.requires_grad_(True), tk, tv, tvalid)
    flash_attention(tq, tk, tv, tvalid)
    assert calls == [False, True]
