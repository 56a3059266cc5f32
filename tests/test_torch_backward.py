"""The port's sublayer backwards and dropout (allrank_tpu_torch/ops)
against the JAX package: the TPU kernels' VJPs in Pallas interpret mode on
the CPU, jax.grad of the XLA sublayers, and torch autograd of the port's
own plain forwards.

On the CPU the port's wrappers take their plain PyTorch versions (the CUDA
kernels run only on the card; tests/test_torch_gpu.py holds them against
the plain versions there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import allrank_tpu.models.transformer as T
from allrank_tpu.models.core import std_layer_norm_apply
from allrank_tpu.ops.attention_block import attention_sublayer
from allrank_tpu.ops.ffn_block import ffn_sublayer
from allrank_tpu_torch.ops import dropout
from allrank_tpu_torch.ops.attention_block import (
    AttentionSublayer,
    attention_sublayer_bwd,
    attention_sublayer_fwd_plain,
)
from allrank_tpu_torch.ops.ffn_block import (
    FFNSublayer,
    ffn_sublayer_bwd,
    ffn_sublayer_fwd_plain,
)

torch.set_num_threads(2)

B, L = 3, 12
ATTN_GRADS = ("dx", "dg", "db", "dwqkv", "dbqkv", "dwout", "dbout")
FFN_GRADS = ("dx", "dg", "db", "dw1", "db1", "dw2", "db2")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, ref, dtype, what):
    """fp32: the same arithmetic summed in another order. bf16 against the
    TPU kernel: the same rounding points, where an fp32 sum on the other
    side of a rounding edge moves a bf16 intermediate (dS, dqkv, dh) by one
    ulp and every gradient summed over it a little: 2^-6 of the tensor's
    largest value."""
    got = np.asarray(got, dtype=np.float32)
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape, what
    assert np.isfinite(got).all(), what
    scale = float(np.abs(ref).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-5 * scale + 1e-6, err_msg=what)
    else:
        err = float(np.abs(got - ref).max())
        assert err <= 2 ** -6 * scale + 1e-6, (what, err, scale)


def _inputs(d, seed, lengths=(L, 5, 0), l=L):
    rng = np.random.RandomState(seed)
    x = rng.randn(len(lengths), l, d).astype(np.float32)
    dy = rng.randn(len(lengths), l, d).astype(np.float32)
    mask = np.arange(l)[None, :] >= np.asarray(lengths)[:, None]
    return rng, x, dy, mask


def _vec(rng, n, center=0.0):
    return (center + 0.1 * rng.randn(n)).astype(np.float32)


def _mat(rng, m, n):
    return (rng.randn(m, n) / np.sqrt(m)).astype(np.float32)


def _attn_params(rng, d):
    return [_vec(rng, d, 1.0), _vec(rng, d), _mat(rng, d, 3 * d),
            _vec(rng, 3 * d), _mat(rng, d, d), _vec(rng, d)]


def _ffn_params(rng, d, d_ff):
    return [_vec(rng, d, 1.0), _vec(rng, d), _mat(rng, d, d_ff),
            _vec(rng, d_ff), _mat(rng, d_ff, d), _vec(rng, d)]


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


# ----------------------------------------------------------------------------
# B1 backward


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,h,lengths", [
    (16, 2, (L, 5, 0)),      # a full, a ragged and a fully padded slate
    (18, 2, (L, 1, 7)),      # d_k 9
    (24, 1, (L, L, 3)),      # one head
])
def test_attention_bwd_plain_matches_tpu_kernel_vjp(d, h, lengths, dtype):
    jdt, tdt = DTYPES[dtype]
    rng, x, dy, mask = _inputs(d, seed=d, lengths=lengths)
    p = _attn_params(rng, d)

    def f(x, *params):
        return attention_sublayer(x, jnp.asarray(mask), *params,
                                  jnp.zeros(2, jnp.int32), h, 0.0, 0.0)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, jnp.asarray(x, jdt), *map(jnp.asarray, p))
        ref = vjp(jnp.asarray(dy, jdt))
    got = attention_sublayer_bwd(torch.tensor(x).to(tdt),
                                 torch.tensor(mask), *_t(*p),
                                 torch.tensor(dy).to(tdt), h)
    assert got[0].dtype == tdt
    for name, g, r in zip(ATTN_GRADS, got, ref):
        _close(g.float().numpy(), r.astype(jnp.float32), dtype, name)


def test_attention_bwd_plain_matches_xla_grad():
    d, h = 16, 2
    rng, x, dy, mask = _inputs(d, seed=31)
    g, b, wqkv, bqkv, wout, bout = _attn_params(rng, d)
    tdef = T.TransformerDef(N=1, d_model=d, d_ff=4, h=h, dropout=0.0)

    def f(x, g, b, wqkv, bqkv, wout, bout):
        lp = {"ln1": {"scale": g, "bias": b}, "qkv": {"w": wqkv, "b": bqkv},
              "out": {"w": wout, "b": bout}}
        normed = std_layer_norm_apply(lp["ln1"], x)
        y = x + T._attention(lp, tdef, normed, jnp.asarray(mask), False, None)
        return jnp.sum(y * jnp.asarray(dy))

    ref = jax.grad(f, argnums=tuple(range(7)))(
        *map(jnp.asarray, (x, g, b, wqkv, bqkv, wout, bout)))
    got = attention_sublayer_bwd(*_t(x, mask, g, b, wqkv, bqkv, wout, bout,
                                     dy), h)
    for name, gt, r in zip(ATTN_GRADS, got, ref):
        _close(gt.numpy(), r, "float32", name)


@pytest.mark.parametrize("p", [0.0, 0.3])
def test_attention_bwd_plain_is_autograd_of_plain_forward(p):
    """fp32: the hand-derived backward equals autograd of the plain
    forward, at p > 0 given the same masks (the same seeds)."""
    d, h, seeds = 16, 2, (5, 7)
    rng, x, dy, mask = _inputs(d, seed=41)
    params = _t(*_attn_params(rng, d))
    leaves = [torch.tensor(x).requires_grad_()] + [
        t.clone().requires_grad_() for t in params]
    y = attention_sublayer_fwd_plain(leaves[0], torch.tensor(mask),
                                     *leaves[1:], h, p, p, seeds)
    y.backward(torch.tensor(dy))
    got = attention_sublayer_bwd(torch.tensor(x), torch.tensor(mask), *params,
                                 torch.tensor(dy), h, p, p, seeds)
    for name, g, leaf in zip(ATTN_GRADS, got, leaves):
        _close(g.numpy(), leaf.grad.numpy(), "float32", name)


def test_attention_bwd_at_one_document():
    d, h = 16, 2
    rng, x, dy, mask = _inputs(d, seed=51, lengths=(1, 0), l=1)
    p = _attn_params(rng, d)

    def f(x, *params):
        return attention_sublayer(x, jnp.asarray(mask), *params,
                                  jnp.zeros(2, jnp.int32), h, 0.0, 0.0)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, jnp.asarray(x), *map(jnp.asarray, p))
        ref = vjp(jnp.asarray(dy))
    got = attention_sublayer_bwd(*_t(x, mask, *p, dy), h)
    for name, g, r in zip(ATTN_GRADS, got, ref):
        _close(g.numpy(), r, "float32", name)


def test_fully_padded_slate_has_no_query_key_gradient():
    """All keys padded: dS is zero everywhere (the TPU kernel zeroes it at
    padded keys), so q and k get no gradient and dqkv is V's alone."""
    d, h = 16, 2
    rng, x, dy, _ = _inputs(d, seed=61)
    mask = np.ones((B, L), dtype=bool)
    params = _t(*_attn_params(rng, d))
    got = attention_sublayer_bwd(torch.tensor(x), torch.tensor(mask),
                                 *params, torch.tensor(dy), h)
    assert all(torch.isfinite(g).all() for g in got)
    dwqkv, dbqkv = got[3], got[4]
    assert not dwqkv[:, :2 * d].any() and not dbqkv[:2 * d].any()
    assert dwqkv[:, 2 * d:].abs().sum() > 0


# ----------------------------------------------------------------------------
# B2 backward


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,d_ff", [(16, 40), (18, 64)])
def test_ffn_bwd_plain_matches_tpu_kernel_vjp(d, d_ff, dtype):
    jdt, tdt = DTYPES[dtype]
    rng, x, dy, _ = _inputs(d, seed=d_ff)
    q = _ffn_params(rng, d, d_ff)

    def f(x, *params):
        return ffn_sublayer(x, *params, jnp.zeros(2, jnp.int32), 0.0, 0.0)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, jnp.asarray(x, jdt), *map(jnp.asarray, q))
        ref = vjp(jnp.asarray(dy, jdt))
    got = ffn_sublayer_bwd(torch.tensor(x).to(tdt), *_t(*q),
                           torch.tensor(dy).to(tdt))
    assert got[0].dtype == tdt
    for name, g, r in zip(FFN_GRADS, got, ref):
        _close(g.float().numpy(), r.astype(jnp.float32), dtype, name)


def test_ffn_bwd_plain_matches_xla_grad_with_zero_rows():
    d, d_ff = 16, 40
    rng, x, dy, _ = _inputs(d, seed=71)
    x[2] = 0.0  # all-zero rows, as padded documents: the variance floor
    params = _ffn_params(rng, d, d_ff)

    def f(x, g, b, w1, b1, w2, b2):
        normed = std_layer_norm_apply({"scale": g, "bias": b}, x)
        y = x + (jax.nn.relu(normed @ w1 + b1) @ w2 + b2)
        return jnp.sum(y * jnp.asarray(dy))

    ref = jax.grad(f, argnums=tuple(range(7)))(
        *map(jnp.asarray, [x] + params))
    got = ffn_sublayer_bwd(*_t(x, *params, dy))
    for name, g, r in zip(FFN_GRADS, got, ref):
        _close(g.numpy(), r, "float32", name)


@pytest.mark.parametrize("p", [0.0, 0.3])
def test_ffn_bwd_plain_is_autograd_of_plain_forward(p):
    d, d_ff, seeds = 16, 40, (3, 9)
    rng, x, dy, _ = _inputs(d, seed=81)
    params = _t(*_ffn_params(rng, d, d_ff))
    leaves = [torch.tensor(x).requires_grad_()] + [
        t.clone().requires_grad_() for t in params]
    y = ffn_sublayer_fwd_plain(*leaves, p, p, seeds)
    y.backward(torch.tensor(dy))
    got = ffn_sublayer_bwd(torch.tensor(x), *params, torch.tensor(dy), p, p,
                           seeds)
    for name, g, leaf in zip(FFN_GRADS, got, leaves):
        _close(g.numpy(), leaf.grad.numpy(), "float32", name)


@pytest.mark.parametrize("sublayer", ["attention", "ffn"])
def test_autograd_functions_give_the_wrappers_gradients(sublayer):
    """The autograd Functions route the backward through the backward
    wrappers (the kernels on CUDA), with the same dropout masks."""
    d, h, p, seeds = 16, 2, 0.2, (13, 17)
    rng, x, dy, mask = _inputs(d, seed=91)
    if sublayer == "attention":
        params = _t(*_attn_params(rng, d))
        head = (torch.tensor(mask),)
        fn, bwd, extra = AttentionSublayer, attention_sublayer_bwd, (h,)
    else:
        params = _t(*_ffn_params(rng, d, 40))
        head, fn, bwd, extra = (), FFNSublayer, ffn_sublayer_bwd, ()
    leaves = [torch.tensor(x).requires_grad_()] + [
        t.clone().requires_grad_() for t in params]
    y = fn.apply(leaves[0], *head, *leaves[1:], *extra, p, p, seeds)
    y.backward(torch.tensor(dy))
    ref = bwd(torch.tensor(x), *head, *params, torch.tensor(dy), *extra, p,
              p, seeds)
    for g, leaf in zip(ref, leaves):
        torch.testing.assert_close(leaf.grad, g, rtol=0, atol=0)


# ----------------------------------------------------------------------------
# dropout


@pytest.mark.parametrize("p", [0.1, 0.3])
def test_keep_rate_is_inside_a_binomial_bound(p):
    n = 200_000
    kept = dropout.keep_mask(1234, dropout.ATTN_PROBS, p, (n,)).sum().item()
    mean, sd = n * (1 - p), np.sqrt(n * p * (1 - p))
    assert abs(kept - mean) <= 5 * sd, (kept, mean, sd)


def test_mask_of_a_slice_is_the_slice_of_the_mask():
    full = dropout.keep_mask(7, dropout.FFN_HIDDEN, 0.3, (4, 6, 10))
    index = torch.arange(4 * 6 * 10).reshape(4, 6, 10)[1:3, 2:5, 3:]
    bits = dropout.random_bits(7, dropout.FFN_HIDDEN, index)
    assert torch.equal(full[1:3, 2:5, 3:], bits >= dropout.threshold(0.3))
    # indices past 2**32 use the high word
    far = torch.tensor([5, 5 + 2 ** 32, 5 + 2 ** 33])
    assert len(set(dropout.random_bits(7, 0, far).tolist())) == 3


def test_streams_and_seeds_are_independent():
    n, p = 100_000, 0.5
    masks = [dropout.keep_mask(s, st, p, (n,)).float()
             for s, st in ((1, 0), (1, 1), (2, 0), (2, 1))]
    for i in range(len(masks)):
        for j in range(i + 1, len(masks)):
            agree = (masks[i] == masks[j]).float().mean().item()
            # independent fair masks agree on half the elements, +- 5 sigma
            assert abs(agree - 0.5) <= 5 * 0.5 / np.sqrt(n), (i, j, agree)
    assert torch.equal(masks[0], dropout.keep_mask(1, 0, p, (n,)).float())


def test_bits_are_the_uint32_hash():
    """The int64 arithmetic (16-bit split products) equals exact uint32
    arithmetic done with Python integers."""
    def fmix(v):
        v ^= v >> 16
        v = (v * 0x85EBCA6B) & 0xFFFFFFFF
        v ^= v >> 13
        v = (v * 0xC2B2AE35) & 0xFFFFFFFF
        return v ^ (v >> 16)

    k0, k1 = dropout.stream_key(99, 3)
    index = [0, 1, 2 ** 31 + 5, 2 ** 32 - 1, 2 ** 40 + 17]
    want = [fmix(((fmix((i & 0xFFFFFFFF) ^ k0) ^ (i >> 32)) + k1)
                 & 0xFFFFFFFF) for i in index]
    assert dropout.random_bits(99, 3, torch.tensor(index)).tolist() == want
    assert dropout.threshold(0.3) == int(0.3 * (2 ** 32 - 1))
