"""The port's attention and FFN sublayer forwards (allrank_tpu_torch/ops)
against the JAX package: the TPU kernels run in Pallas interpret mode on
the CPU, and the XLA sublayers they replace.

On the CPU the port's wrappers take their plain PyTorch versions (the CUDA
kernels run only on the card; tests/test_torch_gpu.py holds them against
the plain versions there)."""

import os

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
from allrank_tpu_torch.ops.attention_block import (
    attention_sublayer_fwd,
    attention_sublayer_fwd_plain,
)
from allrank_tpu_torch.ops.ffn_block import (
    ffn_sublayer_fwd,
    ffn_sublayer_fwd_plain,
)

torch.set_num_threads(2)

B, L = 3, 12
# fp32: the same arithmetic summed in another order. bf16 against the TPU
# kernel: the same rounding points, so at most one bf16 ulp (2^-8
# relative) where an fp32 sum lands on another side of a rounding edge.
# bf16 against the XLA sublayer: that path rounds at other points (after
# every dense, bias added in bf16), a few bf16 ulps through the sublayer.
TOL = {"float32": dict(rtol=1e-5, atol=2e-5),
       "bfloat16": dict(rtol=2 ** -7, atol=2 ** -7)}
XLA_BF16_TOL = dict(rtol=0.05, atol=0.05)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(d, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, L, d).astype(np.float32)
    # a full slate, a ragged one and a fully padded one (lengths 0)
    lengths = np.array([L, 5, 0])
    mask = np.arange(L)[None, :] >= lengths[:, None]
    return rng, x, mask


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


def _to_torch(x, dtype, *arrays):
    return (torch.tensor(x).to(dtype),) + tuple(map(torch.tensor, arrays))


# (d, h): d_k 8, and the non-power-of-two d_k 9 and 12
WIDTHS = [(16, 2), (18, 2), (24, 2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,h", WIDTHS)
def test_attention_plain_matches_tpu_kernel(d, h, dtype):
    jdt, tdt = DTYPES[dtype]
    rng, x, mask = _inputs(d, seed=d)
    p = _attn_params(rng, d)
    with pltpu.force_tpu_interpret_mode():
        ref = attention_sublayer(jnp.asarray(x, jdt), jnp.asarray(mask),
                                 *map(jnp.asarray, p),
                                 jnp.zeros(2, jnp.int32), h, 0.0, 0.0)
    xt, mt, *pt = _to_torch(x, tdt, mask, *p)
    got = attention_sublayer_fwd(xt, mt, *pt, h)
    assert got.dtype == tdt and got.shape == (B, L, d)
    assert torch.isfinite(got.float()).all()  # the padded slate too
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,h", WIDTHS)
def test_attention_plain_matches_xla_sublayer(d, h, dtype):
    jdt, tdt = DTYPES[dtype]
    rng, x, mask = _inputs(d, seed=d + 1)
    g, b, wqkv, bqkv, wout, bout = _attn_params(rng, d)
    tdef = T.TransformerDef(N=1, d_model=d, d_ff=4, h=h, dropout=0.0)
    lp = {"ln1": {"scale": g, "bias": b}, "qkv": {"w": wqkv, "b": bqkv},
          "out": {"w": wout, "b": bout}}
    lp = jax.tree.map(jnp.asarray, lp)
    xj = jnp.asarray(x, jdt)
    normed = std_layer_norm_apply(lp["ln1"], xj)
    ref = xj + T._attention(lp, tdef, normed, jnp.asarray(mask), False, None)
    xt, mt, *pt = _to_torch(x, tdt, mask, g, b, wqkv, bqkv, wout, bout)
    got = attention_sublayer_fwd_plain(xt, mt, *pt, h)
    tol = TOL["float32"] if dtype == "float32" else XLA_BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **tol)


def test_fully_padded_slate_gets_uniform_attention():
    """All keys padded: every query attends uniformly (mean of V), no NaN."""
    d, h = 16, 2
    rng, x, _ = _inputs(d, seed=3)
    mask = np.ones((B, L), dtype=bool)
    p = _attn_params(rng, d)
    xt, mt, *pt = _to_torch(x, torch.float32, mask, *p)
    got = attention_sublayer_fwd(xt, mt, *pt, h)
    # x rows all zero: LN gives exactly the bias, variance floor included
    zeros = torch.zeros(1, L, d)
    z = attention_sublayer_fwd(zeros, mt[:1], *pt, h)
    assert torch.isfinite(got).all() and torch.isfinite(z).all()
    # uniform attention makes every query row's ctx the same
    delta = got - xt
    torch.testing.assert_close(delta, delta[:, :1].expand_as(delta),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,d_ff", [(16, 40), (18, 64)])
def test_ffn_plain_matches_tpu_kernel(d, d_ff, dtype):
    jdt, tdt = DTYPES[dtype]
    rng, x, _ = _inputs(d, seed=d_ff)
    q = _ffn_params(rng, d, d_ff)
    with pltpu.force_tpu_interpret_mode():
        ref = ffn_sublayer(jnp.asarray(x, jdt), *map(jnp.asarray, q),
                           jnp.zeros(2, jnp.int32), 0.0, 0.0)
    xt, *qt = _to_torch(x, tdt, *q)
    got = ffn_sublayer_fwd(xt, *qt)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_plain_matches_xla_sublayer(dtype):
    jdt, tdt = DTYPES[dtype]
    d, d_ff = 18, 40
    rng, x, _ = _inputs(d, seed=11)
    g, b, w1, b1, w2, b2 = _ffn_params(rng, d, d_ff)
    xj = jnp.asarray(x, jdt)
    normed = std_layer_norm_apply({"scale": g, "bias": b}, xj)
    hidden = jax.nn.relu(normed @ jnp.asarray(w1, jdt) + jnp.asarray(b1, jdt))
    ref = xj + (hidden @ jnp.asarray(w2, jdt) + jnp.asarray(b2, jdt))
    xt, *qt = _to_torch(x, tdt, g, b, w1, b1, w2, b2)
    got = ffn_sublayer_fwd_plain(xt, *qt)
    tol = TOL["float32"] if dtype == "float32" else XLA_BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("rate", [1.0, 1.5, -0.1])
def test_dropout_rate_outside_zero_one_raises(rate):
    """Dropout runs inside the sublayers at 0 <= p < 1; any other rate is
    refused before any mask is drawn."""
    rng, x, mask = _inputs(16, seed=0)
    xt, mt, *pt = _to_torch(x, torch.float32, mask, *_attn_params(rng, 16))
    with pytest.raises(ValueError, match="dropout rate"):
        attention_sublayer_fwd(xt, mt, *pt, 2, p_attn=rate)
    with pytest.raises(ValueError, match="dropout rate"):
        attention_sublayer_fwd(xt, mt, *pt, 2, p_resid=rate)
    qt = _to_torch(x, torch.float32, *_ffn_params(rng, 16, 32))[1:]
    with pytest.raises(ValueError, match="dropout rate"):
        ffn_sublayer_fwd(xt, *qt, p_hidden=rate)
    # a rate in range drops: the output differs from the rate-0 output
    y0 = attention_sublayer_fwd(xt, mt, *pt, 2)
    y1 = attention_sublayer_fwd(xt, mt, *pt, 2, p_attn=0.3, p_resid=0.3,
                                seeds=(1, 2))
    assert torch.isfinite(y1).all() and not torch.equal(y0, y1)


def test_kernel_arguments_are_checked_before_any_launch():
    from allrank_tpu_torch.ops import _build

    cpu = torch.device("cpu")
    t = torch.zeros(2, 3)
    _build.require(t, "t", (2, 3), torch.float32, cpu)
    with pytest.raises(TypeError, match="float32"):
        _build.require(t.double(), "t", (2, 3), torch.float32, cpu)
    with pytest.raises(ValueError, match="shape"):
        _build.require(t, "t", (3, 2), torch.float32, cpu)
    with pytest.raises(ValueError, match="contiguous"):
        _build.require(t.t(), "t", (3, 2), torch.float32, cpu)
    with pytest.raises(ValueError, match="meta"):
        _build.require(t.to("meta"), "t", (2, 3), torch.float32, cpu)
    # a device that is neither CPU nor CUDA has no version of either
    rng, x, mask = _inputs(16, seed=0)
    xt, mt, *pt = _to_torch(x, torch.float32, mask, *_attn_params(rng, 16))
    with pytest.raises(ValueError, match="no attention sublayer"):
        attention_sublayer_fwd(xt.to("meta"), mt, *pt, 2)
    qt = _to_torch(x, torch.float32, *_ffn_params(rng, 16, 32))[1:]
    with pytest.raises(ValueError, match="no FFN sublayer"):
        ffn_sublayer_fwd(xt.to("meta"), *qt)


def test_build_without_nvcc_raises_and_leaves_no_library(tmp_path,
                                                         monkeypatch):
    from allrank_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("attention_block", {})
    assert not [f for f in os.listdir(tmp_path) if ".so" in f]
    # each library is named after its own sources
    assert _build.library_path("attention_block") != \
        _build.library_path("ffn_block")
