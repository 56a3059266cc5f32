"""The bare slate-attention kernels' plain versions (B4,
``allrank_tpu_torch/ops/attention_fused.py``, and B5,
``ops/attention_tiled.py``) against the JAX package's
``fused_slate_attention`` and ``tiled_slate_attention`` run in interpret
mode, as ``tests/ops/test_attention_pallas.py`` and ``test_attention_tiled.py``
run them; the fully padded slate, where the two JAX kernels differ; and the
dropout masks at p > 0."""

import functools
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import allrank_tpu_torch
from allrank_tpu.constants import NEG_INF_FILL
from allrank_tpu.ops.attention_pallas import fused_slate_attention as jax_b4
from allrank_tpu.ops.attention_tiled import tiled_slate_attention as jax_b5
from allrank_tpu_torch.ops import dropout
from allrank_tpu_torch.ops.attention_fused import (
    attention_fused_bwd_plain,
    attention_fused_fwd_plain,
    fused_slate_attention,
)
from allrank_tpu_torch.ops.attention_tiled import (
    TILE_K,
    tiled_attention_bwd_plain,
    tiled_attention_fwd_plain,
    tiled_slate_attention,
)

torch.set_num_threads(2)

# the JAX kernels' own tests' tolerance (fp32, sums in another order)
TOL = 2e-5
# (B, h, L, d_k): L=300 spans two of the JAX B5's 256-wide key tiles and
# five of the port's 64-wide ones; d_k 72 is the ordinal recipe's head
SHAPES = [(2, 2, 300, 16), (1, 2, 128, 32), (2, 1, 240, 72)]
PORT = {"fused": fused_slate_attention, "tiled": tiled_slate_attention}
JAX = {"fused": jax_b4, "tiled": jax_b5}


def _inputs(b, h, l, dk, seed=0, lengths=None):
    """q, k, v from a numpy seed and the padding mask: slate 0 full, the
    last half padded (a single slate: half padded)."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, l, dk).astype(np.float32) for _ in range(3))
    if lengths is None:
        lengths = [l] * (b - 1) + [l // 2]
    mask = np.arange(l)[None, :] >= np.asarray(lengths)[:, None]
    return q, k, v, mask


@functools.lru_cache(maxsize=None)
def _jax_run(kind, shape):
    """The JAX kernel's forward and its sin-sum gradients, interpret mode."""
    q, k, v, mask = (jnp.asarray(a) for a in _inputs(*shape))
    seed = jnp.zeros((), jnp.int32)

    def f(q, k, v):
        return JAX[kind](q, k, v, mask, seed, 0.0)

    with pltpu.force_tpu_interpret_mode():
        out = f(q, k, v)
        grads = jax.grad(lambda *a: jnp.sum(jnp.sin(f(*a))),
                         argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), tuple(np.asarray(g) for g in grads)


def _port_run(kind, q, k, v, mask, p=0.0, seed=0):
    """The port's forward and the sin-sum gradients through its autograd
    Function (the plain backward on the CPU)."""
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = PORT[kind](*leaves, torch.tensor(mask), p, seed)
    torch.sin(out).sum().backward()
    return out.detach().numpy(), tuple(t.grad.numpy() for t in leaves)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", ["fused", "tiled"])
def test_forward_matches_jax_kernel(kind, shape):
    ref, _ = _jax_run(kind, shape)
    got, _ = _port_run(kind, *_inputs(*shape))
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", ["fused", "tiled"])
def test_gradients_match_jax_kernel(kind, shape):
    _, ref = _jax_run(kind, shape)
    _, got = _port_run(kind, *_inputs(*shape))
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g, r, rtol=TOL, atol=TOL, err_msg=name)


def _xla_attention(q, k, v, mask):
    """The JAX package's XLA path (models/transformer.py:459-465 there)."""
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    s = jnp.where(mask[:, None, None, :], NEG_INF_FILL, s)
    return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), v)


def test_fully_padded_slate_follows_the_xla_path():
    """Slate 1 has no valid document. The port's B4 and B5 both give B4's
    and the XLA path's uniform average over the slate's L keys. The JAX B5
    pads the keys to Lp = 512 with the mask set and averages over Lp, so
    its output is L / Lp of that (0.586 at L=300): nothing downstream sees
    it (every document of the slate is masked), and the port does not make
    its result depend on its own tile width (ROADMAP Queue C)."""
    b, h, l, dk = 2, 2, 300, 16
    q, k, v, mask = _inputs(b, h, l, dk, seed=3, lengths=[l, 0])
    xla = np.asarray(_xla_attention(*map(jnp.asarray, (q, k, v, mask))))
    seed = jnp.zeros((), jnp.int32)
    with pltpu.force_tpu_interpret_mode():
        j4 = np.asarray(jax_b4(*map(jnp.asarray, (q, k, v, mask)), seed, 0.0))
        j5 = np.asarray(jax_b5(*map(jnp.asarray, (q, k, v, mask)), seed, 0.0))
    t = [torch.tensor(a) for a in (q, k, v, mask)]
    p4 = attention_fused_fwd_plain(*t).numpy()
    p5, lse = tiled_attention_fwd_plain(*t)
    p5 = p5.numpy()
    uniform = v[1].mean(axis=1, keepdims=True)  # [h, 1, dk]
    for got in (p4, p5, j4):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got[1], np.broadcast_to(uniform, got[1].shape),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, xla, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(j5[0], xla[0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(j5[1], xla[1] * (l / 512), rtol=TOL, atol=TOL)
    assert torch.isfinite(lse).all()


def _masked_reference(q, k, v, mask, keep, p):
    """Attention with the dropout mask given explicitly, differentiated by
    autograd: the function both versions must compute with ``keep``."""
    s = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    s = s.masked_fill(mask[:, None, None, :], NEG_INF_FILL)
    probs = torch.softmax(s, dim=-1)
    return torch.where(keep, probs / (1.0 - p), 0.0) @ v


@pytest.mark.parametrize("kind", ["fused", "tiled"])
def test_dropout_mask_is_the_same_in_forward_and_backward(kind):
    """At p = 0.3 the forward and the backward draw the mask of
    ``ops/dropout.py`` (stream ATTN_PROBS, index ((b*h + head)*L + i)*L + j):
    both equal autograd of the formula with that mask written out, and the
    keep rate is within 4 sigma of binomial."""
    b, h, l, dk, p, seed = 2, 2, 150, 16, 0.3, 1234
    q, k, v, mask = (torch.tensor(a) for a in _inputs(b, h, l, dk, seed=5))
    keep = dropout.keep_mask(seed, dropout.ATTN_PROBS, p, (b, h, l, l))
    n = keep.numel()
    rate = keep.float().mean().item()
    assert abs(rate - (1 - p)) <= 4 * math.sqrt(p * (1 - p) / n), rate
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = _masked_reference(*leaves, mask, keep, p)
    dout = torch.tensor(np.random.RandomState(6).randn(b, h, l, dk)
                        .astype(np.float32))
    ref_grads = torch.autograd.grad(ref, leaves, dout)
    got_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = PORT[kind](*got_leaves, mask, p, seed)
    got_grads = torch.autograd.grad(got, got_leaves, dout)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    for name, g, r in zip("qkv", got_grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5, msg=name)
    # another seed draws another mask
    other = PORT[kind](q, k, v, mask, p, seed + 1)
    assert (other - got.detach()).abs().max() > 1e-2


@pytest.mark.parametrize("p", [0.0, 0.3])
def test_fused_and_tiled_plain_versions_agree(p):
    """The same function two ways in fp32: B4's materialised softmax and
    B5's recurrence over 64-key tiles. The gradients are held on a batch
    without a fully padded slate: there B5 rebuilds P from lse = -1e9 +
    log L, which fp32 rounds to -1e9 (its ulp there is 64), so B5's dv is L
    times B4's, as the JAX B5's is (ROADMAP Queue C); dq and dk are zero in
    both, and no gradient reaches a fully padded slate in the model."""
    b, h, l, dk = 2, 2, 3 * TILE_K + 17, 24
    q, k, v, mask = (torch.tensor(a) for a in _inputs(b, h, l, dk, seed=7))
    out4 = attention_fused_fwd_plain(q, k, v, mask, p, 9)
    out5, lse = tiled_attention_fwd_plain(q, k, v, mask, p, 9)
    torch.testing.assert_close(out5, out4, rtol=1e-5, atol=1e-5)
    do = torch.tensor(np.random.RandomState(8).randn(b, h, l, dk)
                      .astype(np.float32))
    g4 = attention_fused_bwd_plain(q, k, v, mask, do, p, 9)
    g5 = tiled_attention_bwd_plain(q, k, v, mask, out5, lse, do, p, 9)
    for name, a, r in zip("qkv", g5, g4):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5, msg=name)

    empty = mask.clone()
    empty[1] = True
    out5, lse = tiled_attention_fwd_plain(q, k, v, empty)
    g4 = attention_fused_bwd_plain(q, k, v, empty, do)
    g5 = tiled_attention_bwd_plain(q, k, v, empty, out5, lse, do)
    assert not g4[0][1].any() and not g5[0][1].any()
    assert not g4[1][1].any() and not g5[1][1].any()
    torch.testing.assert_close(g5[2][1], g4[2][1] * l, rtol=1e-5, atol=1e-4)


def test_bf16_plain_versions_round_where_the_tpu_kernels_do():
    """In bf16 both plain versions stay within a few bf16 ulps of the fp32
    function: P (B4) or the unnormalised p_acc (B5) rounded before P . v."""
    b, h, l, dk = 2, 2, 200, 32
    q, k, v, mask = (torch.tensor(a) for a in _inputs(b, h, l, dk, seed=11))
    ref = attention_fused_fwd_plain(q, k, v, mask)
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    ref_b = attention_fused_fwd_plain(qb.float(), kb.float(), vb.float(), mask)
    for out in (attention_fused_fwd_plain(qb, kb, vb, mask),
                tiled_attention_fwd_plain(qb, kb, vb, mask)[0]):
        assert out.dtype == torch.bfloat16
        torch.testing.assert_close(out.float(), ref_b, rtol=2 ** -6,
                                   atol=2 ** -6)
    assert (ref - ref_b).abs().max() < 0.05


# B4 in bf16 against the JAX kernel on bf16 inputs: the plain version is the
# card kernel's yardstick in bf16, so it must round where the TPU kernel
# does (P dropped before P . v; P dropped before dV and dS before dQ and dK).
# Forward 2^-6 (a rounding flip moves an output by one or two bf16 ulps);
# each gradient 2^-5 of its largest value (an fp32 sum on the other side of
# a rounding edge moves one bf16 dS by an ulp). One key and a 64-key tile
# plus one, d_k 8 and 20; the second slate is fully padded at L = 1.
BF16_TOL, BF16_GRAD_TOL = 2 ** -6, 2 ** -5
BF16_SHAPES = [(2, 2, l, dk) for l in (1, 65) for dk in (8, 20)]


@functools.lru_cache(maxsize=None)
def _jax_bf16_run(shape):
    """The JAX B4's bf16 forward and sin-sum gradients, interpret mode."""
    q, k, v, mask = _inputs(*shape, seed=21)
    q, k, v = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v))
    mask = jnp.asarray(mask)
    seed = jnp.zeros((), jnp.int32)

    def f(q, k, v):
        return jax_b4(q, k, v, mask, seed, 0.0)

    with pltpu.force_tpu_interpret_mode():
        out = f(q, k, v)
        grads = jax.grad(
            lambda *a: jnp.sum(jnp.sin(f(*a).astype(jnp.float32))),
            argnums=(0, 1, 2))(q, k, v)
    assert out.dtype == jnp.bfloat16
    return (np.asarray(out.astype(jnp.float32)),
            tuple(np.asarray(g.astype(jnp.float32)) for g in grads))


@pytest.mark.parametrize("shape", BF16_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_bf16_plain_b4_rounds_where_the_jax_kernel_does(shape):
    ref, ref_grads = _jax_bf16_run(shape)
    q, k, v, mask = _inputs(*shape, seed=21)
    leaves = [torch.tensor(a).bfloat16().requires_grad_() for a in (q, k, v)]
    out = fused_slate_attention(*leaves, torch.tensor(mask), 0.0, 0)
    assert out.dtype == torch.bfloat16
    torch.sin(out.float()).sum().backward()
    np.testing.assert_allclose(out.detach().float().numpy(), ref,
                               rtol=BF16_TOL, atol=BF16_TOL)
    for name, t, r in zip("qkv", leaves, ref_grads):
        got = t.grad.float().numpy()
        assert t.grad.dtype == torch.bfloat16 and np.isfinite(got).all()
        err, scale = np.abs(got - r).max(), np.abs(r).max()
        assert err <= BF16_GRAD_TOL * scale + 1e-6, (name, err, scale)


def test_kernel_key_tile_is_the_plain_versions():
    """The bf16 rounding of B5's unnormalised p_acc depends on the running
    max, so the CUDA kernels and the plain version must walk the same key
    tiles: the kernels' kKeyTile is ``TILE_K``."""
    src = os.path.join(os.path.dirname(allrank_tpu_torch.__file__), "csrc",
                       "attention_tiled.cu")
    with open(src) as f:
        found = re.findall(r"constexpr int kKeyTile = (\d+);", f.read())
    assert [int(n) for n in found] == [TILE_K]


def test_time_attention_measures_nothing_without_a_card(monkeypatch, tmp_path,
                                                        capsys):
    """The card-only timing CLI exits 2 on the CPU, and reads each kernel's
    registers and spills from an ``-Xptxas=-v`` build log by kernel name."""
    from allrank_tpu_torch.ops import _build
    from allrank_tpu_torch.tools import time_attention

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert time_attention.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    log = tmp_path / "attention_fused.log"
    log.write_text(
        "ptxas info    : Compiling entry function '_Z3fwdv' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 121 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z3bwdv' for 'sm_90a'\n"
        "ptxas info    : Used 96 registers, used 1 barriers\n")
    monkeypatch.setattr(_build, "log_path", lambda name: str(log))
    lines = time_attention.ptxas_lines("attention_fused")
    assert [name for name, _ in lines] == ["_Z3fwdv", "_Z3fwdv", "_Z3bwdv"]
    assert "121 registers" in lines[1][1] and "96 registers" in lines[2][1]
