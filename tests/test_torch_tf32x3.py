"""B4's and B5's fp32 route on the CPU: ``route`` before any launch, and a
numpy emulation of the 3xTF32 split products that
``allrank_tpu_torch/csrc/attention_tf32x3.cuh`` runs on the tensor cores
(each fp32 operand split into hi = TF32 rounded to nearest, ties away, and
lo = the rest truncated to TF32; lo.hi + hi.lo + hi.hi a k8 step, summed
small terms first; each product step's sum truncated to fp32, as the
tensor cores' own sums are; every key tile's sum from zero, added to the
running sum in fp32). The emulation holds the kernels' method, not their
code, to the fp32 tolerance of the checks on the card, and shows why
dP - D is exactly 0 where a row has a single key (ROADMAP Queue C3)."""

import os
import re

import numpy as np
import pytest
import torch

import allrank_tpu_torch
from allrank_tpu_torch.ops import attention_fused, attention_tiled

# the card's fp32 tolerance of B4 / B5 against their plain versions
# (chip_smoke.py KERNEL_TOL, tests/test_torch_gpu.py TOL), unchanged
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)
NEG_INF_FILL = np.float32(-1e9)
LOG2E = np.float32(1.4426950408889634)
MASK = np.uint32(0xFFFFE000)  # the 13 bits TF32 drops
TILE = 64  # keys a tile (both kernels)


def rna_tf32(x):
    """cvt.rna.tf32.f32: x rounded to 10 mantissa bits, ties away from
    zero (a finite fp32 x)."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & MASK).view(np.float32)


def split(x):
    """(hi, lo) of ``split_tf32``: lo is x - hi (exact) truncated to TF32."""
    x = np.asarray(x, dtype=np.float32)
    hi = rna_tf32(x)
    lo = ((x - hi).view(np.uint32) & MASK).view(np.float32)
    return hi, lo


def trunc_f32(y):
    """float64 sums truncated toward zero to fp32, as a tensor core ends
    each product step."""
    out = y.astype(np.float32)
    over = np.abs(out.astype(np.float64)) > np.abs(y)
    out[over] = np.nextafter(out[over], np.float32(0))
    return out


def split_product(a, b, c=None):
    """c + a @ b for fp32 a [M, K], b [K, N] as the kernels take it: per k8
    step lo_a hi_b, hi_a lo_b, hi_a hi_b, each step's sum truncated."""
    ah, al = split(a)
    bh, bl = split(b)
    acc = (np.zeros((a.shape[0], b.shape[1]), np.float32) if c is None
           else c)
    for k0 in range(0, a.shape[1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = trunc_f32(acc.astype(np.float64)
                            + x[:, ks].astype(np.float64)
                            @ y[ks].astype(np.float64))
    return acc


def prob(sc, sub, mul=np.float32(1.0)):
    """``f32_prob``: exp2((sc - sub) log2(e)) * mul, in fp32."""
    return (np.exp2((sc - sub) * LOG2E) * mul).astype(np.float32)


def emulated_attention(q, k, v, pad):
    """B4's fp32 forward for one slate-head, q [M, d_k] against k, v
    [L, d_k], pad [L] True at padded keys: scores by split products, the
    exact softmax in fp32, P . v a 64-key tile at a time, each tile summed
    from zero and added in fp32."""
    scale = np.float32(1.0 / np.sqrt(q.shape[1]))
    sc = split_product(q, k.T) * scale
    sc = np.where(pad[None, :], NEG_INF_FILL, sc).astype(np.float32)
    m = sc.max(axis=1, keepdims=True)
    l = prob(sc, m).sum(axis=1, keepdims=True, dtype=np.float32)
    p = prob(sc, m, (np.float32(1.0) / l).astype(np.float32))
    out = np.zeros((q.shape[0], v.shape[1]), np.float32)
    for k0 in range(0, k.shape[0], TILE):
        out = out + split_product(p[:, k0:k0 + TILE], v[k0:k0 + TILE])
    return out


def reference(q, k, v, pad):
    q, k, v = (t.astype(np.float64) for t in (q, k, v))
    s = q @ k.T / np.sqrt(q.shape[1])
    s = np.where(pad[None, :], -1e9, s)
    e = np.exp(s - s.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)) @ v


# ---- route -------------------------------------------------------------


@pytest.mark.parametrize("dk", [1, 8, 20, 32, 36, 48, 64, 72, 100, 128])
def test_route_names_the_kernels_by_dtype(dk):
    assert attention_fused.route(torch.bfloat16, dk) == "mma"
    assert attention_fused.route(torch.float32, dk) == "tf32x3"
    assert attention_tiled.route is attention_fused.route
    assert set(attention_fused.ROUTES) == {"mma", "tf32x3"}


@pytest.mark.parametrize("dtype,dk", [(torch.float32, 0), (torch.float32, 129),
                                      (torch.bfloat16, 256),
                                      (torch.float16, 32),
                                      (torch.float64, 32)])
def test_route_refuses_outside_the_envelope(dtype, dk):
    with pytest.raises(NotImplementedError):
        attention_fused.route(dtype, dk)


def test_wrappers_count_launches_by_route():
    for fn in (attention_fused.attention_fused_fwd,
               attention_fused.attention_fused_bwd,
               attention_tiled.tiled_attention_fwd,
               attention_tiled.tiled_attention_bwd):
        assert set(fn.route_launches) == set(attention_fused.ROUTES)


def test_the_emulation_is_the_kernels_split():
    """The split emulated here is the one the CUDA source takes: the cvt
    with ties away and the 13-bit mask of the truncated lo."""
    path = os.path.join(os.path.dirname(allrank_tpu_torch.__file__), "csrc",
                        "attention_tf32x3.cuh")
    with open(path) as f:
        src = f.read()
    assert "cvt.rna.tf32.f32" in src
    assert re.search(r"__float_as_uint\(a - __uint_as_float\(hi\)\) & "
                     r"0xffffe000u", src)
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src


# ---- the split ---------------------------------------------------------


def test_split_keeps_21_bits_and_resplits_exactly():
    """hi + lo is within 2^-21 of a, and hi + lo (what the tensor cores sum
    from the pair) splits into the same pair, ties and the values next to
    them included."""
    rng = np.random.RandomState(0)
    a = (rng.randn(200_000) * 10.0 ** rng.randint(-3, 4, 200_000)).astype(
        np.float32)
    # low 13 bits at and around a tie of the rounding of hi
    bits = a.view(np.uint32) & ~np.uint32(0x1FFF)
    edge = np.concatenate([(bits | np.uint32(t)).view(np.float32)
                           for t in (0x0FFF, 0x1000, 0x1001, 0x1FFF, 0x0001)])
    for x in (a, edge, -edge):
        hi, lo = split(x)
        assert (hi.view(np.uint32) & ~MASK == 0).all()
        assert (lo.view(np.uint32) & ~MASK == 0).all()
        err = np.abs(x.astype(np.float64) - hi.astype(np.float64)
                     - lo.astype(np.float64))
        assert (err <= 2.0 ** -21 * np.abs(x.astype(np.float64))).all()
        whole = (hi.astype(np.float64) + lo.astype(np.float64))
        assert (whole.astype(np.float32).astype(np.float64) == whole).all()
        hi2, lo2 = split(whole.astype(np.float32))
        assert np.array_equal(hi2, hi) and np.array_equal(lo2, lo)


# ---- 3xTF32 products against fp64 ------------------------------------------


def _slate(rng, l, dk, n_queries, tail):
    q = rng.randn(n_queries, dk).astype(np.float32)
    k, v = (rng.randn(l, dk).astype(np.float32) for _ in range(2))
    pad = np.arange(l) >= l - tail
    return q, k, v, pad


@pytest.mark.parametrize("dk", [8, 20, 36, 48, 72, 100, 128])
@pytest.mark.parametrize("l", [1, 65])
def test_split_products_within_fp32_tolerance_at_each_head_width(l, dk):
    rng = np.random.RandomState(l * 1000 + dk)
    q, k, v, pad = _slate(rng, l, dk, 48, l // 3)
    np.testing.assert_allclose(emulated_attention(q, k, v, pad),
                               reference(q, k, v, pad), **KERNEL_TOL)


@pytest.mark.parametrize("l,dk,n_queries", [(1100, 32, 128), (1224, 72, 64),
                                            (4096, 32, 32), (8192, 32, 16)])
def test_split_products_within_fp32_tolerance_on_long_slates(l, dk,
                                                             n_queries):
    """At the main paths' lengths (a subset of the query rows: each output
    is its own chain of sums) the tile-by-tile sums keep P . v within the
    tolerance. (One truncating chain of L / 8 x 3 product steps instead
    lands 5-50 times farther from fp64 in this emulation at L 1100-8192,
    some 4 % of the tolerance at 8192.)"""
    rng = np.random.RandomState(l + dk)
    q, k, v, pad = _slate(rng, l, dk, n_queries, l // 10)
    # peaked rows too: q scaled up concentrates each row on a few keys
    q[: n_queries // 2] *= np.float32(4.0)
    np.testing.assert_allclose(emulated_attention(q, k, v, pad),
                               reference(q, k, v, pad), **KERNEL_TOL)


# ---- C3: one key, dP - D == 0 ----------------------------------------------


@pytest.mark.parametrize("dk", [8, 36, 128])
def test_one_key_d_cancels_dp_exactly(dk):
    """Where a row has a single key (L = 1) dQ and dK are 0 in exact
    arithmetic. B5's D = dO . O through the split product dP = dO . v is
    taken by: the forward's O = P . v with P exactly 1 is v_hi + v_lo,
    which re-splits into (v_hi, v_lo), so D is dP bit for bit. B4's
    D = rowsum(dPd P) has P exactly 1 (f32_prob's exponent is 0), so D is
    dP bit for bit too; B5 takes that D under dropout, where O carries
    1 / (1 - p) and no longer re-splits into v's pair. Rows with values at
    and around the rounding ties of the split are among the inputs."""
    rng = np.random.RandomState(dk)
    n = 512
    q, k, v, do = (rng.randn(n, dk).astype(np.float32) for _ in range(4))
    bits = v.view(np.uint32) & ~np.uint32(0x1FFF)
    ties = rng.choice(np.array([0x0FFF, 0x1000, 0x1001, 0x1FFF], np.uint32),
                      size=v.shape)
    v[: n // 2] = (bits[: n // 2] | ties[: n // 2]).view(np.float32)
    scale = np.float32(1.0 / np.sqrt(dk))
    for i in range(n):
        qi, ki, vi, doi = (t[i:i + 1] for t in (q, k, v, do))
        sc = split_product(qi, ki.T) * scale  # the forward's one score
        # B5: lse = m + log(l) with m = sc and l = 1
        lse = sc + np.float32(np.log(np.float32(1.0)))
        p5 = prob(sc, lse)
        assert p5[0, 0] == 1.0
        out = split_product(p5, vi)  # P . v, its tile summed from zero
        dp = split_product(doi, vi.T)
        d5 = split_product(doi, out.T)
        assert d5[0, 0] == dp[0, 0], (i, d5, dp)
        assert (p5 * (dp - d5))[0, 0] == 0.0
        # B4: m = sc, l = 1, P = f32_prob(sc, m, 1 / l)
        p4 = prob(sc, sc, np.float32(1.0) / np.float32(1.0))
        d4 = dp * p4
        assert p4[0, 0] == 1.0 and d4[0, 0] == dp[0, 0]
        # under dropout (p = 0.3, the key kept) dPd = dP / (1 - p) and
        # D = dPd P is dPd: still exactly 0
        inv = np.float32(1.0 / (1.0 - 0.3))
        dpd = dp * inv
        assert (p5 * (dpd - dpd * p5))[0, 0] == 0.0
