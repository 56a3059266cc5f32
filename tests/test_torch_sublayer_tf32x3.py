"""B1's and B2's fp32 route on the CPU (allrank_tpu_torch/ops/attention_block.py
and ffn_block.py): ``route`` before any launch, and a numpy emulation of
the 3xTF32 split products that ``csrc/attention_block_tf32x3.cu`` and
``csrc/ffn_block_tf32x3.cu`` run on the tensor cores through
``csrc/mma_tile_f32.cuh``: each fp32 operand split into hi = TF32 rounded
to nearest, ties away, and lo = the rest truncated to TF32; lo.hi + hi.lo +
hi.hi a k8 step, each step's sum truncated to fp32 as the tensor cores'
own sums are; every 64-deep group of a projection, every hidden chunk,
every key tile and every 64-row step of a weight gradient summed from zero
and added to its running sum in fp32; weight gradients' split partials
reduced in split order. The emulation holds the kernels' method, not their
code: each piece against fp64 at the card's fp32 tolerances, and the
emulated sublayer forwards against the JAX package's TPU kernels in Pallas
interpret mode. tests/test_torch_gpu.py holds the kernels themselves
against their plain versions on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from allrank_tpu.ops.attention_block import attention_sublayer
from allrank_tpu.ops.ffn_block import ffn_sublayer
from allrank_tpu_torch.ops import attention_block, ffn_block

torch.set_num_threads(2)

# the card's fp32 tolerances of B1 and B2 against their plain versions
# (chip_smoke.py KERNEL_TOL and BWD_TOL, tests/test_torch_gpu.py), unchanged:
# a forward elementwise, a gradient relative to its tensor's largest value
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)
BWD_RTOL, BWD_ATOL = 1e-4, 1e-6
NEG_INF_FILL = np.float32(-1e9)
LOG2E = np.float32(1.4426950408889634)
MASK = np.uint32(0xFFFFE000)  # the 13 bits TF32 drops
GROUP = 64  # the depth a projection step sums from zero (kF32Group k8 steps)
KEY_TILE = 64
ROWS_STEP = 64  # rows a step of the weight-gradient tile (kF32AtbRows)


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


def split_steps(a, b):
    """a @ b (fp32 a [M, K], b [K, N], K at most one group) from zero as a
    warp sums it: per k8 step lo_a hi_b, hi_a lo_b, hi_a hi_b, each step's
    sum truncated."""
    ah, al = split(a)
    bh, bl = split(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = trunc_f32(acc.astype(np.float64)
                            + x[:, ks].astype(np.float64)
                            @ y[ks].astype(np.float64))
    return acc


def emulated_product(a, b, depth=GROUP):
    """``f32_product``: a @ b with every ``depth`` of K summed from zero by
    ``split_steps`` and added to the running sum in fp32."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], depth):
        acc = (acc + split_steps(a[:, k0:k0 + depth],
                                 b[k0:k0 + depth])).astype(np.float32)
    return acc


def layer_norm(x, g, b):
    """The kernels' LN in fp32: mean, unbiased std floored, eps added."""
    d = x.shape[-1]
    mu = x.mean(axis=-1, keepdims=True, dtype=np.float32)
    c = (x - mu).astype(np.float32)
    var = ((c * c).sum(axis=-1, keepdims=True, dtype=np.float32)
           / np.float32(max(d - 1, 1)))
    rd = np.float32(1.0) / (np.sqrt(np.maximum(var, np.float32(1e-24)))
                            + np.float32(1e-6))
    return (c * rd * g + b).astype(np.float32)


def layer_norm64(x, g, b):
    x = x.astype(np.float64)
    d = x.shape[-1]
    mu = x.mean(axis=-1, keepdims=True)
    var = ((x - mu) ** 2).sum(axis=-1, keepdims=True) / max(d - 1, 1)
    return (x - mu) / (np.sqrt(np.maximum(var, 1e-24)) + 1e-6) * g + b


def prob(sc, sub, mul=np.float32(1.0)):
    """``f32_prob``: exp2((sc - sub) log2(e)) * mul, in fp32."""
    return (np.exp2((sc - sub) * LOG2E) * mul).astype(np.float32)


def emulated_core(q, k, v, pad):
    """B1's fp32 core for one slate-head, B4's fp32 forward: scores by split
    products, the exact softmax in fp32, P . v a 64-key tile at a time, each
    tile summed from zero and added in fp32."""
    scale = np.float32(1.0 / np.sqrt(q.shape[1]))
    sc = (split_steps(q, k.T) if q.shape[1] <= GROUP
          else emulated_product(q, k.T)) * scale
    sc = np.where(pad[None, :], NEG_INF_FILL, sc).astype(np.float32)
    m = sc.max(axis=1, keepdims=True)
    l = prob(sc, m).sum(axis=1, keepdims=True, dtype=np.float32)
    p = prob(sc, m, (np.float32(1.0) / l).astype(np.float32))
    out = np.zeros((q.shape[0], v.shape[1]), np.float32)
    for k0 in range(0, k.shape[0], KEY_TILE):
        out = out + split_steps(p[:, k0:k0 + KEY_TILE], v[k0:k0 + KEY_TILE])
    return out


def emulated_b1(x, pad, params, h):
    """B1's fp32 forward as the three kernels take it: LN + QKV, the core
    per (slate, head) into ctx, then ctx . Wout + bout + x."""
    g, b, wqkv, bqkv, wout, bout = params
    bsz, l, d = x.shape
    dk = d // h
    rows = x.reshape(-1, d)
    qkv = emulated_product(layer_norm(rows, g, b), wqkv) + bqkv
    qkv = qkv.astype(np.float32).reshape(bsz, l, 3 * d)
    ctx = np.zeros((bsz, l, d), np.float32)
    for s in range(bsz):
        for head in range(h):
            cols = slice(head * dk, (head + 1) * dk)
            q, k, v = (qkv[s, :, j * d:(j + 1) * d][:, cols]
                       for j in range(3))
            ctx[s, :, cols] = emulated_core(q, k, v, pad[s])
    out = emulated_product(ctx.reshape(-1, d), wout) + bout
    return (rows + out.astype(np.float32)).reshape(bsz, l, d)


def emulated_b2(x, params, chunk=64):
    """B2's fp32 forward as its kernel takes it: per hidden chunk H_c =
    relu(LN(x) . W1[:, c] + b1) in registers, then H_c . W2[c, :] summed from
    zero and added in fp32; + b2 + x."""
    g, b, w1, b1, w2, b2 = params
    d, d_ff = w1.shape
    rows = x.reshape(-1, d)
    n = layer_norm(rows, g, b)
    acc = np.zeros(rows.shape, np.float32)
    for f0 in range(0, d_ff, chunk):
        fs = slice(f0, f0 + chunk)
        hid = np.maximum(emulated_product(n, w1[:, fs]) + b1[fs],
                         np.float32(0)).astype(np.float32)
        acc = (acc + split_steps(hid, w2[fs])).astype(np.float32)
    return (rows + acc + b2).astype(np.float32).reshape(x.shape)


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


# ---- the routes ----------------------------------------------------------


# d_k 1, 8, 20, 32, 36, 48, 72, 100, 128
@pytest.mark.parametrize("d,h", [(1, 1), (32, 4), (80, 4), (128, 4),
                                 (144, 4), (96, 2), (144, 2), (100, 1),
                                 (256, 2)])
def test_b1_fp32_with_heads_to_128_takes_tf32x3(d, h):
    assert attention_block.route(torch.float32, d, h) == "tf32x3"
    assert attention_block.route(torch.bfloat16, d, h) == "mma"


@pytest.mark.parametrize("d,h", [(129, 1), (200, 1), (256, 1)])
def test_b1_heads_wider_than_128_take_simt_in_both_dtypes(d, h):
    assert attention_block.route(torch.float32, d, h) == "simt"
    assert attention_block.route(torch.bfloat16, d, h) == "simt"


@pytest.mark.parametrize("d_ff", [1, 72, 384, 512, 1000, 1024])
@pytest.mark.parametrize("d", [1, 8, 100, 128, 129, 144, 256])
def test_b2_fp32_takes_tf32x3_across_the_envelope(d, d_ff):
    """No corner of B2's envelope leaves fp32's shared memory short, so
    none falls to the SIMT kernels."""
    assert ffn_block.route(torch.float32, d, d_ff) == "tf32x3"
    assert ffn_block.route(torch.bfloat16, d, d_ff) == "mma"


def test_asking_counts_no_launch():
    kernels = (attention_block.attention_sublayer_fwd,
               attention_block.attention_sublayer_bwd,
               ffn_block.ffn_sublayer_fwd, ffn_block.ffn_sublayer_bwd)
    before = [(k.launches, dict(k.route_launches)) for k in kernels]
    for _ in range(3):
        assert attention_block.route(torch.float32, 128, 4) == "tf32x3"
        assert ffn_block.route(torch.float32, 128, 512) == "tf32x3"
    assert [(k.launches, dict(k.route_launches)) for k in kernels] == before
    for k in kernels:
        assert set(k.route_launches) == {"mma", "tf32x3", "simt"}


@pytest.mark.parametrize("way,module", [("tf32x3", "b1"), ("tf32x3", "b2"),
                                        ("mma", "b1"), ("mma", "b2")])
def test_an_explicit_way_must_match_the_route(way, module):
    """launch_fwd / launch_bwd refuse a tensor-core route that the shape
    and dtype do not take (the SIMT route takes any, by name)."""
    wrong = torch.bfloat16 if way == "tf32x3" else torch.float32
    check = (attention_block._check_way if module == "b1"
             else ffn_block._check_way)
    with pytest.raises(ValueError, match=f"no '{way}' kernels"):
        check(way, wrong, 128, 4 if module == "b1" else 512)
    check("simt", wrong, 128, 4 if module == "b1" else 512)


# ---- the emulation against fp64 -----------------------------------------


@pytest.mark.parametrize("d", [8, 36, 128, 256])
def test_ln_qkv_product_holds_fp32_tolerance(d):
    """LN + QKV: the LN output split as A, Wqkv split as it is read, each
    64-deep group summed from zero."""
    rng = np.random.RandomState(d)
    x = rng.randn(200, d).astype(np.float32)
    g, b, wqkv, bqkv = _attn_params(rng, d)[:4]
    got = emulated_product(layer_norm(x, g, b), wqkv) + bqkv
    ref = layer_norm64(x, g, b) @ wqkv.astype(np.float64) + bqkv
    np.testing.assert_allclose(got, ref, **KERNEL_TOL)


@pytest.mark.parametrize("d", [32, 128, 256])
def test_out_projection_holds_fp32_tolerance(d):
    rng = np.random.RandomState(7 * d)
    ctx = rng.randn(150, d).astype(np.float32)
    x = rng.randn(150, d).astype(np.float32)
    wout, bout = _mat(rng, d, d), _vec(rng, d)
    got = x + (emulated_product(ctx, wout) + bout)
    ref = x + ctx.astype(np.float64) @ wout.astype(np.float64) + bout
    np.testing.assert_allclose(got, ref, **KERNEL_TOL)


@pytest.mark.parametrize("d,d_ff,chunk", [(128, 512, 64), (256, 1024, 32),
                                          (8, 72, 64), (100, 1000, 64)])
def test_b2_chunked_hidden_path_holds_fp32_tolerance(d, d_ff, chunk):
    """Each hidden chunk's H_c . W2[c, :] summed from zero and added in
    fp32: at d_ff = 1024 a single chain of truncated sums would lose up to
    384 last places."""
    rng = np.random.RandomState(d + d_ff)
    x = rng.randn(3, 40, d).astype(np.float32)
    params = _ffn_params(rng, d, d_ff)
    g, b, w1, b1, w2, b2 = params
    got = emulated_b2(x, params, chunk)
    n = layer_norm64(x.reshape(-1, d), g, b)
    hid = np.maximum(n @ w1.astype(np.float64) + b1, 0.0)
    ref = x.reshape(-1, d) + hid @ w2.astype(np.float64) + b2
    np.testing.assert_allclose(got.reshape(-1, d), ref, **KERNEL_TOL)


def test_weight_gradient_over_the_flagship_rows_in_split_order():
    """dW = A^T . B over B L = 15,360 rows: the row splits of
    ``attention_block.splits``, each a run of 64-row steps summed from zero
    and added in fp32, the partials then reduced in split order; within
    the card's backward tolerance of fp64."""
    m, k, n = 64 * 240, 32, 48
    rng = np.random.RandomState(3)
    a = rng.randn(m, k).astype(np.float32)
    bm = rng.randn(m, n).astype(np.float32)
    splits = attention_block.splits(m, k, n,
                                    attention_block.SPLIT_BLOCKS_TF32X3)
    per = -(-(-(-m // splits)) // 32) * 32  # split_rows: whole 32-row chunks
    total = np.zeros((k, n), np.float32)
    for s in range(splits):
        part = np.zeros((k, n), np.float32)
        for m0 in range(s * per, min(m, (s + 1) * per), ROWS_STEP):
            rows = slice(m0, min(m0 + ROWS_STEP, (s + 1) * per, m))
            part = (part + split_steps(a[rows].T, bm[rows])).astype(
                np.float32)
        total = (total + part).astype(np.float32)
    ref = a.astype(np.float64).T @ bm.astype(np.float64)
    err = np.abs(total - ref).max()
    assert splits > 1
    assert err <= BWD_RTOL * np.abs(ref).max() + BWD_ATOL, err


# ---- the emulated forwards against the TPU kernels ------------------------

B, L, D, H, D_FF = 2, 37, 32, 4, 64


def _slates(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, L, D).astype(np.float32)
    lengths = np.array([L, 0])  # a full slate and a fully padded one
    return rng, x, np.arange(L)[None, :] >= lengths[:, None]


def test_emulated_b1_forward_matches_the_tpu_kernel():
    """The 3xTF32 method of B1's three fp32 kernels against the JAX
    package's TPU kernel in interpret mode: within the card's fp32 kernel
    tolerance, the fully padded slate finite."""
    rng, x, pad = _slates(11)
    params = _attn_params(rng, D)
    with pltpu.force_tpu_interpret_mode():
        ref = attention_sublayer(jnp.asarray(x), jnp.asarray(pad),
                                 *map(jnp.asarray, params),
                                 jnp.zeros(2, jnp.int32), H, 0.0, 0.0)
    got = emulated_b1(x, pad, params, H)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(ref), **KERNEL_TOL)


def test_emulated_b2_forward_matches_the_tpu_kernel():
    rng, x, _ = _slates(12)
    params = _ffn_params(rng, D, D_FF)
    with pltpu.force_tpu_interpret_mode():
        ref = ffn_sublayer(jnp.asarray(x), *map(jnp.asarray, params),
                           jnp.zeros(2, jnp.int32), 0.0, 0.0)
    got = emulated_b2(x, params)
    np.testing.assert_allclose(got, np.asarray(ref), **KERNEL_TOL)


# ---- CPU tensors ----------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    """fp32 CPU tensors, whose route on the card is "tf32x3", take the plain
    versions: no launch counted on any route."""
    rng, x, pad = _slates(13)
    a = [torch.tensor(p) for p in _attn_params(rng, D)]
    f = [torch.tensor(p) for p in _ffn_params(rng, D, D_FF)]
    xt, mask = torch.tensor(x), torch.tensor(pad)
    dy = torch.tensor(rng.randn(B, L, D).astype(np.float32))
    kernels = (attention_block.attention_sublayer_fwd,
               attention_block.attention_sublayer_bwd,
               ffn_block.ffn_sublayer_fwd, ffn_block.ffn_sublayer_bwd)
    before = [(k.launches, dict(k.route_launches)) for k in kernels]
    y, saved = attention_block.attention_sublayer_fwd(xt, mask, *a, H,
                                                      return_saved=True)
    grads = attention_block.attention_sublayer_bwd(xt, mask, *a, dy, H)
    z = ffn_block.ffn_sublayer_fwd(xt, *f)
    fgrads = ffn_block.ffn_sublayer_bwd(xt, *f, dy)
    assert saved is None
    for t in (y, z, *grads, *fgrads):
        assert t.dtype == torch.float32 and torch.isfinite(t).all()
    assert [(k.launches, dict(k.route_launches)) for k in kernels] == before


def test_ptxas_compare_matches_kernels_across_trees(tmp_path):
    """``tools/ptxas_compare``: two build logs of one source from two
    trees, whose anonymous namespaces carry other path hashes, compare
    equal; a changed register count shows as a difference."""
    from allrank_tpu_torch.tools import ptxas_compare

    def log(name, tag, regs):
        path = tmp_path / name
        path.write_text(
            "ptxas info    : Compiling entry function '_ZN7allrank52_GLOBAL"
            f"__N__{tag}_19_ffn_block_tf32x3_cu_{tag}25b2_fwd_tf32x3_"
            "kernelILi1ELi64EEEvPKf' for 'sm_90a'\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            "loads\n"
            f"ptxas info    : Used {regs} registers, used 1 barriers\n")
        return str(path)

    here = ptxas_compare.table("ffn_block_tf32x3",
                               log("a.log", "e321f4a7", 128))
    assert ptxas_compare.differences(here, ptxas_compare.table(
        "ffn_block_tf32x3", log("b.log", "0badc0de", 128))) == []
    other = ptxas_compare.table("ffn_block_tf32x3",
                                log("c.log", "0badc0de", 130))
    lines = ptxas_compare.differences(here, other)
    assert len(lines) == 2 and "130 registers" in lines[0]
    assert all("_GLOBAL__N_ffn_block_tf32x3" in line for line in lines)
    assert "e321f4a7" not in "".join(lines)
