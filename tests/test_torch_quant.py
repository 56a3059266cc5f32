"""The port's int8 serving (allrank_tpu_torch/quant.py, ops/q8_dense.py, the
int8 paths of serving.py and serve_http.py) on the CPU against the JAX
package's quant.py, serving.py and the Pallas kernel X1 in interpret mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import allrank_tpu.config as jconfig
from allrank_tpu import quant as jquant
from allrank_tpu import serving as jserving
from allrank_tpu.models import factory as jfactory
from allrank_tpu_torch import config as tconfig
from allrank_tpu_torch import quant
from allrank_tpu_torch.interop import (
    export_params,
    flatten_params,
    load_jax_params,
)
from allrank_tpu_torch.models.factory import LTRModel, make_model
from allrank_tpu_torch.ops import q8_dense as port_q8
from allrank_tpu_torch.ops.q8_dense import (
    int8_product,
    q8_dense,
    q8_dense_plain,
    quantize_rows,
    row_scales,
)
from allrank_tpu_torch.serve_http import SlateScoringService
from allrank_tpu_torch.serving import make_scorer

torch.set_num_threads(2)

F, L = 10, 12
SITES = ["fc/0", "t0/qkv", "t0/out", "t0/ff1", "t0/ff2", "t1/qkv", "t1/out",
         "t1/ff1", "t1/ff2", "output"]
# the tower against JAX: fp32, a LayerNorm ulp can move one activation
# across a rounding edge of its int8 grid (one step of one channel); bf16
# flow, the same plus bf16 rounding at every elementwise op
TOWER_TOL = {"float32": 1e-4, "bfloat16": 2 ** -6}


def _config(cfg):
    return cfg.ModelConfig(
        fc_model=cfg.FCConfig(sizes=[32], input_norm=True, activation="ReLU",
                              dropout=None),
        transformer=cfg.TransformerConfig(
            N=2, d_ff=64, h=2, dropout=0.0,
            positional_encoding=cfg.PositionalEncodingConfig(
                strategy="fixed", max_indices=16)),
        post_model=cfg.PostModelConfig(d_output=3),
    )


@functools.lru_cache(maxsize=None)
def _jax_model():
    jdef = jfactory.make_model(_config(jconfig), F)
    params = jax.tree.map(np.asarray,
                          jfactory.init_params(jax.random.PRNGKey(0), jdef))
    # non-zero biases and norm shifts, so that every leaf is exercised
    rng = np.random.RandomState(5)
    params = jax.tree.map(
        lambda a: a + (0.1 * rng.randn(*a.shape)).astype(a.dtype)
        if a.ndim == 1 else a, params)
    return jdef, params


def _models():
    jdef, params = _jax_model()
    model = load_jax_params(LTRModel(make_model(_config(tconfig), F),
                                     device="cpu"), params)
    return jdef, params, model


def _batches(n=3, b=4, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = (rng.randn(b, L, F) * 2).astype(np.float32)
        lengths = rng.randint(1, L + 1, size=b).astype(np.int32)
        out.append((x, lengths))
    return out


@functools.lru_cache(maxsize=None)
def _jax_scales():
    jdef, params = _jax_model()
    return jquant.calibrate_activations(params, jdef, _batches())


# -- X1's plain version against quant.q_dense_apply -------------------------

def _dense_case(m, k, n, seed):
    """x with exact .5 ties after scaling by 4 (half the rows), a zero row
    and a zero column; w with a zero output column."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, k) * 3).astype(np.float32)
    x[::2] = (rng.randint(-300, 300, size=x[::2].shape) + 0.5) / 4.0
    x[1] = 0.0
    x[:, min(3, k - 1)] = 0.0
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    w[:, 0] = 0.0
    b = rng.randn(n).astype(np.float32)
    return x, w, b


def _jax_static(qp, inv):
    """qp in quant.py's static form for activation multiplier ``inv``."""
    qp = dict(qp)
    inv = np.asarray(inv, dtype=np.float32)
    qp["x_inv_scale"] = jnp.asarray(inv)
    qp["out_scale"] = (qp["w_scale"] * 0.25).astype(jnp.float32)
    return qp


@pytest.mark.parametrize("mode", ["static", "static_channels", "dynamic"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(512, 136, 128), (300, 128, 384),
                                   (64, 512, 128), (240, 128, 1)])
def test_q8_dense_plain_is_quant_bit_for_bit(m, k, n, dtype, mode):
    x, w, b = _dense_case(m, k, n, seed=m + k + n)
    qp = jquant.quantize_dense({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    tqp = quant.quantize_dense(torch.tensor(w), torch.tensor(b))
    for name in qp:
        np.testing.assert_array_equal(tqp[name].numpy(), np.asarray(qp[name]))
    if mode == "static":
        inv = np.float32(4.0)
    elif mode == "static_channels":
        inv = np.where(np.arange(k) % 3 == 0, 4.0,
                       np.random.RandomState(k).rand(k) * 30 + 1
                       ).astype(np.float32)
    if mode != "dynamic":
        qp = _jax_static(qp, inv)
        tqp = dict(tqp, x_inv_scale=torch.tensor(np.asarray(qp["x_inv_scale"])),
                   out_scale=torch.tensor(np.asarray(qp["out_scale"])))
    xj = jnp.asarray(x, dtype=dtype)
    xt = torch.tensor(x).to(getattr(torch, dtype))

    # x_q and acc, recomputed here as quant.py computes them
    x32 = xj.astype(jnp.float32)
    if mode == "dynamic":
        xs = jnp.maximum(jnp.max(jnp.abs(x32), axis=-1, keepdims=True),
                         1e-30) / 127.0
        ref_q = jnp.clip(jnp.round(x32 / xs), -127, 127).astype(jnp.int8)
        got_xs = row_scales(xt)
        np.testing.assert_array_equal(got_xs.numpy(), np.asarray(xs)[:, 0])
        got_q = quantize_rows(xt, xs=got_xs)
    else:
        ref_q = jnp.clip(jnp.round(x32 * qp["x_inv_scale"]), -127,
                         127).astype(jnp.int8)
        got_q = quantize_rows(xt, x_inv_scale=tqp["x_inv_scale"])
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(ref_q))
    ref_acc = jax.lax.dot_general(ref_q, qp["w_q"], (((1,), (0,)), ((), ())),
                                  preferred_element_type=jnp.int32)
    w_t = tqp["w_q"].t().contiguous()
    got_acc = int8_product(got_q, w_t)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(ref_acc))

    ref = np.asarray(jquant.q_dense_apply(qp, xj))
    got = quant.q_dense_apply(tqp, xt)
    want_dtype = torch.float32 if mode == "dynamic" else xt.dtype
    assert got.dtype == want_dtype and str(ref.dtype) == str(
        want_dtype).split(".")[1]
    np.testing.assert_array_equal(got.float().numpy(), ref.astype(np.float32))
    # the wrapper takes the plain version on the CPU, leading axes kept
    got3 = q8_dense(xt.reshape(2, m // 2, k) if m % 2 == 0 else xt, w_t,
                    tqp["w_scale"] if mode == "dynamic" else tqp["out_scale"],
                    tqp["b"], None if mode == "dynamic"
                    else tqp["x_inv_scale"])
    np.testing.assert_array_equal(got3.reshape(m, n).float().numpy(),
                                  ref.astype(np.float32))


@pytest.mark.parametrize("m,k,n", [(512, 136, 128), (256, 512, 128)])
def test_q8_dense_plain_matches_the_pallas_kernel(monkeypatch, m, k, n):
    """X1 itself (tools/exp_int8_matmul_kernel.fused_q8_dense) in Pallas
    interpret mode: within one fp32 ulp of max|y| (Pallas contracts the
    epilogue's multiply-add into one rounding, quant.py and the port round
    each)."""
    from jax.experimental import pallas as pl

    from tools import exp_int8_matmul_kernel as x1

    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(real, interpret=True))
    x1._make_kernel.cache_clear()
    try:
        x, w, b = _dense_case(m, k, n, seed=7)
        qp = jquant.quantize_dense({"w": jnp.asarray(w),
                                    "b": jnp.asarray(b)})
        inv = np.float32(4.0)
        qp = _jax_static(qp, inv)
        ref = np.asarray(x1.fused_q8_dense(jnp.asarray(x), qp["w_q"],
                                           qp["out_scale"], qp["b"],
                                           float(inv)))
    finally:
        x1._make_kernel.cache_clear()
    got = q8_dense_plain(torch.tensor(x),
                         torch.tensor(np.asarray(qp["w_q"]).T.copy()),
                         torch.tensor(np.asarray(qp["out_scale"])),
                         torch.tensor(np.asarray(qp["b"])),
                         torch.tensor(inv)).numpy()
    ulp = np.spacing(np.float32(np.abs(ref).max()))
    assert np.abs(got - ref).max() <= ulp


def test_q8_dense_checks_its_arguments():
    x = torch.zeros(4, 8)
    w_t = torch.zeros(3, 8, dtype=torch.int8)
    s, b = torch.ones(3), torch.zeros(3)
    with pytest.raises(ValueError, match=r"\[\.\.\., 8\]"):
        q8_dense(torch.zeros(4, 7), w_t, s, b)
    with pytest.raises(TypeError, match="int8"):
        q8_dense(x, w_t.float(), s, b)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        q8_dense(x.double(), w_t, s, b)
    with pytest.raises(ValueError, match="x_inv_scale"):
        q8_dense(x, w_t, s, b, torch.ones(5))
    assert q8_dense(x, w_t, s, b, torch.ones(8)).shape == (4, 3)


def test_q8_tile_constants_are_the_kernels():
    """The wrapper plans the grid and the slab scratch from its own
    constants; the kernel's come from the source's."""
    import os
    import re

    src = os.path.join(os.path.dirname(port_q8.__file__), os.pardir, "csrc",
                       "q8_dense.cu")
    with open(src) as f:
        text = f.read()
    for name, value in (("kQRows", port_q8.ROWS), ("kQCols", port_q8.COLS),
                        ("kQSlab", port_q8.SLAB)):
        found = re.search(rf"constexpr int {name} = (\d+);", text)
        assert int(found.group(1)) == value, name
    shared = re.search(r"constexpr int kQShared = (\d+) \* 1024;", text)
    assert int(shared.group(1)) * 1024 == port_q8.SHARED


@pytest.mark.parametrize("m,k,n,plan", [
    (15360, 136, 128, (240, 1, 128, 33792)),
    (15360, 128, 384, (240, 1, 384, 64512)),
    (15360, 128, 512, (240, 1, 512, 82944)),
    (15360, 512, 128, (240, 1, 128, 101376)),
    (15360, 128, 1, (240, 1, 64, 18432)), (1, 1, 1, (1, 1, 64, 6144)),
    (17, 33, 7, (1, 1, 64, 10240)), (15361, 512, 513, (241, 1, 128, 101376)),
    (65, 1024, 70, (2, 1, 64, 133120)), (65, 1025, 70, (2, 2, 64, 133120)),
    (3, port_q8.MAX_K, 5, (1, 131, 64, 133120))])
def test_q8_tile_plan(m, k, n, plan):
    """Each block owns 64 rows across all of N and holds up to 1024 of K:
    one slab (no scratch) and the whole weight staged at once at every
    flagship site, M = 15,360 (B=64, L=240), two blocks an SM; a wider K
    takes slabs and the int32 scratch, one block an SM."""
    got = port_q8.tile_plan(m, k, n)
    assert (got["row_tiles"], got["slabs"], got["weight_columns"],
            got["shared_bytes"]) == plan
    assert got["scratch"] == (plan[1] > 1)
    assert got["shared_bytes"] <= 227 * 1024


def test_time_sublayers_int8_measures_nothing_without_a_card(monkeypatch):
    """``time_sublayers --int8`` times X1 on the card only: without one it
    exits 2 before building anything."""
    from allrank_tpu_torch.tools import time_sublayers

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert time_sublayers.main(["--int8"]) == 2


@pytest.mark.parametrize("m,k,n", [(0, 8, 8), (8, 0, 8), (8, 8, 0),
                                   (8, port_q8.MAX_K + 1, 8)])
def test_q8_tile_plan_refuses_empty_or_inexact_shapes(m, k, n):
    with pytest.raises(ValueError, match="no tile plan"):
        port_q8.tile_plan(m, k, n)


# -- quantize_model and calibration -------------------------------------------

def _edit_scales(case):
    """The JAX calibration edited to reach each branch of the static
    quantizer."""
    scales = {k: list(v) for k, v in _jax_scales().items()}
    if case == "outlier":  # fc input: one channel 50x -> per-channel
        scales["fc/0"][2] *= 50.0
    elif case == "legacy":  # a per-tensor scalar of an older calibration
        scales["t0/ff1"] = float(max(scales["t0/ff1"]))
    elif case == "median":
        # 32 channels: np.median averages the middle two (1, 3) to 2, so
        # max / median = 8 / 2 = 4 collapses; the lower middle would give 8
        scales["t1/out"] = [1.0] * 16 + [3.0] * 15 + [8.0]
    return scales


@pytest.mark.parametrize("case", ["dynamic", "collapse", "outlier", "legacy",
                                  "median"])
def test_quantize_model_leaves_are_jax_bit_for_bit(case):
    jdef, params, model = _models()
    scales = None if case == "dynamic" else _edit_scales(case)
    ref = flatten_params(jax.tree.map(
        np.asarray, jquant.quantize_model(params, jdef, act_scales=scales)))
    qmodel = quant.quantize_model(model, scales)
    got = export_params(qmodel)
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert quant.quantized_bytes(qmodel) == jquant.quantized_bytes(
        jquant.quantize_model(params, jdef, act_scales=scales))
    static = {k.rsplit("|", 1)[0] for k in got if k.endswith("x_inv_scale")}
    if case == "outlier":
        assert got["fc|layers|0|x_inv_scale"].shape == (F,)
    if case == "median":
        assert got["transformer|layers|1|out|x_inv_scale"].shape == ()
    assert len(static) == (0 if case == "dynamic" else len(SITES))


def test_quantize_model_refuses_a_mismatched_calibration():
    jdef, params, model = _models()
    scales = _edit_scales("collapse")
    del scales["t1/ff2"]
    with pytest.raises(KeyError, match="t1/ff2"):
        jquant.quantize_model(params, jdef, act_scales=scales)
    with pytest.raises(KeyError, match="t1/ff2"):
        quant.quantize_model(model, scales)
    scales = _edit_scales("collapse")
    scales["t0/qkv"] = scales["t0/qkv"][:-1]
    with pytest.raises(ValueError, match="channels"):
        jquant.quantize_model(params, jdef, act_scales=scales)
    with pytest.raises(ValueError, match="channels"):
        quant.quantize_model(model, scales)


def test_calibrate_activations_matches_jax():
    _, _, model = _models()
    ref = _jax_scales()
    got = quant.calibrate_activations(model, _batches())
    assert sorted(got) == sorted(ref) == sorted(SITES)
    for site in ref:
        assert isinstance(got[site], list) and len(got[site]) == len(
            ref[site])
        np.testing.assert_allclose(got[site], ref[site], rtol=1e-6,
                                   err_msg=site)


def test_calibration_batches_from_dataset_match_jax(tmp_path):
    from allrank_tpu.data.dataset import load_dataset_role as jload
    from allrank_tpu.data.dummy import write_dummy_dataset
    from allrank_tpu_torch.data.dataset import load_dataset_role

    # slates shorter than L: padded, never subsampled (the JAX batcher's
    # native assembler draws its subsamples from another stream)
    write_dummy_dataset(str(tmp_path), num_queries=30, results_len=9,
                        num_features=F)
    ref = jquant.calibration_batches_from_dataset(
        jload("train", str(tmp_path), L)[0], L, batch_size=8, n_batches=4)
    got = quant.calibration_batches_from_dataset(
        load_dataset_role("train", str(tmp_path), L)[0], L, batch_size=8,
        n_batches=4)
    assert len(got) == len(ref) == 4
    for (gx, gl), (rx, rl) in zip(got, ref):
        np.testing.assert_array_equal(gx, rx)
        np.testing.assert_array_equal(gl, rl)
        assert gl.min() >= 1


# -- the tower, the scorer and the service ------------------------------------

@pytest.mark.parametrize("flow", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_quantized_scorer_matches_jax(mode, flow):
    jdef, params, model = _models()
    scales = _edit_scales("outlier") if mode == "int8_static" else None
    x = (np.random.RandomState(9).randn(5, L, F) * 2).astype(np.float32)
    lengths = np.array([L, 7, 1, 0, 11])
    ref = np.asarray(jserving.make_scorer(params, jdef, flow, quantize=mode,
                                          act_scales=scales)(x, lengths))
    got = make_scorer(model, flow, device="cpu", quantize=mode,
                      act_scales=scales)(x, lengths)
    assert got.dtype == torch.float32 and got.shape == (5, L)
    got = got.numpy()
    valid = ~np.isneginf(ref)
    assert (np.isneginf(got) == ~valid).all() and not np.isnan(got).any()
    assert np.isneginf(got[3]).all()
    scale = np.abs(ref[valid]).max()
    assert np.abs(got[valid] - ref[valid]).max() <= TOWER_TOL[flow] * scale


def test_quantized_tower_tracks_the_float_tower():
    """JAX's own gate (tests/test_quant.py): int8 scores correlate > 0.999
    with fp32's and keep most top-1 documents."""
    _, _, model = _models()
    rng = np.random.RandomState(11)
    x = (rng.randn(12, L, F) * 2).astype(np.float32)
    lengths = np.full(12, L)
    ref = make_scorer(model, device="cpu")(x, lengths).numpy()
    scales = quant.calibrate_activations(model, [(x, lengths)])
    for mode in ("int8", "int8_static"):
        got = make_scorer(model, device="cpu", quantize=mode,
                          act_scales=scales)(x, lengths).numpy()
        assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.999, mode
        same = (got.argmax(axis=1) == ref.argmax(axis=1)).mean()
        assert same >= 5 / 6, (mode, same)


def test_make_scorer_refuses_unknown_modes_and_missing_scales():
    _, _, model = _models()
    with pytest.raises(ValueError, match="unknown quantize mode"):
        make_scorer(model, device="cpu", quantize="int4")
    with pytest.raises(ValueError, match="needs act_scales"):
        make_scorer(model, device="cpu", quantize="int8_static")
    with pytest.raises(ValueError, match="needs act_scales"):
        SlateScoringService(model, L, F, device="cpu",
                            compute_dtype="int8_static")


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_int8_service_matches_the_scorer(mode):
    _, _, model = _models()
    scales = _jax_scales() if mode == "int8_static" else None
    service = SlateScoringService(model, L, F, batch_size=4, max_wait_ms=5,
                                  compute_dtype=mode, act_scales=scales,
                                  batch_buckets=(1, 4), device="cpu")
    assert service.executable_info["compute_dtype"] == mode
    scorer = make_scorer(model, "bfloat16", device="cpu", quantize=mode,
                         act_scales=scales)
    try:
        rng = np.random.RandomState(2)
        slates = [rng.randn(n, F).astype(np.float32) for n in (3, L, 1, 8)]
        futures = [service.submit(s) for s in slates]
        for s, fut in zip(slates, futures):
            xb = np.zeros((1, L, F), dtype=np.float32)
            xb[0, : len(s)] = s
            want = scorer(xb, [len(s)]).numpy()[0, : len(s)]
            np.testing.assert_array_equal(fut.result(timeout=60), want)
    finally:
        service.close()


def test_quantized_tower_refuses_slates_beyond_the_tiled_kernel():
    _, _, model = _models()
    with pytest.raises(NotImplementedError, match="L <= 8192"):
        quant._attention_core(8193, "cuda")
    assert quant._attention_core(8193, "cpu") is None
    qmodel = quant.quantize_model(model)
    assert quant._attention_core(1224, "cuda").__name__ == (
        "attention_fused_fwd")
    assert quant._attention_core(1225, "cuda").__name__ == (
        "tiled_attention_fwd")
    # one int8 layout: w_q [d_in, d_out] in the state, whose transpose is
    # the kernel's contiguous [d_out, d_in]; the state is all there is
    w_q = qmodel.transformer.layers[0].qkv.w_q
    assert w_q.shape == (32, 96) and w_q.t().is_contiguous()
    assert quant.quantized_bytes(qmodel) == sum(
        t.numel() * t.element_size() for t in qmodel.buffers())
