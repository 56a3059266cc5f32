"""The port's compiled and exported scorers (allrank_tpu_torch/serving.py:
``aot_compile``, ``export_scorer``, ``load_scorer``) and the service's
per-bucket compilation on the CPU, against ``make_scorer`` bit for bit and
the JAX package's scorer within the serving tests' tolerances."""

import json

import jax
import numpy as np
import pytest
import torch

import allrank_tpu.config as jconfig
from allrank_tpu import quant as jquant
from allrank_tpu import serving as jserving
from allrank_tpu.models import factory as jfactory
from allrank_tpu_torch import config as tconfig
from allrank_tpu_torch.interop import load_jax_params
from allrank_tpu_torch.models.factory import LTRModel, make_model
from allrank_tpu_torch.serve_http import SlateScoringService
from allrank_tpu_torch.serving import (
    FORMAT_VERSION,
    GraphPool,
    aot_compile,
    export_scorer,
    load_scorer,
    make_ranker,
    make_scorer,
)

torch.set_num_threads(2)

F, L, B = 10, 12, 4
INFO_KEYS = {"batch_size", "slate_length", "n_features",
             "argument_size_in_bytes", "output_size_in_bytes",
             "temp_size_in_bytes"}
# against the JAX scorer: fp32 through two blocks summed in another order
# (tests/test_torch_serving.py); the int8 towers as tests/test_torch_quant.py
# holds them, relative to the largest score; bf16 as that file's bf16 flow
JAX_TOL = {(None, "float32"): dict(rtol=1e-4, atol=1e-5),
           (None, "bfloat16"): dict(rel=2 ** -5),
           ("int8", "bfloat16"): dict(rel=2 ** -6),
           ("int8_static", "bfloat16"): dict(rel=2 ** -6)}


def _config(cfg):
    return cfg.ModelConfig(
        fc_model=cfg.FCConfig(sizes=[16], input_norm=True, activation="ReLU",
                              dropout=None),
        transformer=cfg.TransformerConfig(
            N=2, d_ff=32, h=2, dropout=0.0,
            positional_encoding=cfg.PositionalEncodingConfig(
                strategy="fixed", max_indices=16)),
        post_model=cfg.PostModelConfig(d_output=1),
    )


def _models():
    jdef = jfactory.make_model(_config(jconfig), F)
    params = jax.tree.map(np.asarray,
                          jfactory.init_params(jax.random.PRNGKey(0), jdef))
    model = load_jax_params(LTRModel(make_model(_config(tconfig), F),
                                     device="cpu"), params)
    return jdef, params, model


def _inputs(seed=0, b=B):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, L, F) * 2).astype(np.float32)
    lengths = np.array([L, 7, 1, 0][:b])
    return x, lengths


def _scales(jdef, params):
    return jquant.calibrate_activations(params, jdef, [_inputs(5)])


@pytest.mark.parametrize("make", [make_scorer, make_ranker],
                         ids=["scorer", "ranker"])
def test_aot_compile_is_the_scorer_bit_for_bit(make):
    _, _, model = _models()
    fn = make(model, device="cpu")
    compiled, info = aot_compile(fn, B, L, F)
    assert set(info) == INFO_KEYS and compiled.info is info
    assert (info["batch_size"], info["slate_length"], info["n_features"]) == (
        B, L, F)
    assert info["argument_size_in_bytes"] == B * L * F * 4 + B * 8
    # scores fp32, orders int64
    assert info["output_size_in_bytes"] == B * L * (
        8 if make is make_ranker else 4)
    assert info["temp_size_in_bytes"] == 0
    assert compiled.captured_launches == {} and compiled.device.type == "cpu"
    x, lengths = _inputs()
    want = fn(x, lengths)
    got = compiled(x, lengths)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)
    assert torch.equal(compiled(torch.from_numpy(x), lengths.astype(np.int32)),
                       want)
    assert compiled.replays == 2


def test_aot_compile_refuses_other_shapes_and_bare_functions():
    _, _, model = _models()
    compiled, _ = aot_compile(make_scorer(model, device="cpu"), B, L, F)
    x, lengths = _inputs()
    for bad_x, bad_len in ((x[:2], lengths[:2]), (x[:, :5], lengths),
                           (x[..., :4], lengths), (x, lengths[:3])):
        with pytest.raises(ValueError, match="compiled for x"):
            compiled(bad_x, bad_len)
    with pytest.raises(TypeError, match="make_scorer"):
        aot_compile(lambda x, lengths: x, B, L, F)


def test_compiled_scorers_of_one_pool_share_its_lock():
    _, _, model = _models()
    scorer = make_scorer(model, device="cpu")
    pool = GraphPool()
    one, _ = aot_compile(scorer, 1, L, F, pool=pool)
    four, _ = aot_compile(scorer, B, L, F, pool=pool)
    x, lengths = _inputs()
    assert torch.equal(one(x[:1], lengths[:1]), scorer(x[:1], lengths[:1]))
    assert torch.equal(four(x, lengths), scorer(x, lengths))
    assert (one.replays, four.replays) == (1, 1)
    assert pool.handle is None  # the CPU captures no graph


# fp32, bf16, and the int8 towers in the service's bf16 flow
@pytest.mark.parametrize("quantize,flow", list(JAX_TOL),
                         ids=["fp32", "bf16", "int8", "int8_static"])
def test_export_then_load_is_make_scorer_bit_for_bit(tmp_path, quantize,
                                                     flow):
    jdef, params, model = _models()
    scales = _scales(jdef, params) if quantize == "int8_static" else None
    path = export_scorer(model, L, F, str(tmp_path / "scorer.npz"),
                         batch_size=B, compute_dtype=flow, quantize=quantize,
                         act_scales=scales)
    assert path == str(tmp_path / "scorer.npz")
    loaded = load_scorer(path, device="cpu")
    assert set(loaded.info) == INFO_KEYS
    x, lengths = _inputs(2)
    want = make_scorer(model, flow, device="cpu", quantize=quantize,
                       act_scales=scales)(x, lengths)
    got = loaded(x, lengths)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="compiled for x"):
        loaded(x[:1], lengths[:1])
    ref = np.asarray(jserving.make_scorer(params, jdef, flow,
                                          quantize=quantize,
                                          act_scales=scales)(x, lengths))
    got = got.numpy()
    valid = ~np.isneginf(ref)
    assert (np.isneginf(got) == ~valid).all() and not np.isnan(got).any()
    tol = JAX_TOL[(quantize, flow)]
    if "rel" in tol:
        scale = np.abs(ref[valid]).max()
        assert np.abs(got[valid] - ref[valid]).max() <= tol["rel"] * scale
    else:
        np.testing.assert_allclose(got[valid], ref[valid], **tol)


@pytest.mark.parametrize("quantize", ["int8", "int8_static"])
def test_int8_artifact_stores_int8_weights(tmp_path, quantize):
    jdef, params, model = _models()
    scales = _scales(jdef, params) if quantize == "int8_static" else None
    q = export_scorer(model, L, F, str(tmp_path / "q.npz"), batch_size=B,
                      compute_dtype="bfloat16", quantize=quantize,
                      act_scales=scales)
    f = export_scorer(model, L, F, str(tmp_path / "f.npz"), batch_size=B)
    with np.load(q, allow_pickle=False) as data:
        weights = {k: data[k] for k in data.files if k.startswith("weights/")}
        assert str(data["quantize"]) == quantize
        assert json.loads(str(data["act_scales"])) == scales
        assert [int(v) for v in data["serve_shape"]] == [B, L, F]
    w_q = {k for k, v in weights.items() if k.endswith(".w_q")}
    # every dense layer: FC, QKV, out, FFN up and down per block, the head
    assert len(w_q) == 1 + 4 * 2 + 1
    assert all(weights[k].dtype == np.int8 for k in w_q)
    assert not any(k.endswith(".w") for k in weights)  # no float weights
    q_bytes = sum(v.nbytes for v in weights.values())
    with np.load(f, allow_pickle=False) as data:
        f_bytes = sum(data[k].nbytes for k in data.files
                      if k.startswith("weights/"))
    assert q_bytes < f_bytes


def test_load_scorer_refuses_another_format_version(tmp_path):
    _, _, model = _models()
    path = export_scorer(model, L, F, str(tmp_path / "s.npz"), batch_size=B)
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    arrays["format_version"] = np.asarray(FORMAT_VERSION + 1)
    with open(tmp_path / "next.npz", "wb") as fh:
        np.savez(fh, **arrays)
    with pytest.raises(ValueError, match="format version"):
        load_scorer(str(tmp_path / "next.npz"), device="cpu")
    del arrays["format_version"]
    with open(tmp_path / "none.npz", "wb") as fh:
        np.savez(fh, **arrays)
    with pytest.raises(ValueError, match="format version None"):
        load_scorer(str(tmp_path / "none.npz"), device="cpu")
    with pytest.raises(ValueError, match="features"):
        export_scorer(model, L, F + 1, str(tmp_path / "x.npz"))


@pytest.mark.parametrize("buckets", [None, (1, 2, 4)],
                         ids=["one", "three"])
def test_service_reports_each_bucket(buckets):
    _, _, model = _models()
    service = SlateScoringService(model, L, F, batch_size=4, max_wait_ms=2,
                                  compute_dtype="float32",
                                  batch_buckets=buckets, device="cpu")
    try:
        info = service.executable_info
        assert info["device"] == "cpu" and info["compute_dtype"] == "float32"
        if buckets is None:
            assert INFO_KEYS <= set(info) and info["batch_size"] == 4
        else:
            assert info["buckets"] == buckets
            assert sorted(info["per_bucket"]) == list(buckets)
            for b, per in info["per_bucket"].items():
                assert set(per) == INFO_KEYS and per["batch_size"] == b
        assert sorted(service._compiled_by_bucket) == list(buckets or (4,))
        slate = _inputs()[0][0, :7]
        got = service.score(slate, timeout=30)
        xb = np.zeros((1, L, F), dtype=np.float32)
        xb[0, :7] = slate
        want = make_scorer(model, device="cpu")(xb, [7]).numpy()[0, :7]
        np.testing.assert_array_equal(got, want)
        assert sum(c.replays for c in service._compiled_by_bucket.values()
                   ) == service.stats()["waves_total"]
    finally:
        service.close()


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_load_scorer_refuses_a_missing_weight(tmp_path, quantize):
    _, _, model = _models()
    path = export_scorer(model, L, F, str(tmp_path / "s.npz"), batch_size=B,
                         compute_dtype="bfloat16", quantize=quantize)
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    gone = ("weights/output.w_q" if quantize else "weights/output|w")
    del arrays[gone]
    with open(tmp_path / "cut.npz", "wb") as fh:
        np.savez(fh, **arrays)
    with pytest.raises((KeyError, ValueError), match="output"):
        load_scorer(str(tmp_path / "cut.npz"), device="cpu")
