"""The port's serving path (allrank_tpu_torch/serving.py, serve_http.py)
on the CPU: scorer and ranker against the JAX package's, and the dynamic
batcher and HTTP front as tests/test_serve_http.py holds the JAX one."""

import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import allrank_tpu.config as jconfig
from allrank_tpu import serving as jserving
from allrank_tpu.models import factory as jfactory
from allrank_tpu.training.checkpoint import save_params
from allrank_tpu_torch import config as tconfig
from allrank_tpu_torch.interop import load_jax_params
from allrank_tpu_torch.models.factory import LTRModel, make_model
from allrank_tpu_torch.serve_http import (
    ServiceOverloaded,
    SlateScoringService,
    run_server,
)
from allrank_tpu_torch.serving import make_ranker, make_scorer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, L = 6, 8
# fp32 through a 1-block encoder, summed in another order
F32 = dict(rtol=1e-4, atol=1e-5)


def _config(cfg):
    return cfg.ModelConfig(
        fc_model=cfg.FCConfig(sizes=[8], input_norm=True, activation="ReLU",
                              dropout=None),
        transformer=cfg.TransformerConfig(
            N=1, d_ff=16, h=2, dropout=0.0,
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


def _service(model, **kw):
    kw.setdefault("batch_size", 4)
    kw.setdefault("max_wait_ms", 2)
    kw.setdefault("compute_dtype", "float32")
    return SlateScoringService(model, L, F, device="cpu", **kw)


def _direct(model, slate):
    xb = np.zeros((1, L, F), dtype=np.float32)
    xb[0, : len(slate)] = slate
    scorer = make_scorer(model, "float32", device="cpu")
    return scorer(xb, np.array([len(slate)])).numpy()[0, : len(slate)]


def _serve(service):
    server = run_server(service, port=0, host="127.0.0.1")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _post(url, slate, binary=False):
    if binary:
        buf = io.BytesIO()
        np.save(buf, slate)
        req = urllib.request.Request(
            url + "/score", data=buf.getvalue(),
            headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return np.load(io.BytesIO(r.read()), allow_pickle=False)
    req = urllib.request.Request(
        url + "/score", data=json.dumps({"slate": slate.tolist()}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return np.asarray(json.loads(r.read())["scores"], dtype=np.float32)


def test_scorer_and_ranker_match_jax():
    jdef, params, model = _models()
    x = np.random.RandomState(0).randn(4, L, F).astype(np.float32)
    lengths = np.array([L, 5, 1, 0])
    ref = np.asarray(jserving.make_scorer(params, jdef)(x, lengths))
    got = make_scorer(model, device="cpu")(x, lengths)
    assert got.dtype == torch.float32
    got = got.numpy()
    assert (np.isneginf(got) == np.isneginf(ref)).all()
    assert np.isneginf(got[3]).all() and not np.isnan(got).any()
    valid = ~np.isneginf(ref)
    np.testing.assert_allclose(got[valid], ref[valid], **F32)

    order = make_ranker(model, device="cpu")(x, lengths).numpy()
    ref_order = np.asarray(jserving.make_ranker(params, jdef)(x, lengths))
    np.testing.assert_array_equal(order, ref_order)


def test_bf16_scorer_tracks_fp32_and_keeps_padding():
    _, _, model = _models()
    x = np.random.RandomState(3).randn(4, 7, F).astype(np.float32)
    lengths = np.array([7, 5, 2, 7])
    a = make_scorer(model, device="cpu")(x, lengths).numpy()
    b = make_scorer(model, "bfloat16", device="cpu")(x, lengths).numpy()
    assert b.dtype == np.float32
    assert (np.isneginf(a) == np.isneginf(b)).all()
    valid = ~np.isneginf(a)
    # bf16 keeps 8 mantissa bits: a few percent through the tower
    np.testing.assert_allclose(a[valid], b[valid], rtol=0.05, atol=0.05)


def test_quantized_serving_is_not_ported():
    _, _, model = _models()
    with pytest.raises(NotImplementedError, match="not yet ported"):
        make_scorer(model, device="cpu", quantize="int8")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        _service(model, compute_dtype="int8_static")


def test_batched_scores_match_direct_scorer():
    _, _, model = _models()
    service = _service(model, max_wait_ms=20)
    try:
        rng = np.random.RandomState(0)
        slates = [rng.randn(n, F).astype(np.float32)
                  for n in (3, 8, 1, 5, 8, 2, 7, 4)]
        futures = [service.submit(s) for s in slates]
        for s, f in zip(slates, futures):
            got = f.result(timeout=30)
            assert got.shape == (len(s),)
            np.testing.assert_allclose(got, _direct(model, s), **F32)
    finally:
        service.close()


def test_rejects_bad_slates_and_close():
    _, _, model = _models()
    service = _service(model, batch_size=2, max_wait_ms=1)
    try:
        with pytest.raises(ValueError, match="exceeds serve length"):
            service.submit(np.zeros((L + 1, F), dtype=np.float32))
        with pytest.raises(ValueError, match="must be"):
            service.submit(np.zeros((3, F + 1), dtype=np.float32))
        with pytest.raises(ValueError, match="empty"):
            service.submit(np.zeros((0, F), dtype=np.float32))
    finally:
        service.close()
    with pytest.raises(RuntimeError, match="closed"):
        service.submit(np.zeros((2, F), dtype=np.float32))


def test_http_json_and_npy_round_trips():
    _, _, model = _models()
    service = _service(model)
    server, url = _serve(service)
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health == {"status": "ok", "slate_length": L,
                          "n_features": F}
        slate = np.random.RandomState(1).randn(5, F).astype(np.float32)
        as_json, as_npy = _post(url, slate), _post(url, slate, binary=True)
        assert as_npy.shape == (5,) and as_npy.dtype == np.float32
        np.testing.assert_allclose(as_json, as_npy, rtol=1e-6)
        np.testing.assert_allclose(as_npy, _direct(model, slate), **F32)
        for body, ctype in ((b"{}", "application/json"),
                            (b"not json", "application/json"),
                            (b"not an npy", "application/octet-stream"),
                            (b"", "application/octet-stream")):
            req = urllib.request.Request(url + "/score", data=body,
                                         headers={"Content-Type": ctype})
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=10)
            assert e.value.code == 400, body
    finally:
        server.shutdown()
        server.server_close()
        service.close()


def test_bucketed_service_routes_waves_to_smallest_bucket():
    _, _, model = _models()
    service = _service(model, max_wait_ms=30, batch_buckets=(1, 2, 4))
    used = []
    orig = dict(service._scorer_by_bucket)

    def wrap(b, fn):
        def inner(x, lengths):
            used.append(b)
            assert x.shape[0] == b
            return fn(x, lengths)
        return inner

    service._scorer_by_bucket = {b: wrap(b, f) for b, f in orig.items()}
    try:
        rng = np.random.RandomState(7)
        lone = service.score(rng.randn(5, F).astype(np.float32), timeout=30)
        assert used == [1] and len(lone) == 5
        slates = [rng.randn(n, F).astype(np.float32) for n in (3, 8, 1)]
        futs = [service.submit(s) for s in slates]
        for s, f in zip(slates, futs):
            # a wave of 3 pads to the bucket of 4 with lengths=0 rows
            np.testing.assert_allclose(f.result(timeout=30),
                                       _direct(model, s), **F32)
        assert set(used) <= {1, 2, 4}
    finally:
        service.close()
    with pytest.raises(ValueError, match="largest bucket"):
        _service(model, batch_size=4, batch_buckets=(1, 8))


def test_overload_sheds_with_503_and_statz_counts():
    _, _, model = _models()
    with pytest.raises(ValueError, match="max_queue"):
        _service(model, max_queue=0)
    service = _service(model, batch_size=2, max_wait_ms=1, max_queue=2)
    entered, gate = threading.Event(), threading.Event()
    real = service._scorer_by_bucket[2]

    def held(x, lengths):
        entered.set()
        gate.wait(timeout=30)
        return real(x, lengths)

    service._scorer_by_bucket = {2: held}
    server, url = _serve(service)
    try:
        rng = np.random.RandomState(3)
        futs, rejected = [service.submit(rng.randn(3, F).astype(np.float32))], 0
        # the worker holds its first wave at the gate; the queue fills
        assert entered.wait(timeout=30)
        for _ in range(4):
            try:
                futs.append(service.submit(rng.randn(3, F).astype(np.float32)))
            except ServiceOverloaded:
                rejected += 1
        assert rejected > 0
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, rng.randn(3, F).astype(np.float32))
        assert e.value.code == 503 and e.value.headers["Retry-After"] == "1"
        gate.set()
        for f in futs:
            assert len(f.result(timeout=30)) == 3
        with urllib.request.urlopen(url + "/statz", timeout=10) as r:
            stats = json.loads(r.read())
        assert stats["requests_total"] == len(futs)
        assert stats["rejected_total"] == rejected + 1
        assert sum(stats["waves_by_bucket"].values()) == stats["waves_total"]
        assert stats["wave_ms"]["n"] == stats["waves_total"] >= 1
    finally:
        gate.set()
        server.shutdown()
        server.server_close()
        service.close()


def test_serve_cli_serves_a_jax_checkpoint(tmp_path):
    """``python -m allrank_tpu_torch.serve_http`` on a model.npz written by
    the JAX package's save_params, as a deployer runs it."""
    _, params, model = _models()
    save_params(params, str(tmp_path / "model.npz"))
    cfg = {"model": {
        "fc_model": {"sizes": [8], "input_norm": True, "activation": "ReLU",
                     "dropout": None},
        "transformer": {"N": 1, "d_ff": 16, "h": 2, "dropout": 0.0,
                        "positional_encoding": {"strategy": "fixed",
                                                "max_indices": 16}},
        "post_model": {"d_output": 1, "output_activation": None}},
        "data": {"path": "unused", "num_workers": 0, "batch_size": 4,
                 "slate_length": L, "validation_ds_role": "vali"}}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "allrank_tpu_torch.serve_http",
         "--config-file-name", str(tmp_path / "config.json"),
         "--input-model-path", str(tmp_path / "model.npz"),
         "--n-features", str(F), "--port", str(port), "--host", "127.0.0.1",
         "--batch-size", "4", "--batch-buckets", "1,4",
         "--compute-dtype", "float32", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 60
        while True:
            if proc.poll() is not None:
                raise AssertionError("server died:\n" +
                                     proc.stdout.read().decode())
            try:
                with urllib.request.urlopen(url + "/healthz", timeout=2):
                    break
            except OSError:
                assert time.time() < deadline, "server never came up"
                time.sleep(0.3)
        slate = np.random.RandomState(3).randn(5, F).astype(np.float32)
        np.testing.assert_allclose(_post(url, slate, binary=True),
                                   _direct(model, slate), **F32)
    finally:
        proc.kill()
        proc.wait()
