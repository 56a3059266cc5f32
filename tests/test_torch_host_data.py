"""The port's batch assembly (data/batching.py over the C++ assembler of
allrank_tpu_torch/native) and training over the device feature store
(training/train_utils.py, main.py) against the JAX package's, on seeded
ragged slates; the profiler trace of ``fit``.

Tolerances: batches bit for bit (both packages run the same C++ text, or
make the same ``RandomState`` draws in the Python row loops). The store's
run and the materialising run of the port: parameters bit for bit (one
gather of the same rows feeds the same ops). The port's run against the
JAX package's from the same weights: scores within tests/test_torch_fit.py's
1e-5 (fp32 through two blocks and a few SGD steps, summed in another
order)."""

import json
import os
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import allrank_tpu.data.native as jnative
from allrank_tpu.config import Config as JaxConfig
from allrank_tpu.data import batching as jb
from allrank_tpu.data.dataset import SlateDataset as JaxDataset
from allrank_tpu.main import run as jax_run
from allrank_tpu.models.factory import forward as jax_forward
from allrank_tpu.models.factory import init_params
from allrank_tpu.models.factory import make_model as jax_make_model
from allrank_tpu.training.checkpoint import load_params as jax_load_params
from allrank_tpu_torch.config import Config
from allrank_tpu_torch.data import batching as tb
from allrank_tpu_torch.data.dataset import SlateDataset
from allrank_tpu_torch.data.native import write_svmlight_native
from allrank_tpu_torch.main import run
from allrank_tpu_torch.models.factory import LTRModel, make_model
from allrank_tpu_torch.training.checkpoint import load_params, save_params

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAMBDA = os.path.join(REPO, "reproducibility", "configs",
                      "contextaware_web30k", "ndcgloss2pp.json")
F = 16
L = 12  # the train role's slate length: shorter, equal and longer slates


def _ragged(seed, n_slates, lo=1, hi=30):
    """(X, y, qid): slates of ``lo``-``hi`` documents, labels 0-4 with
    all-zero slates among them (the relevance guard's case)."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(lo, hi, size=n_slates)
    lengths[:3] = (L - 1, L, L + 1)
    X = rng.randn(int(lengths.sum()), F).astype(np.float32)
    y = rng.randint(0, 5, size=len(X)).astype(np.float32)
    y[:lengths[0]] = 0.0
    return X, y, np.repeat(np.arange(n_slates), lengths)


def _same(a, b):
    for u, v in zip(a, b, strict=True):
        assert u.dtype == v.dtype and u.shape == v.shape
        np.testing.assert_array_equal(u, v)


# -- the assembler --------------------------------------------------------------

@pytest.mark.parametrize("emit", [False, True], ids=["features", "indices"])
@pytest.mark.parametrize("num_workers", [1, 4])
@pytest.mark.parametrize("bucketed", [False, True])
def test_batches_are_jax_s_on_the_cpp_assembler(bucketed, num_workers, emit):
    X, y, qid = _ragged(0, 45)
    ds, jds = SlateDataset(X, y, qid), JaxDataset(X, y, qid)

    def batcher(pkg, data):
        if bucketed:
            return pkg.BucketedSlateBatcher(
                data, 8, n_buckets=3, num_workers=num_workers,
                emit_row_indices=emit)
        return pkg.SlateBatcher(data, L, 8, shuffle=True, seed=7,
                                num_workers=num_workers,
                                emit_row_indices=emit)

    mine, ref = batcher(tb, ds), batcher(jb, jds)
    one_thread = batcher(tb, ds) if num_workers > 1 else None
    subsampled = 0
    for epoch in range(3):
        for b in (mine, ref, one_thread):
            if b is not None:
                b.set_epoch(epoch)
        batches = list(mine)
        assert len(batches) == len(mine) == len(ref)
        for a, b in zip(batches, ref, strict=True):
            _same(a, b)
        if one_thread is not None:  # the threads split rows, not the bytes
            for a, b in zip(batches, one_thread, strict=True):
                _same(a, b)
        subsampled += sum(int((b.indices >= L).any()) for b in batches)
    assert bucketed or subsampled > 0  # slates longer than L subsampled


@pytest.mark.parametrize("num_workers", [1, 4])
def test_python_row_loop_by_name_is_jax_s(num_workers, monkeypatch):
    """The plain version: the port's Python row loop (on a pool of
    ``num_workers`` threads above 1) against the JAX package's, whose C++
    assembler is switched off."""
    monkeypatch.setattr(jnative, "_load_assembler", lambda: None)
    X, y, qid = _ragged(1, 45)
    ds, jds = SlateDataset(X, y, qid), JaxDataset(X, y, qid)
    for emit in (False, True):
        mine = tb.SlateBatcher(ds, L, 8, shuffle=True, seed=2,
                               num_workers=num_workers, assembly="python",
                               emit_row_indices=emit)
        ref = jb.SlateBatcher(jds, L, 8, shuffle=True, seed=2,
                              num_workers=num_workers, emit_row_indices=emit)
        for epoch in (0, 2):
            mine.set_epoch(epoch)
            ref.set_epoch(epoch)
            for a, b in zip(mine, ref, strict=True):
                _same(a, b)


def test_the_two_assemblies_draw_apart_only_past_the_slate_length():
    """Padding is the same on both assemblies; slates of L or more
    documents are drawn from two streams (the fault the C++ default fixed:
    ROADMAP Queue C)."""
    X, y, qid = _ragged(2, 45)
    ds = SlateDataset(X, y, qid)
    native = list(tb.SlateBatcher(ds, L, 45, seed=1))[0]
    python = list(tb.SlateBatcher(ds, L, 45, seed=1, assembly="python"))[0]
    short = np.bincount(qid) < L
    _same([a[short] for a in native], [a[short] for a in python])
    assert not np.array_equal(native.indices[~short], python.indices[~short])


# -- training over the device feature store -----------------------------------------

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("host_data"))
    for role, seed, n in (("train", 3, 48), ("vali", 4, 20)):
        write_svmlight_native(*_ragged(seed, n),
                              os.path.join(d, f"{role}.txt"))
    return d


def _config(data_dir, **data):
    """The paper recipe cut to 2 blocks of d 32: fp32, dropout 0, SGD at
    0.005 (so that two packages' steps stay within a sum order of each
    other: 1e-6 apart in the scores after the epoch)."""
    with open(LAMBDA) as f:
        cfg = json.load(f)
    cfg["data"].update(path=data_dir, slate_length=L, batch_size=8,
                       num_workers=4, **data)
    cfg["model"]["fc_model"]["sizes"] = [32]
    cfg["model"]["transformer"].update(N=2, d_ff=64, h=2, dropout=0.0)
    cfg["optimizer"] = {"name": "SGD", "args": {"lr": 0.005}}
    cfg["training"].update(epochs=1, compute_dtype="float32")
    cfg["expected_metrics"] = {"val": {"ndcg_5": 0.0}}
    # one device for the JAX package too (the tests' CPU mesh has 8): its
    # global batch is the config's
    cfg["parallel"] = {"data": 1, "model": 1, "sequence": 1}
    return cfg


def _train(tmp_path, run_id, cfg, runner, **kw):
    path = str(tmp_path / f"{run_id}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    job = str(tmp_path / "job")
    result = runner(Namespace(job_dir=job, run_id=run_id,
                              config_file_name=path), **kw)
    return result, os.path.join(job, "results", run_id)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cli_over_the_store_is_the_materialising_run(data_dir, tmp_path,
                                                     dtype):
    """``run`` with data.device_cache (a bf16 store for bf16 runs) and the
    binary cache gives the materialising run's parameters and metrics bit
    for bit."""
    results = {}
    for cache in (False, True):
        cfg = _config(data_dir, device_cache=cache, binary_cache=cache)
        cfg["training"]["compute_dtype"] = dtype
        cfg["model"]["transformer"]["dropout"] = 0.3
        results[cache], _ = _train(tmp_path, f"{dtype}_{cache}", cfg, run,
                                   device="cpu")
    a, b = (results[c]["model"].state_dict() for c in (False, True))
    for name in a:
        assert torch.equal(a[name], b[name]), name
    for role in ("train_metrics", "val_metrics"):
        assert results[True][role] == results[False][role]


def test_cli_over_the_store_is_jax_s_from_the_same_weights(data_dir,
                                                           tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("ALLRANK_TPU_CACHE_DIR", "0")  # no XLA cache on disk
    cfg = _config(data_dir, device_cache=True)
    start = str(tmp_path / "start.npz")
    save_params(LTRModel(make_model(Config.from_dict(cfg).model, F),
                         torch.Generator().manual_seed(5), device="cpu"),
                start)
    cfg["training"]["init_from"] = start
    mine, mine_dir = _train(tmp_path, "torch", cfg, run, device="cpu")
    theirs, theirs_dir = _train(tmp_path, "jax", cfg, jax_run)
    mdef = jax_make_model(JaxConfig.from_dict(cfg).model, F)
    rng = np.random.RandomState(0)
    x = rng.randn(4, L, F).astype(np.float32)
    mask = np.arange(L)[None, :] >= np.array([L, 7, 3, 1])[:, None]
    indices = np.where(mask, -1, np.arange(L)[None, :])
    params = jax_load_params(init_params(jax.random.PRNGKey(0), mdef),
                             os.path.join(theirs_dir, "model.npz"))
    ref = np.asarray(jax_forward(params, mdef, jnp.asarray(x),
                                 jnp.asarray(mask), jnp.asarray(indices)))
    model = load_params(LTRModel(make_model(Config.from_dict(cfg).model, F),
                                 device="cpu"),
                        os.path.join(mine_dir, "model.npz"))
    with torch.no_grad():
        got = model(torch.tensor(x), torch.tensor(mask),
                    torch.tensor(indices)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    with torch.no_grad():  # and training moved the weights
        moved = load_params(LTRModel(make_model(
            Config.from_dict(cfg).model, F), device="cpu"), start)(
            torch.tensor(x), torch.tensor(mask),
            torch.tensor(indices)).numpy()
    assert np.abs(moved - ref).max() > 1e-3
    for role in ("train_metrics", "val_metrics"):
        for k, v in theirs[role].items():
            assert mine[role][k] == pytest.approx(v, abs=1e-5), (role, k)


def test_fit_writes_a_profiler_trace_of_the_step(data_dir, tmp_path):
    cfg = _config(data_dir, device_cache=True)
    trace_dir = str(tmp_path / "trace")
    cfg["training"].update(epochs=2, profiler_trace_dir=trace_dir)
    _train(tmp_path, "traced", cfg, run, device="cpu")
    assert os.listdir(trace_dir) == ["epoch_1.pt.trace.json"]
    with open(os.path.join(trace_dir, "epoch_1.pt.trace.json")) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    # the store's gather, the sublayers' autograd Functions (B1's and B2's
    # wrappers, their plain versions on the CPU) both ways, the loss's
    # sort and SGD's step
    for op in ("aten::index_select", "AttentionSublayer", "FFNSublayer",
               "AttentionSublayerBackward", "FFNSublayerBackward",
               "aten::sort"):
        assert op in names, op
    assert any(n.startswith("Optimizer.step#SGD") for n in names)
    cfg["training"].update(epochs=1, profiler_trace_dir=str(tmp_path / "one"))
    _train(tmp_path, "traced_once", cfg, run, device="cpu")
    assert os.listdir(tmp_path / "one") == ["epoch_0.pt.trace.json"]
