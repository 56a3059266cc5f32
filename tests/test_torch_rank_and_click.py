"""The port's offline ranking and rank-and-click CLI
(allrank_tpu_torch/inference/, rank_and_click.py, data/saving.py,
data/feature_store.py) against the JAX package's, on a 1-block d 16 model
of seeded random weights carried across by ``interop.load_jax_params`` and
a tiny ragged dataset, and the device feature store's index feed against
the materialising one, in rank-and-click and in evaluate.

Tolerances: ranked labels, clicks, libsvm files (by parse), CSV values and
the two feeds' outputs exactly; ranked features exactly wherever two
neighbouring scores are more than 1e-5 apart."""

import csv
import functools
import json
import os
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allrank_tpu.config import Config as JaxConfig
import allrank_tpu.data.native as jnative
from allrank_tpu.data import batching as jb
from allrank_tpu.data.dataset import SlateDataset as JaxDataset
from allrank_tpu.data.dataset import parse_svmlight as jax_parse
from allrank_tpu.data.saving import write_to_libsvm_without_masked as jwrite
from allrank_tpu.inference import inference_utils as ji
from allrank_tpu.models import factory as jfactory
from allrank_tpu.rank_and_click import run as jax_rank_and_click
from allrank_tpu.training.checkpoint import save_params
from allrank_tpu_torch.click_models import (
    BaseCascadeModel,
    DiverseClicksModel,
    OnlyRelevantClickModel,
)
from allrank_tpu_torch.click_models.device_models import as_device_click_fn
from allrank_tpu_torch.config import Config
from allrank_tpu_torch.constants import PADDED_Y_VALUE
from allrank_tpu_torch.data import batching as tb
from allrank_tpu_torch.data.dataset import SlateDataset, parse_svmlight
from allrank_tpu_torch.data.dummy import write_svmlight
from allrank_tpu_torch.data.feature_store import (
    DeviceFeatureStore,
    effective_sharding,
    resolve_store_dtype,
    table_gather,
)
from allrank_tpu_torch.data.saving import write_to_libsvm_without_masked
from allrank_tpu_torch.evaluate import parse_args as evaluate_args
from allrank_tpu_torch.evaluate import run as evaluate
from allrank_tpu_torch.inference import inference_utils as ti
from allrank_tpu_torch.interop import load_jax_params
from allrank_tpu_torch.models.factory import LTRModel, make_model
from allrank_tpu_torch.rank_and_click import parse_args
from allrank_tpu_torch.rank_and_click import run as rank_and_click

torch.set_num_threads(2)

F = 8
CLICK_MODELS = {
    "only_relevant": {"name": "allrank.click_models.base."
                              "OnlyRelevantClickModel",
                      "args": {"relevancy_threshold": 2}},
    "fixed": {"name": "allrank_tpu.click_models.base.FixedClickModel",
              "args": {"click_positions": [0, 2]}},
    "duplicates": {"name": "allrank_tpu.click_models.duplicate_aware."
                           "EverythingButDuplicatesClickModel",
                   "args": {"duplicate_margin": 0.5}},
}


def _config(data_path, click_model=None, **data):
    return {
        "model": {
            "fc_model": {"sizes": [16], "input_norm": False,
                         "activation": "ReLU", "dropout": None},
            "transformer": {"N": 1, "d_ff": 32, "h": 2, "dropout": 0.0,
                            "positional_encoding": {"strategy": "fixed",
                                                    "max_indices": 20}},
            "post_model": {"d_output": 1},
        },
        "data": {"path": data_path, "num_workers": 0, "batch_size": 8,
                 "slate_length": 12, "validation_ds_role": "vali", **data},
        "optimizer": {"name": "Adam", "args": {"lr": 1e-2}},
        "lr_scheduler": {"name": "StepLR",
                         "args": {"step_size": 10, "gamma": 0.1}},
        "training": {"epochs": 1, "gradient_clipping_norm": None},
        "loss": {"name": "listNet", "args": {}},
        "metrics": ["ndcg_5", "mrr_5"],
        "val_metric": "ndcg_5",
        "expected_metrics": {},
        "click_model": click_model,
        "parallel": {"data": 1},
    }


def _ragged(seed, n_slates, lo=3, hi=15):
    """(X, y, qid): slates of ``lo``-``hi`` documents, labels 0-4, every
    slate repeating a document (for the duplicate-aware model) with its
    label, so that whichever of the two tied copies ranks first, the
    ranked slate is the same."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(lo, hi, size=n_slates)
    X = rng.randn(int(lengths.sum()), F).astype(np.float32)
    X[rng.rand(*X.shape) < 0.2] = 0.0
    X[:, 0] = rng.rand(len(X)) + 0.5  # column 0 carries values
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    X[starts + 2] = X[starts + 1]
    y = rng.randint(0, 5, size=len(X))
    y[starts + 2] = y[starts + 1]
    return X, y, np.repeat(np.arange(n_slates), lengths)


@pytest.fixture(autouse=True, params=["python", "native"])
def python_assembly(request, monkeypatch):
    """Each test on both assemblies: for "python" the JAX package's Python
    batch assembly and the port's Python row loop (chosen by name in the
    port's ranking functions), which make the same ``RandomState`` draws;
    for "native" both packages' default C++ assemblers, which draw the
    same splitmix64 streams. Returns the assembly."""
    if request.param == "python":
        monkeypatch.setattr(jnative, "_load_assembler", lambda: None)
        monkeypatch.setattr(ti, "SlateBatcher", functools.partial(
            tb.SlateBatcher, assembly="python"))
    return request.param


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """A ragged dataset (train and vali), a model.npz of seeded random
    weights written by the JAX package, and both packages' models."""
    root = tmp_path_factory.mktemp("rank_and_click")
    data = str(root / "data")
    os.makedirs(data)
    for role, seed in (("train", 0), ("vali", 1)):
        write_svmlight(os.path.join(data, f"{role}.txt"), *_ragged(seed, 30))
    cfg = _config(data)
    mdef = jfactory.make_model(JaxConfig.from_dict(cfg).model, F)
    params = jax.tree.map(np.asarray,
                          jfactory.init_params(jax.random.PRNGKey(3), mdef))
    npz = str(root / "model.npz")
    save_params(params, npz)
    model = load_jax_params(LTRModel(make_model(
        Config.from_dict(cfg).model, F), device="cpu"), params)
    return root, data, npz, mdef, params, model


def _datasets(data):
    path = os.path.join(data, "vali.txt")
    return SlateDataset(*parse_svmlight(path)), JaxDataset(*jax_parse(path))


# -- ranking ------------------------------------------------------------------

def test_rank_slates_dataset_is_jax_s(job):
    root, data, _, mdef, params, model = job
    ds, jds = _datasets(data)
    L = ds.longest_query_length
    x, y = ti.rank_slates_dataset(ds, L, model, batch_size=8)
    jx, jy = ji.rank_slates_dataset(jds, L, params, mdef, batch_size=8)
    assert x.shape == jx.shape == (len(ds), L, F)
    np.testing.assert_array_equal(y, jy)
    # the scores of the ranked slates, to find neighbours within 1e-5
    scores = np.asarray(jfactory.score(
        params, mdef, jnp.asarray(jx), jnp.asarray(jy == PADDED_Y_VALUE),
        jnp.ones(jy.shape, jnp.int32), train=False))
    scores = np.where(jy == PADDED_Y_VALUE, -1e30, scores)
    gaps = -np.diff(scores, axis=1)
    near = np.zeros_like(jy, dtype=bool)
    near[:, :-1] |= gaps <= 1e-5
    near[:, 1:] |= gaps <= 1e-5
    np.testing.assert_array_equal(x[~near], jx[~near])
    real = jy != PADDED_Y_VALUE
    assert (~near[real]).mean() > 0.7  # each slate holds a tied duplicate
    # padding last, with zero features
    pad = y == PADDED_Y_VALUE
    assert (x[pad] == 0).all()
    assert (np.diff(pad.astype(int), axis=1) >= 0).all()


def test_index_mode_ranks_as_the_materialising_feed(job):
    _, data, _, _, _, model = job
    ds, _ = _datasets(data)
    L = ds.longest_query_length
    x, y = ti.rank_slates_dataset(ds, L, model, batch_size=8)
    xi, yi = ti.rank_slates_dataset_indexed(ds, L, model, batch_size=8)
    np.testing.assert_array_equal(x, xi)
    np.testing.assert_array_equal(y, yi)


@pytest.mark.parametrize("click", ["cascade", "diverse"])
def test_index_mode_clicks_as_the_materialising_feed(job, click):
    _, data, _, _, _, model = job
    ds, _ = _datasets(data)
    L = ds.longest_query_length
    cascade = BaseCascadeModel(1, 1)
    fn = as_device_click_fn(cascade if click == "cascade"
                            else DiverseClicksModel(cascade, 0.5))
    got = ti.rank_and_click_dataset_indexed(ds, L, model, 8, fn,
                                            include_empty=True, seed=5)
    ref = ti.rank_and_click_dataset(ds, L, model, 8, fn, include_empty=True,
                                    seed=5)
    assert len(got[0]) == len(ref[0]) == len(ds)
    for a, b in zip(got[0] + got[1], ref[0] + ref[1]):
        np.testing.assert_array_equal(a, b)
    # another seed draws other clicks
    other = ti.rank_and_click_dataset(ds, L, model, 8, fn, include_empty=True,
                                      seed=6)
    assert any((a != b).any() for a, b in zip(other[1], ref[1]))


def test_device_clicks_on_ranked_slates_are_the_batch_function_s(job):
    """rank_and_click_dataset clicks each ranked batch with the batch
    function under ClickKey(seed, batch)."""
    from allrank_tpu_torch.click_models.device_models import ClickKey

    _, data, _, _, _, model = job
    ds, _ = _datasets(data)
    L = ds.longest_query_length
    fn = as_device_click_fn(BaseCascadeModel(0.5, 1))
    xs, clicks = ti.rank_and_click_dataset(ds, L, model, 8, fn,
                                           include_empty=True, seed=9)
    ranked_x, ranked_y = ti.rank_slates_dataset(ds, L, model, 8)
    np.testing.assert_array_equal(np.stack(xs), ranked_x)
    for i in range(0, len(ds), 8):
        want = fn(ClickKey(9, i // 8), torch.from_numpy(
            np.pad(ranked_y[i:i + 8], ((0, 8 - len(ranked_y[i:i + 8])),
                                       (0, 0)), constant_values=-1)))
        np.testing.assert_array_equal(np.stack(clicks[i:i + 8]),
                                      want.numpy()[:len(ranked_y[i:i + 8])])


# -- the writer and the metrics -------------------------------------------------

@pytest.mark.parametrize("case", ["ragged", "base_pinned", "float_labels"])
def test_libsvm_writer_reads_back_as_jax_s(tmp_path, case):
    rng = np.random.RandomState(4)
    xs, ys = [], []
    for n in (5, 9, 1, 7):
        x = (rng.randn(9, F) * 10.0 ** rng.randint(-6, 6, (9, F))
             ).astype(np.float32)
        x[rng.rand(9, F) < 0.3] = 0.0
        y = rng.randint(0, 2, 9).astype(np.int32 if case == "ragged"
                                        else np.float32)
        x[n:], y[n:] = 0.0, PADDED_Y_VALUE
        if case == "base_pinned":
            x[:, 0] = 0.0
        xs.append(x)
        ys.append(y)
    mine, theirs = str(tmp_path / "mine.txt"), str(tmp_path / "theirs.txt")
    write_to_libsvm_without_masked(mine, xs, ys)
    jwrite(theirs, xs, ys)
    for parse in (parse_svmlight, jax_parse):
        for got, ref in zip(parse(mine), parse(theirs)):
            assert got.dtype == ref.dtype and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref)
    X, y, qid = parse_svmlight(mine)
    keep = np.concatenate(ys) != PADDED_Y_VALUE
    np.testing.assert_array_equal(X, np.concatenate(xs)[keep])
    np.testing.assert_array_equal(qid, np.repeat(np.arange(4), (5, 9, 1, 7)))
    with open(mine) as f:
        first = f.readline().split()
    assert (first[2] == "0:0") == (case == "base_pinned")


def test_metrics_on_clicked_slates_are_jax_s():
    rng = np.random.RandomState(5)
    clicks = [rng.randint(0, 2, 12) for _ in range(6)]
    clicks[1][:] = 0
    clicks[2][8:] = PADDED_Y_VALUE
    xs = [np.zeros((12, 2))] * 6
    got = list(ti.metrics_on_clicked_slates((xs, clicks)))
    ref = list(ji.metrics_on_clicked_slates((xs, clicks)))
    assert got == ref
    assert got[1]["ndcg"] == 1.0 and got[2]["slate_length"] == 12


# -- the index batches ------------------------------------------------------------

@pytest.mark.parametrize("bucketed", [False, True])
def test_index_batches_are_jax_s(bucketed, python_assembly):
    X, y, qid = _ragged(2, 21, lo=1, hi=20)
    ds, jds = SlateDataset(X, y, qid), JaxDataset(X, y, qid)

    def batches(pkg, data, emit):
        kw = {"assembly": python_assembly} if pkg is tb else {}
        if bucketed:
            return list(pkg.BucketedSlateBatcher(data, 4, n_buckets=3,
                                                 emit_row_indices=emit,
                                                 **kw))
        # the train role's shape: long slates subsampled, shuffled
        batcher = pkg.SlateBatcher(data, 10, 4, shuffle=True, seed=3,
                                   emit_row_indices=emit, **kw)
        batcher.set_epoch(2)
        return list(batcher)

    got, want = batches(tb, ds, True), batches(jb, jds, True)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for u, v in zip(a, b):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)
    # a slot's row holds the feature row the materialising batch holds
    flat = ds.flat_slate_buffers()[0]
    table = np.concatenate([flat, np.zeros((1, F), np.float32)])
    for idx, mat in zip(got, batches(tb, ds, False)):
        np.testing.assert_array_equal(table[idx.x], mat.x)
        for u, v in zip(idx[1:], mat[1:]):
            np.testing.assert_array_equal(u, v)


def test_feature_store_table_gather_and_rules():
    X, y, qid = _ragged(3, 6)
    ds = SlateDataset(X, y, qid)
    store = DeviceFeatureStore(ds, device="cpu")
    assert store.sentinel == len(X) and store.table.shape == (len(X) + 1, F)
    assert not store.table[-1].any() and store.table.dtype == torch.float32
    idx = torch.tensor([[0, 5, len(X)], [len(X), 1, 2]], dtype=torch.int32)
    np.testing.assert_array_equal(table_gather(store.table, idx).numpy(),
                                  store.table.numpy()[idx.numpy()])
    bf16 = DeviceFeatureStore(ds, device="cpu", dtype="bfloat16")
    assert torch.equal(bf16.table, store.table.to(torch.bfloat16))
    assert DeviceFeatureStore(ds, device="cpu", sharding="sharded"
                              ).sharding == "replicated"
    with pytest.raises(ValueError, match="device_cache_sharding"):
        DeviceFeatureStore(ds, device="cpu", sharding="rows")
    assert effective_sharding("sharded") == "replicated"
    assert effective_sharding("sharded", 4) == "sharded"
    assert resolve_store_dtype("auto", "bfloat16") == "bfloat16"
    assert resolve_store_dtype("auto", "float32") is None
    assert resolve_store_dtype("float32", "bfloat16") == "float32"


# -- the CLIs ---------------------------------------------------------------------

def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], np.array(rows[1:], dtype=np.float64)


def _cli_args(root, run_id, cfg_path, npz, roles=("vali", "train")):
    return parse_args(["--job-dir", str(root / "job"), "--run-id", run_id,
                       "--config-file-name", cfg_path,
                       "--input-model-path", npz,
                       "--roles", ",".join(roles)])


@pytest.mark.parametrize("click", sorted(CLICK_MODELS))
def test_rank_and_click_cli_is_jax_s(job, click):
    root, data, npz, *_ = job
    cfg_path = str(root / f"{click}.json")
    with open(cfg_path, "w") as f:
        json.dump(_config(data, CLICK_MODELS[click]), f)
    ref = jax_rank_and_click(_cli_args(root, f"jax_{click}", cfg_path, npz))
    got = rank_and_click(_cli_args(root, f"torch_{click}", cfg_path, npz),
                         device="cpu")
    assert sorted(got) == sorted(ref) == ["train", "vali"]
    out = os.path.join(root / "job", "results")
    for role in ("vali", "train"):
        assert got[role] == pytest.approx(ref[role], rel=0, abs=0)
        mine = os.path.join(out, f"torch_{click}", f"{role}.txt")
        theirs = os.path.join(out, f"jax_{click}", f"{role}.txt")
        for a, b in zip(parse_svmlight(mine), parse_svmlight(theirs)):
            np.testing.assert_array_equal(a, b)
        for name in (f"{role}_metrics.csv", f"{role}_metrics_mean.csv"):
            head, vals = _read_csv(os.path.join(out, f"torch_{click}", name))
            rhead, rvals = _read_csv(os.path.join(out, f"jax_{click}", name))
            assert head == rhead == ["slate_length", "no_of_clicks", "dcg",
                                     "ndcg"]
            np.testing.assert_array_equal(vals, rvals)
    with open(os.path.join(out, f"torch_{click}", "used_config.json")) as f:
        assert json.load(f)["click_model"] == CLICK_MODELS[click]


@pytest.mark.parametrize("click", ["fixed", "duplicates", "cascade"])
def test_rank_and_click_cli_device_cache_writes_the_same_files(job, click):
    root, data, npz, *_ = job
    model = CLICK_MODELS.get(click, {
        "name": "allrank_tpu_torch.click_models.cascade_models."
                "BaseCascadeModel", "args": {"eta": 1, "threshold": 1}})
    files = {}
    for cache in (False, True):
        cfg_path = str(root / f"{click}_{cache}.json")
        with open(cfg_path, "w") as f:
            json.dump(_config(data, model, device_cache=cache), f)
        run_id = f"cache_{click}_{cache}"
        rank_and_click(_cli_args(root, run_id, cfg_path, npz), device="cpu")
        out = os.path.join(root / "job", "results", run_id)
        files[cache] = {}
        for name in ("vali.txt", "train.txt", "vali_metrics.csv",
                     "vali_metrics_mean.csv", "train_metrics.csv"):
            with open(os.path.join(out, name), "rb") as f:
                files[cache][name] = f.read()
    assert files[True] == files[False]


def test_rank_and_click_cli_arguments_and_refusals(job, tmp_path):
    root, data, npz, *_ = job
    args = parse_args(["--job-dir", "j", "--run-id", "r",
                       "--config-file-name", "c.json",
                       "--input-model-path", "m.npz", "--roles", "train,vali"])
    assert args.roles == ["train", "vali"]
    cfg_path = str(tmp_path / "none.json")
    with open(cfg_path, "w") as f:
        json.dump(_config(data, None), f)
    with pytest.raises(ValueError, match="click_model"):
        rank_and_click(_cli_args(root, "none", cfg_path, npz), device="cpu")
    with open(cfg_path, "w") as f:
        json.dump({**_config(data, CLICK_MODELS["fixed"]),
                   "parallel": {"data": 2}}, f)
    with pytest.raises(NotImplementedError, match="parallel"):
        rank_and_click(_cli_args(root, "par", cfg_path, npz), device="cpu")


# -- evaluate over the feature store -------------------------------------------

@pytest.mark.parametrize("variant", ["padded", "buckets", "bfloat16"])
def test_evaluate_device_cache_matches_the_materialising_feed(job, variant):
    root, data, npz, *_ = job
    results = {}
    for cache in (False, True):
        cfg = _config(data, device_cache=cache,
                      eval_buckets=3 if variant == "buckets" else 0)
        if variant == "bfloat16":
            cfg["training"]["compute_dtype"] = "bfloat16"
        cfg_path = str(root / f"eval_{variant}_{cache}.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        args = evaluate_args(["--job-dir", str(root / "job"), "--run-id",
                              f"eval_{variant}_{cache}",
                              "--config-file-name", cfg_path,
                              "--input-model-path", npz,
                              "--roles", "vali,train"])
        results[cache] = evaluate(args, device="cpu")
    assert results[True] == results[False]
    assert 0.0 < results[True]["vali"]["ndcg_5"] <= 1.0


def test_rank_and_click_namespace_runs_as_the_parser_s(job):
    """run() takes a Namespace as the JAX package's does."""
    root, data, npz, *_ = job
    cfg_path = str(root / "ns.json")
    with open(cfg_path, "w") as f:
        json.dump(_config(data, {"name": "allrank_tpu_torch.click_models."
                                         "base.OnlyRelevantClickModel",
                                 "args": {"relevancy_threshold": 1}}), f)
    got = rank_and_click(Namespace(
        job_dir=str(root / "job"), run_id="ns", config_file_name=cfg_path,
        input_model_path=npz, roles=["vali"]), device="cpu")
    assert set(got["vali"]) == {"slate_length", "no_of_clicks", "dcg",
                                "ndcg"}
    assert OnlyRelevantClickModel(1).click((None, np.array([0, 1]))).tolist() \
        == [False, True]
