"""The port's dataset parser, dummy writer and batchers against the JAX
package's on the same files and seeds: identical arrays (the parsers read
the same decimal text into float32; the batchers make the same draws). The
batchers are held on both assemblies: the Python row loops (the same
``RandomState`` draws) and the C++ assemblers (the same splitmix64
streams), each package's default."""

import io
import os

import numpy as np
import pytest
import torch

import allrank_tpu.data.native as jnative
from allrank_tpu.data import batching as jb
from allrank_tpu.data import dataset as jd
from allrank_tpu.data import dummy as jdummy
from allrank_tpu.data import slate_fixing as jfix
from allrank_tpu_torch.data import batching as tb
from allrank_tpu_torch.data import dataset as td
from allrank_tpu_torch.data import dummy as tdummy
from allrank_tpu_torch.data import slate_fixing as tfix


@pytest.fixture(params=["python", "native"])
def assembly(request, monkeypatch):
    """The assembly both packages' batchers run: the JAX package's Python
    row loop where its C++ assembler is switched off, else its default."""
    if request.param == "python":
        monkeypatch.setattr(jnative, "_load_assembler", lambda: None)
    return request.param


@pytest.fixture(scope="module")
def dummy_dirs(tmp_path_factory):
    ours = str(tmp_path_factory.mktemp("ours"))
    theirs = str(tmp_path_factory.mktemp("theirs"))
    kw = dict(num_queries=23, results_len=9, num_features=7, seed=3)
    tdummy.write_dummy_dataset(ours, **kw)
    jdummy.write_dummy_dataset(theirs, **kw)
    return ours, theirs


def _assert_same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("role", ["train", "vali"])
def test_dummy_writer_and_parser_match_jax(dummy_dirs, role):
    ours, theirs = dummy_dirs
    mine = td.parse_svmlight(os.path.join(ours, f"{role}.txt"))
    assert mine[0].shape == (23 * 9, 7) and mine[2].dtype == np.int64
    # each package's parser on each package's file: one content
    for path in (ours, theirs):
        _assert_same(mine, td.parse_svmlight(os.path.join(path,
                                                          f"{role}.txt")))
        _assert_same(mine, jd.parse_svmlight(os.path.join(path,
                                                          f"{role}.txt")))
    with open(os.path.join(ours, f"{role}.txt")) as a, open(
            os.path.join(theirs, f"{role}.txt")) as b:
        assert a.read() == b.read()


def test_generate_dummy_data_makes_the_same_draws():
    a = tdummy.generate_dummy_data(5, 4, 5, 6, np.random.RandomState(1))
    b = jdummy.generate_dummy_data(5, 4, 5, 6, np.random.RandomState(1))
    _assert_same(a, b)


def test_parser_reads_sparse_one_based_and_commented_lines(tmp_path):
    text = ("2 qid:10 1:0.5 3:-1.25e-3 # a comment\n"
            "0 qid:10 2:7\n"
            "\n"
            "1.5 qid:11 4:1e10\n")
    path = tmp_path / "sparse.txt"
    path.write_text(text)
    x, y, q = td.parse_svmlight(str(path))
    ref = jd._parse_svmlight_sklearn(io.BytesIO(text.encode()))
    _assert_same((x, y, q), ref)
    assert x.shape == (3, 4) and x[0, 2] == np.float32(-1.25e-3)
    # zero-based when an index 0 occurs; a stream works like a path
    zx, _, _ = td.parse_svmlight(io.BytesIO(b"1 qid:1 0:2 2:3\n"))
    np.testing.assert_array_equal(zx, [[2, 0, 3]])
    with pytest.raises(ValueError, match="malformed"):
        td.parse_svmlight(io.BytesIO(b"1 qid:1 0:2 junk\n"))
    with pytest.raises(ValueError, match="empty"):
        td.parse_svmlight(io.BytesIO(b"\n"))


def test_writer_leaves_out_zeros_like_sklearn(tmp_path):
    from sklearn.datasets import dump_svmlight_file

    rng = np.random.RandomState(0)
    x = rng.randn(6, 5)
    x[1, 2] = 0.0
    x[4] = 0.0
    y = np.array([0.5, 1, 2, 3, 4, 0])
    qid = np.array([1, 1, 2, 2, 3, 3])
    tdummy.write_svmlight(str(tmp_path / "a.txt"), x, y, qid)
    dump_svmlight_file(x, y, str(tmp_path / "b.txt"), query_id=qid)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()


def test_non_contiguous_qids_regroup_like_jax(tmp_path):
    rng = np.random.RandomState(2)
    x = rng.randn(12, 3)
    y = rng.randint(0, 3, 12)
    qid = np.array([5, 5, 9, 5, 2, 9, 9, 2, 5, 7, 2, 7])
    path = str(tmp_path / "mixed.txt")
    tdummy.write_svmlight(path, x, y, qid)
    mine = td.SlateDataset.from_svm_file(path)
    ref = jd.SlateDataset.from_svm_file(path)
    assert len(mine) == len(ref) == 4
    assert mine.longest_query_length == ref.longest_query_length == 4
    assert mine.shape == ref.shape
    for i in range(4):
        _assert_same(mine[i], ref[i])
    # first-appearance order: qid 5 first, its four rows together
    np.testing.assert_array_equal(mine[0][1], y[qid == 5].astype(np.float32))


def test_load_dataset_roles_and_unported_options(dummy_dirs):
    ours, _ = dummy_dirs
    train_ds, train_len, val_ds, val_len = td.load_dataset(ours, 6, "vali")
    ref = jd.load_dataset(ours, 6, "vali")
    assert (train_len, val_len) == (ref[1], ref[3]) == (6, 9)
    assert train_ds.n_features == val_ds.n_features == 7
    # the binary cache, once ported, loads the same slates as the parse
    cached = td.load_dataset(ours, 6, "vali", binary_cache=True)
    assert (cached[1], cached[3]) == (6, 9)
    for plain, ds in ((train_ds, cached[0]), (val_ds, cached[2])):
        for i in range(len(plain)):
            _assert_same(plain[i], ds[i])


def test_slate_fixing_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(9, 4).astype(np.float32)
    for y in (np.array([0, 0, 1, 0, 0, 0, 0, 0, 0], np.float32),
              np.zeros(9, np.float32),
              rng.randint(0, 3, 9).astype(np.float32)):
        for length in (4, 9, 12):
            a = tfix.fix_slate(x, y, length, np.random.RandomState(7))
            b = jfix.fix_slate(x, y, length, np.random.RandomState(7))
            _assert_same(a, b)


@pytest.mark.parametrize("slate_length,batch_size,shuffle",
                         [(6, 4, True), (9, 5, True), (14, 8, False)])
def test_slate_batcher_matches_jax_batch_for_batch(
        dummy_dirs, assembly, slate_length, batch_size, shuffle):
    ours, _ = dummy_dirs
    mine = tb.SlateBatcher(td.SlateDataset.from_svm_file(ours + "/train.txt"),
                           slate_length, batch_size, shuffle=shuffle, seed=5,
                           assembly=assembly)
    ref = jb.SlateBatcher(jd.SlateDataset.from_svm_file(ours + "/train.txt"),
                          slate_length, batch_size, shuffle=shuffle, seed=5)
    assert len(mine) == len(ref) == -(-23 // batch_size)
    for epoch in (0, 3):
        mine.set_epoch(epoch)
        ref.set_epoch(epoch)
        batches = list(mine)
        for a, b in zip(batches, ref):
            _assert_same(a, b)
        assert len(batches) == len(mine)
        last = batches[-1]
        n_real = 23 - batch_size * (len(mine) - 1)
        assert last.slate_mask.sum() == n_real
        assert (last.y[n_real:] == -1).all() and not last.x[n_real:].any()


def _ragged_dataset(cls):
    rng = np.random.RandomState(4)
    lengths = rng.randint(1, 30, size=37)
    x = rng.randn(int(lengths.sum()), 5)
    y = rng.randint(0, 5, len(x))
    return cls(x, y, np.repeat(np.arange(37), lengths))


def test_bucketed_batcher_matches_jax_batch_for_batch(assembly):
    mine = tb.BucketedSlateBatcher(_ragged_dataset(td.SlateDataset), 8,
                                   n_buckets=3, assembly=assembly)
    ref = jb.BucketedSlateBatcher(_ragged_dataset(jd.SlateDataset), 8,
                                  n_buckets=3)
    assert [(n, idx.tolist()) for n, idx in mine.buckets] == [
        (n, idx.tolist()) for n, idx in ref.buckets]
    assert len(mine) == len(ref)
    mine.set_epoch(1)
    ref.set_epoch(1)
    batches = list(mine)
    assert len(batches) == len(mine)
    for a, b in zip(batches, ref):
        _assert_same(a, b)
    assert sorted({b.y.shape[1] for b in batches}) == [
        n for n, _ in mine.buckets]


@pytest.mark.parametrize("what,kw", [
    ("local_rows", {"local_rows": np.arange(2)}),
    ("num_workers", {"num_workers": 4})])
def test_unported_batcher_options_raise(what, kw):
    """local_rows raises; num_workers > 1, ported since, assembles the
    batches of one worker on either assembly."""
    ds = _ragged_dataset(td.SlateDataset)
    if what == "local_rows":
        with pytest.raises(NotImplementedError, match=what):
            tb.SlateBatcher(ds, 8, 4, **kw)
        with pytest.raises(NotImplementedError, match=what):
            tb.BucketedSlateBatcher(ds, 4, **kw)
        return
    for assembly in ("native", "python"):
        one = tb.SlateBatcher(ds, 8, 4, shuffle=True, num_workers=1,
                              assembly=assembly)
        many = tb.SlateBatcher(ds, 8, 4, shuffle=True, assembly=assembly,
                               **kw)
        for a, b in zip(one, many, strict=True):
            _assert_same(a, b)
    with pytest.raises(ValueError, match="assembly"):
        tb.SlateBatcher(ds, 8, 4, assembly="rust")


def test_device_prefetcher_on_the_cpu_yields_the_same_batches():
    ds = _ragged_dataset(td.SlateDataset)
    batcher = tb.SlateBatcher(ds, 12, 8, shuffle=True)
    fed = list(tb.DevicePrefetcher(batcher, device="cpu"))
    assert len(fed) == len(batcher)
    for got, ref in zip(fed, batcher):
        assert isinstance(got, tb.SlateBatch)
        for t, a in zip(got, ref):
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), a)
    assert fed[0].x.dtype == torch.float32
    assert fed[0].slate_mask.dtype == torch.bool
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.DevicePrefetcher(batcher)  # no GPU here and no explicit CPU
