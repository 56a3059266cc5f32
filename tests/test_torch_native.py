"""The port's host C++ libraries (allrank_tpu_torch/native, data/native.py)
and what reads and writes through them (data/dataset.py's parser and
binary cache, data/saving.py, data/validate.py) against the JAX package's
on the same seeded files.

Tolerances: none. Parsed arrays, cached arrays and validation summaries
are equal bit for bit, written files byte for byte (both packages run the
same C++ text on the same inputs), and the port's numpy parser reads
every file as its C++ parser does (each rounds the same decimal text to
float32 once)."""

import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import allrank_tpu.data.dataset as jd
import allrank_tpu.data.validate as jvalidate
from allrank_tpu.data import batching as jb
from allrank_tpu.data.native import write_svmlight_native as jwrite_native
from allrank_tpu.data.saving import write_to_libsvm_without_masked as jsave
from allrank_tpu_torch.data import batching as tb
from allrank_tpu_torch.data import dataset as td
from allrank_tpu_torch.data import native
from allrank_tpu_torch.data import validate as tvalidate
from allrank_tpu_torch.data.saving import write_to_libsvm_without_masked

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# WEB30K's label marginals (grades 0-4), as tools/make_web30k_surrogate.py
MARGINALS = [0.514, 0.325, 0.134, 0.019, 0.008]


def web30k_arrays(n_queries, seed=0, n_features=136):
    """(X, y, qid) of WEB30K's shape: 136 features of spread scales (some
    negative, some zero), labels 0-4 at WEB30K's marginals, slate lengths
    lognormal about 120 documents."""
    rng = np.random.RandomState(seed)
    lengths = np.clip(rng.lognormal(4.35, 0.8, n_queries).astype(int), 5,
                      1308)
    n = int(lengths.sum())
    scale = (10.0 ** rng.uniform(-1, 3, n_features)).astype(np.float32)
    X = rng.randn(n, n_features).astype(np.float32) * scale
    X[:, 110:125] = -np.abs(X[:, 110:125])
    X[rng.rand(n, n_features) < 0.05] = 0.0
    y = rng.choice(5, size=n, p=MARGINALS).astype(np.float32)
    return X, y, np.repeat(np.arange(1, n_queries + 1), lengths)


def _same(a, b):
    for u, v in zip(a, b, strict=True):
        assert u.dtype == v.dtype and u.shape == v.shape
        np.testing.assert_array_equal(u, v)


@pytest.fixture(scope="module")
def web30k_file(tmp_path_factory):
    """A WEB30K-shaped file of 40 queries (some 6 MB: the parser splits it
    over threads), one-based as MSLR's own files, six significant digits
    as the surrogate tool writes."""
    X, y, qid = web30k_arrays(40, seed=1)
    path = str(tmp_path_factory.mktemp("web30k") / "train.txt")
    cells = np.char.add(np.array([f"{j + 1}:" for j in range(X.shape[1])]),
                        np.char.mod("%.6g", X))
    with open(path, "w") as f:
        for d in range(len(y)):
            keep = X[d] != 0
            f.write(f"{int(y[d])} qid:{qid[d]} " + " ".join(cells[d][keep])
                    + "\n")
    return path


# -- the parser ---------------------------------------------------------------

TEXT_CASES = {
    "one_based": ("2 qid:10 1:0.5 3:-1.25e-3\n0 qid:10 2:7\n"
                  "1.5 qid:11 4:1e10\n"),
    "zero_based": "1 qid:1 0:2 2:3\n0 qid:1 1:4.25\n3 qid:2 2:-0.5\n",
    "comments_and_blank_lines": ("# a header\n2 qid:3 1:0.5 # trailing\n\n"
                                 "   \n0 qid:3 2:7\t3:1\r\n1 qid:4 1:1\n"),
    "no_qid": "1 1:2 3:3\n0 2:4\n2 1:0.25\n",
    "featureless": "1 qid:1\n0 qid:1\n2 qid:2\n",
}


@pytest.mark.parametrize("case", sorted(TEXT_CASES))
def test_parser_is_jax_s_and_the_numpy_parser_s(tmp_path, case):
    path = str(tmp_path / f"{case}.txt")
    with open(path, "w") as f:
        f.write(TEXT_CASES[case])
    got = td.parse_svmlight(path)
    _same(got, jd.parse_svmlight(path))
    _same(got, td.parse_svmlight(path, backend="numpy"))
    _same(got, td.parse_svmlight(io.BytesIO(TEXT_CASES[case].encode())))
    if case == "featureless":  # declined by the C++ parser: F = 1
        assert native.parse_svmlight_native(path) is None
        assert got[0].shape == (3, 1) and not got[0].any()
    else:
        assert native.parse_svmlight_native(path) is not None
    if case == "no_qid":
        assert not got[2].any()


def test_parser_on_a_web30k_shaped_file(web30k_file):
    got = td.parse_svmlight(web30k_file)
    assert got[0].shape[1] == 136 and got[0].dtype == np.float32
    assert os.path.getsize(web30k_file) > (1 << 20)  # several threads
    _same(got, jd.parse_svmlight(web30k_file))
    _same(got, td.parse_svmlight(web30k_file, backend="numpy"))


def test_parser_errors_and_backends(tmp_path):
    bad = tmp_path / "bad.txt"
    bad.write_text("1 qid:1 0:2 junk\n")
    assert native.parse_svmlight_native(str(bad)) is None
    with pytest.raises(ValueError, match="malformed"):
        td.parse_svmlight(str(bad))
    with pytest.raises(FileNotFoundError):
        td.parse_svmlight(str(tmp_path / "missing.txt"))
    with pytest.raises(ValueError, match="backend"):
        td.parse_svmlight(str(bad), backend="sklearn")


def test_build_raises_without_gxx_and_on_a_broken_source(tmp_path,
                                                         monkeypatch):
    """No fallback: a build that cannot run, or fails, raises with g++'s
    output; a build into an empty directory makes a loadable library."""
    out = native.build("libsvm_writer", build_dir=str(tmp_path / "fresh"))
    assert os.path.exists(out) and out.startswith(str(tmp_path))
    assert out == native.library_path("libsvm_writer",
                                      str(tmp_path / "fresh"))
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="g[+][+] not found"):
        native.build("libsvm_parser", build_dir=str(tmp_path / "nogxx"))
    monkeypatch.undo()
    broken = tmp_path / "src"
    broken.mkdir()
    (broken / "libsvm_parser.cpp").write_text("int f() { return missing; }\n")
    monkeypatch.setattr(native, "NATIVE_DIR", str(broken))
    with pytest.raises(RuntimeError, match="missing"):
        native.build("libsvm_parser", build_dir=str(tmp_path / "broken"))
    assert not [p for p in os.listdir(tmp_path / "broken")
                if p.endswith(".so") or ".tmp" in p]


# -- the binary cache -----------------------------------------------------------

@pytest.fixture
def cache_files(tmp_path, web30k_file):
    """Two copies of one file: the port's and the JAX package's cache."""
    mine, theirs = str(tmp_path / "mine.txt"), str(tmp_path / "theirs.txt")
    shutil.copyfile(web30k_file, mine)
    shutil.copyfile(web30k_file, theirs)
    return mine, theirs


def test_cache_round_trip_memmap_direct_and_read_only(cache_files,
                                                      monkeypatch):
    mine, theirs = cache_files
    ref = td.parse_svmlight(mine)
    first = td.parse_svmlight_cached(mine)  # a miss: the memmap-direct parse
    _same(first, jd.parse_svmlight_cached(theirs))
    _same(first, ref)
    x_p = td._cache_paths(mine)[1]
    assert isinstance(first[0], np.memmap) and not first[0].flags.writeable
    assert os.path.exists(x_p) and not [
        p for p in os.listdir(os.path.dirname(x_p)) if ".tmp" in p]
    for name in ("meta.json", "X.npy", "y.npy", "qids.npy"):
        with open(f"{mine}.npycache.{name}", "rb") as a, open(
                f"{theirs}.npycache.{name}", "rb") as b:
            if name == "meta.json":  # the stamps of two copies
                assert json.load(a).keys() == json.load(b).keys()
            else:
                assert a.read() == b.read(), name

    def boom(*args, **kwargs):
        raise AssertionError("parsed despite a warm cache")

    monkeypatch.setattr(td, "parse_svmlight", boom)
    monkeypatch.setattr(td, "parse_svmlight_native", boom)
    hit = td.parse_svmlight_cached(mine)
    assert isinstance(hit[0], np.memmap) and not hit[0].flags.writeable
    _same(hit, ref)
    with pytest.raises(ValueError):
        hit[0][0, 0] = 1.0


def test_cache_in_memory_path_is_read_only_and_cleans_up(cache_files,
                                                         monkeypatch):
    """Where the memmap-direct parse fails after mapping its file, the
    cache parses in memory, leaves no temporary file and hands out a
    read-only X, as the JAX package's."""
    mine, theirs = cache_files
    real = native.parse_svmlight_native

    def fail_after_alloc(path, x_alloc=None):
        if x_alloc is not None:
            x_alloc(4, 3)
            return None
        return real(path)

    monkeypatch.setattr(td, "parse_svmlight_native", fail_after_alloc)
    got = td.parse_svmlight_cached(mine)
    assert not isinstance(got[0], np.memmap) and not got[0].flags.writeable
    _same(got, jd.parse_svmlight_cached(theirs))
    assert not [p for p in os.listdir(os.path.dirname(mine)) if ".tmp" in p]
    _same(td.parse_svmlight_cached(mine), got)  # and it is a hit now


def test_cache_invalidates_on_change_and_misses_on_corrupt_meta(cache_files):
    mine, theirs = cache_files
    td.parse_svmlight_cached(mine)
    jd.parse_svmlight_cached(theirs)
    for path in (mine, theirs):
        with open(path, "a") as f:
            f.write("3 qid:999999 1:0.5 7:1.25\n")
    got = td.parse_svmlight_cached(mine)
    assert got[2][-1] == 999999
    _same(got, jd.parse_svmlight_cached(theirs))
    _same(td.parse_svmlight_cached(mine), got)
    meta_p = td._cache_paths(mine)[0]
    with open(meta_p, "w") as f:
        f.write("{not json")
    _same(td.parse_svmlight_cached(mine), got)
    with open(meta_p) as f:
        assert json.load(f)["size"] == os.path.getsize(mine)


def test_cache_write_failure_degrades_to_a_plain_parse(cache_files,
                                                       monkeypatch):
    mine, _ = cache_files

    def no_save(*args, **kwargs):
        raise OSError("read-only filesystem")

    monkeypatch.setattr(td.np, "save", no_save)
    _same(td.parse_svmlight_cached(mine), td.parse_svmlight(mine))
    assert not os.path.exists(td._cache_paths(mine)[0])


def test_batches_through_the_cached_dataset_are_jax_s(cache_files):
    mine, theirs = cache_files
    td.parse_svmlight_cached(mine)  # warm
    cached = td.SlateDataset.from_svm_file(mine, binary_cache=True)
    plain = td.SlateDataset.from_svm_file(mine)
    ref = jd.SlateDataset.from_svm_file(theirs, binary_cache=True)
    base = cached._flat_X
    while not isinstance(base, np.memmap):  # X stays memory-mapped
        base = base.base
    for epoch in (0, 1):
        batchers = [tb.SlateBatcher(ds, 100, 8, shuffle=True, seed=3)
                    for ds in (cached, plain)]
        batchers.append(jb.SlateBatcher(ref, 100, 8, shuffle=True, seed=3))
        for b in batchers:
            b.set_epoch(epoch)
        for a, b, c in zip(*batchers, strict=True):
            _same(a, b)
            _same(a, c)


# -- the writer -------------------------------------------------------------------

def _slates(case, seed=4, F=9):
    rng = np.random.RandomState(seed)
    xs, ys = [], []
    for n in (5, 9, 1, 7):
        x = (rng.randn(9, F) * 10.0 ** rng.randint(-6, 6, (9, F))
             ).astype(np.float32)
        x[rng.rand(9, F) < 0.3] = 0.0
        y = rng.randint(0, 5, 9).astype(
            np.int32 if case == "int_labels" else np.float32)
        if case == "float_labels":
            y = y + np.float32(0.25)
        x[n:], y[n:] = 0.0, -1
        if case == "base_pinned":
            x[:, 0] = 0.0
        xs.append(x)
        ys.append(y)
    return xs, ys


@pytest.mark.parametrize("case", ["int_labels", "float_labels",
                                  "base_pinned"])
def test_written_files_are_jax_s_byte_for_byte(tmp_path, case):
    xs, ys = _slates(case)
    mine, theirs = str(tmp_path / "mine.txt"), str(tmp_path / "theirs.txt")
    write_to_libsvm_without_masked(mine, xs, ys)
    jsave(theirs, xs, ys)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    with open(mine) as f:
        assert (f.readline().split()[2] == "0:0") == (case == "base_pinned")
    keep = np.concatenate(ys) != -1
    X, y, qid = td.parse_svmlight(mine)
    np.testing.assert_array_equal(X, np.concatenate(xs)[keep])
    np.testing.assert_array_equal(y, np.concatenate(ys)[keep])
    np.testing.assert_array_equal(qid, np.repeat(np.arange(4), (5, 9, 1, 7)))
    # the plain Python writer, by name, reads back to the same arrays
    plain = str(tmp_path / "plain.txt")
    write_to_libsvm_without_masked(plain, xs, ys, writer="python")
    _same(td.parse_svmlight(plain), (X, y, qid))
    with pytest.raises(ValueError, match="writer"):
        write_to_libsvm_without_masked(plain, xs, ys, writer="sklearn")


def test_web30k_shaped_writes_at_any_thread_count(tmp_path):
    X, y, qid = web30k_arrays(12, seed=5)
    files = {}
    for threads in (1, 4):
        path = str(tmp_path / f"t{threads}.txt")
        native.write_svmlight_native(X, y, qid, path, n_threads=threads)
        with open(path, "rb") as f:
            files[threads] = f.read()
    ref = str(tmp_path / "jax.txt")
    assert jwrite_native(X, y, qid, ref)
    with open(ref, "rb") as f:
        assert files[1] == files[4] == f.read()
    _same(td.parse_svmlight(str(tmp_path / "t1.txt")), (X, y, qid))
    with pytest.raises(OSError, match="cannot open"):
        native.write_svmlight_native(X, y, qid, str(tmp_path / "no" / "x"))
    with pytest.raises(ValueError, match="expected"):
        native.write_svmlight_native(X, y[:-1], qid, str(tmp_path / "x"))


# -- the validator ------------------------------------------------------------------

def _write_role(d, role, X, y, qid):
    os.makedirs(d, exist_ok=True)
    native.write_svmlight_native(np.asarray(X, np.float32), y, qid,
                                 os.path.join(d, f"{role}.txt"))


def _validation_dirs(root):
    """{case: (dir, roles, slate_length, strict)}, each case as
    tests/data/test_validate.py builds it, on WEB30K-shaped data."""
    X, y, qid = web30k_arrays(6, seed=7, n_features=12)
    cases = {}
    clean = str(root / "clean")
    _write_role(clean, "train", X, y, qid)
    _write_role(clean, "vali", X[:200], y[:200], qid[:200])
    cases["clean"] = (clean, ["train", "vali"], None, False)
    cases["strict"] = (clean, ["train", "vali"], 50, True)
    nan = str(root / "nan")
    Xn = X.copy()
    Xn[3, 2] = np.nan
    _write_role(nan, "train", Xn, y, qid)
    _write_role(nan, "vali", X[:, :10], y, qid)  # a dimension mismatch
    cases["nan_and_dims"] = (nan, ["train", "vali"], None, False)
    cases["missing_role"] = (clean, ["train", "test"], None, False)
    mixed = str(root / "mixed")
    _write_role(mixed, "train", X[:9], y[:9] + 0.5,
                np.array([5, 5, 9, 5, 2, 9, 9, 2, 5]))
    cases["non_contiguous"] = (mixed, ["train"], 2, False)
    return cases


@pytest.mark.parametrize("case", ["clean", "strict", "nan_and_dims",
                                  "missing_role", "non_contiguous"])
def test_validator_is_jax_s(tmp_path, case):
    d, roles, slate_length, strict = _validation_dirs(tmp_path)[case]
    rc = tvalidate.run(d, roles, slate_length, strict)
    assert rc == jvalidate.run(d, roles, slate_length, strict)
    # warnings fail only under --strict
    assert rc == (0 if case in ("clean", "non_contiguous") else 1)
    for role in roles:
        path = os.path.join(d, f"{role}.txt")
        if os.path.exists(path):
            got = tvalidate.validate_role(path, slate_length)
            assert got == jvalidate.validate_role(path, slate_length)
            assert got[0] is not None
            if case == "non_contiguous":
                assert any("non-contiguous" in w for w in got[2])


def test_validate_cli_exit_codes(tmp_path):
    cases = _validation_dirs(tmp_path)
    for case, want in (("clean", 0), ("strict", 1), ("missing_role", 1)):
        d, roles, slate_length, strict = cases[case]
        args = ["--ds_path", d, "--roles", ",".join(roles)]
        if slate_length:
            args += ["--slate_length", str(slate_length)]
        if strict:
            args.append("--strict")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        out = subprocess.run(
            [sys.executable, "-m", "allrank_tpu_torch.data.validate", *args],
            capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
        assert out.returncode == want, (case, out.stderr[-2000:])
