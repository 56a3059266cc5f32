"""LibSVM slate datasets grouped by query id (the JAX package's
``data/dataset.py``).

Rows are grouped by qid in first-appearance order; the train role is fixed
to ``slate_length`` (pad or subsample), validation roles are padded to their
own longest slate. Files are read by the C++ parser (``data/native.py``);
the numpy parser stays as its plain version, chosen by name, and reads what
the C++ parser declines. ``parse_svmlight_cached`` keeps a parsed file in
``.npy`` files beside it, with X memory-mapped.
"""

from __future__ import annotations

import glob
import json
import os
import time
import uuid
import warnings
from typing import List, Tuple

import numpy as np

from allrank_tpu_torch.data.native import parse_svmlight_native
from allrank_tpu_torch.utils.ltr_logging import get_logger

logger = get_logger()

_CHUNK_LINES = 20000


def _parse_chunk(lines):
    """(labels, qids, nnz per line, feature indices, values) of a list of
    ``label [qid:N] idx:val ...`` lines without comments; a line without
    ``qid:`` has qid 0."""
    has_qid = np.fromiter((b"qid:" in ln for ln in lines), dtype=bool,
                          count=len(lines))
    nnz = np.fromiter((ln.count(b":") for ln in lines), dtype=np.int64,
                      count=len(lines)) - has_qid
    text = b" ".join(lines).replace(b"qid:", b" ").replace(b":", b" ")
    malformed = ("malformed libsvm text: every line must read "
                 "'label qid:N idx:val ...'")
    with warnings.catch_warnings():
        # numpy stops at a token that is no number and only warns
        warnings.simplefilter("error")
        try:
            flat = np.fromstring(text.decode("ascii"), dtype=np.float64,
                                 sep=" ")
        except (DeprecationWarning, ValueError) as e:
            raise ValueError(malformed) from e
    width = 1 + has_qid + 2 * nnz
    if (nnz < 0).any() or flat.size != int(width.sum()):
        raise ValueError(malformed)
    starts = np.concatenate([[0], np.cumsum(width)[:-1]])
    is_head = np.zeros(flat.size, dtype=bool)
    is_head[starts] = True
    is_head[(starts + 1)[has_qid]] = True
    pairs = flat[~is_head].reshape(-1, 2)
    qids = np.where(has_qid, flat[np.minimum(starts + 1, flat.size - 1)], 0.0)
    return (flat[starts], qids, nnz, pairs[:, 0].astype(np.int64),
            pairs[:, 1].astype(np.float32))


def _parse_svmlight_numpy(data: bytes
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    lines = data.split(b"\n")
    if b"#" in data:
        lines = [ln.split(b"#", 1)[0] for ln in lines]
    lines = [ln for ln in lines if ln.strip()]
    if not lines:
        raise ValueError("empty libsvm file")
    parts = [_parse_chunk(lines[i:i + _CHUNK_LINES])
             for i in range(0, len(lines), _CHUNK_LINES)]
    y, qids, nnz, idx, val = (np.concatenate(p) for p in zip(*parts))
    if idx.size and idx.min() > 0:
        idx = idx - 1
    if idx.size and idx.min() < 0:
        raise ValueError("negative feature index in libsvm text")
    # scikit-learn's count: a file whose rows have no features has one
    n_features = (int(idx.max()) if idx.size else 0) + 1
    X = np.zeros((len(y), n_features), dtype=np.float32)
    X[np.repeat(np.arange(len(y)), nnz), idx] = val
    return X, y.astype(np.float32), qids.astype(np.int64)


def parse_svmlight(path_or_stream, backend: str = "native"
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return (X dense [N, F] float32, y [N] float32, qids [N] int64).

    Feature indices are taken as one-based when no index 0 occurs, else as
    zero-based (scikit-learn's ``zero_based="auto"``); F is the largest
    index seen plus one, 1 when no row has a feature. Text after ``#`` on a
    line is ignored; a line without ``qid:`` has qid 0.

    ``backend="native"`` reads a path with the C++ parser; what it declines
    (a file without any feature, or one it cannot read or parse) goes to
    the numpy parser, which reads it or raises saying why.
    ``backend="numpy"`` is the plain version alone; a stream is always read
    by it."""
    if backend not in ("native", "numpy"):
        raise ValueError(f"unknown libsvm parser backend {backend!r} "
                         "(expected 'native' or 'numpy')")
    if isinstance(path_or_stream, (str, os.PathLike)):
        if backend == "native":
            parsed = parse_svmlight_native(os.fspath(path_or_stream))
            if parsed is not None:
                return parsed
        with open(path_or_stream, "rb") as f:
            data = f.read()
    else:
        data = path_or_stream.read()
        if isinstance(data, str):
            data = data.encode("ascii")
    return _parse_svmlight_numpy(data)


_CACHE_VERSION = 1


def _cache_paths(path: str):
    base = str(path) + ".npycache"
    return (base + ".meta.json", base + ".X.npy", base + ".y.npy",
            base + ".qids.npy")


def _publish(arrays, meta_p: str, stamp: dict) -> None:
    """Write each (path, array) as ``.npy`` through a temporary name and an
    atomic rename, then the meta stamp last: a write cut short leaves no
    meta and reads as a miss, never as a corrupt hit."""
    for p, arr in arrays:
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            np.save(f, arr)
        os.replace(tmp, p)
    with open(meta_p + ".tmp", "w") as f:
        json.dump(stamp, f)
    os.replace(meta_p + ".tmp", meta_p)


def parse_svmlight_cached(path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``parse_svmlight`` behind a binary cache beside the file: the first
    load writes ``<path>.npycache.{X,y,qids}.npy`` and a meta stamp of the
    source's size and mtime; later loads memory-map X (no parse; the OS
    pages the matrix in as it is read). The cache is stale when the source
    changes. A cache that cannot be written degrades to a plain parse with
    a warning. Processes that load one file at once are safe: each writes
    the same bytes and publishes by atomic rename, the stamp last.

    The first parse fills X straight into the future ``.npy`` file through
    a writable memory map, so a corpus larger than host memory never exists
    densely in it. The returned X is read-only on every path: copy it
    before changing it."""
    meta_p, x_p, y_p, q_p = _cache_paths(path)
    st = os.stat(path)
    stamp = {"version": _CACHE_VERSION, "size": st.st_size,
             "mtime_ns": st.st_mtime_ns}
    try:
        with open(meta_p) as f:
            if json.load(f) == stamp:
                x = np.load(x_p, mmap_mode="r")
                y = np.load(y_p)
                qids = np.load(q_p)
                logger.info("dataset cache hit: %s (X memory-mapped)", x_p)
                return x, y, qids
            logger.info("dataset cache stale for %s; re-parsing", path)
    except (OSError, ValueError):
        pass

    direct = _parse_direct_to_memmap(path, x_p)
    if direct is not None:
        x, y, qids = direct
        try:
            _publish(((y_p, y), (q_p, qids)), meta_p, stamp)
            logger.info("wrote dataset cache %s (memmap-direct parse)", x_p)
        except OSError as exc:
            logger.warning("dataset cache meta write failed (%s); cache "
                           "will miss next run", exc)
        return x, y, qids

    x, y, qids = parse_svmlight(path)
    try:
        _publish(((x_p, x), (y_p, y), (q_p, qids)), meta_p, stamp)
        logger.info("wrote dataset cache %s", x_p)
    except OSError as exc:
        logger.warning("dataset cache write failed (%s); continuing uncached",
                       exc)
    # X is read-only on every path, as the hits' memory map is
    x.flags.writeable = False
    return x, y, qids


_STALE_TMP_AGE_S = 24 * 3600


def _reap_stale_tmps(x_p: str) -> None:
    """Remove ``<x_p>.tmp.<hex>`` files older than a day, left by parses
    that were killed. The age spares live writers; a writer whose file is
    removed keeps its mapping (the inode outlives the name), and its
    rename then fails over to the in-memory parse."""
    for p in glob.glob(glob.escape(x_p) + ".tmp.*"):
        try:
            if time.time() - os.stat(p).st_mtime > _STALE_TMP_AGE_S:
                os.unlink(p)
                logger.info("removed stale parse tmp %s", p)
        except OSError:
            pass


def _parse_direct_to_memmap(path, x_p: str):
    """The C++ parse of ``path`` with X filled through a writable memory
    map of a temporary ``.npy`` file, published to ``x_p`` by atomic
    rename; returns (X read-only memory map, y, qids), or None where the
    parser declines the file or the cache directory is not writable (the
    caller then parses in memory)."""
    # each process maps a file of its own: a second writer truncating a
    # shared one would fault the first one's next write to its map
    tmp = "%s.tmp.%s" % (x_p, uuid.uuid4().hex)
    _reap_stale_tmps(x_p)
    state: dict = {}

    def alloc(n_rows: int, n_features: int) -> np.ndarray:
        state["x"] = np.lib.format.open_memmap(
            tmp, mode="w+", dtype=np.float32, shape=(n_rows, n_features))
        return state["x"]

    try:
        res = parse_svmlight_native(os.fspath(path), x_alloc=alloc)
    except OSError as exc:  # open_memmap failed: a read-only dataset dir
        logger.info("memmap-direct parse unavailable (%s)", exc)
        res = None
    if res is None or "x" not in state:
        if "x" in state:
            del state["x"]
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return None
    _, y, qids = res
    xm = state.pop("x")
    xm.flush()
    del xm  # close the writable map before publishing
    try:
        os.replace(tmp, x_p)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return np.load(x_p, mmap_mode="r"), y, qids


class SlateDataset:
    """Slates (query groups) of documents: per-qid feature/label arrays."""

    def __init__(self, X: np.ndarray, y: np.ndarray, query_ids: np.ndarray):
        X = np.asarray(X, dtype=np.float32)
        y = np.asarray(y, dtype=np.float32)
        query_ids = np.asarray(query_ids)

        # group rows by qid preserving first-appearance order
        _, first_idx, inverse, counts = np.unique(
            query_ids, return_index=True, return_inverse=True,
            return_counts=True)

        # the boundary split below assumes each qid's rows are contiguous
        # (true for every standard LTR file); a non-contiguous file would be
        # grouped silently wrong, so detect it and regroup instead
        n_blocks = (1 + int(np.count_nonzero(query_ids[1:] != query_ids[:-1]))
                    if len(query_ids) else 0)
        if n_blocks != len(counts):
            logger.warning(
                "query ids are NOT contiguous (%d row blocks for %d unique "
                "qids): regrouping rows by first qid appearance",
                n_blocks, len(counts))
            row_order = np.argsort(first_idx[inverse], kind="stable")
            X = X[row_order]
            y = y[row_order]
            query_ids = query_ids[row_order]

        order = np.argsort(first_idx)
        boundaries = np.cumsum(counts[order])[:-1]

        self.X_by_qid: List[np.ndarray] = np.split(X, boundaries)
        self.y_by_qid: List[np.ndarray] = np.split(y, boundaries)
        self.longest_query_length = max(len(a) for a in self.y_by_qid)
        # the flat views: X_by_qid[i] is X[offsets[i]:offsets[i + 1]]
        self._flat_X = np.ascontiguousarray(X)
        self._flat_y = np.ascontiguousarray(y)
        self._offsets = np.concatenate(
            [[0], np.cumsum(counts[order])]).astype(np.int64)

        logger.info("loaded dataset with %d queries", len(self.X_by_qid))
        logger.info("longest query had %d documents",
                    self.longest_query_length)

    @classmethod
    def from_svm_file(cls, svm_file_path,
                      binary_cache: bool = False) -> "SlateDataset":
        """Parse ``svm_file_path``; with ``binary_cache`` through
        ``parse_svmlight_cached`` (X memory-mapped)."""
        parse = parse_svmlight_cached if binary_cache else parse_svmlight
        x, y, qids = parse(svm_file_path)
        logger.info("loaded dataset from %s with x shape %s, y shape %s",
                    svm_file_path, x.shape, y.shape)
        return cls(x, y, qids)

    def __len__(self) -> int:
        return len(self.X_by_qid)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.X_by_qid[idx], self.y_by_qid[idx]

    @property
    def n_features(self) -> int:
        return self.X_by_qid[0].shape[-1]

    def flat_slate_buffers(self):
        """(X [N_docs, F], y [N_docs], offsets [n_slates + 1], index_map):
        the rows of every slate in slate order, where slate i is rows
        ``offsets[i]:offsets[i + 1]``; index_map None is the identity. The
        device feature store uploads X, and the index batches address its
        rows."""
        return self._flat_X, self._flat_y, self._offsets, None

    @property
    def shape(self) -> List[int]:
        return [len(self), self.longest_query_length, self.n_features]


def load_dataset_role(role: str, input_path: str, slate_length: int,
                      binary_cache: bool = False):
    """Load ``{input_path}/{role}.txt``; returns (dataset, effective slate
    length). Train slates fix to ``slate_length``; other roles pad to their
    longest slate. ``binary_cache`` loads through the ``.npy`` cache
    (``parse_svmlight_cached``)."""
    path = os.path.join(input_path, f"{role}.txt")
    logger.info("loading %s data from %s", role, path)
    ds = SlateDataset.from_svm_file(path, binary_cache=binary_cache)
    if role == "train":
        effective = int(slate_length)
    else:
        effective = int(ds.longest_query_length)
        logger.info("padding %s role to longest slate: %d", role, effective)
    return ds, effective


def load_dataset(input_path: str, slate_length: int, validation_ds_role: str,
                 binary_cache: bool = False
                 ) -> Tuple["SlateDataset", int, "SlateDataset", int]:
    """Load train + validation datasets; returns (train_ds, train_len,
    val_ds, val_len)."""
    train_ds, train_len = load_dataset_role("train", input_path, slate_length,
                                            binary_cache=binary_cache)
    val_ds, val_len = load_dataset_role(validation_ds_role, input_path,
                                        slate_length,
                                        binary_cache=binary_cache)
    return train_ds, train_len, val_ds, val_len
