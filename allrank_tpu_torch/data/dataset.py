"""LibSVM slate datasets grouped by query id (the JAX package's
``data/dataset.py``).

Rows are grouped by qid in first-appearance order; the train role is fixed
to ``slate_length`` (pad or subsample), validation roles are padded to their
own longest slate. The parser is this module's own, in numpy: the JAX
package's C++ parser, its binary cache and the file validator are not
ported yet.
"""

from __future__ import annotations

import os
import warnings
from typing import List, Tuple

import numpy as np

from allrank_tpu_torch.utils.ltr_logging import get_logger

logger = get_logger()

_CHUNK_LINES = 20000


def _parse_chunk(lines):
    """(labels, qids, nnz per line, feature indices, values) of a list of
    ``label qid:N idx:val ...`` lines without comments."""
    nnz = np.fromiter((ln.count(b":") for ln in lines), dtype=np.int64,
                      count=len(lines)) - 1
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
    if (nnz < 0).any() or flat.size != int((2 + 2 * nnz).sum()):
        raise ValueError(malformed)
    starts = np.concatenate([[0], np.cumsum(2 + 2 * nnz)[:-1]])
    is_head = np.zeros(flat.size, dtype=bool)
    is_head[starts] = True
    is_head[starts + 1] = True
    pairs = flat[~is_head].reshape(-1, 2)
    return (flat[starts], flat[starts + 1], nnz, pairs[:, 0].astype(np.int64),
            pairs[:, 1].astype(np.float32))


def parse_svmlight(path_or_stream
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return (X dense [N, F] float32, y [N] float32, qids [N] int64).

    Feature indices are taken as one-based when no index 0 occurs, else as
    zero-based (scikit-learn's ``zero_based="auto"``); F is the largest
    index seen plus one, 1 when no row has a feature. Text after ``#`` on a
    line is ignored."""
    if isinstance(path_or_stream, (str, os.PathLike)):
        with open(path_or_stream, "rb") as f:
            data = f.read()
    else:
        data = path_or_stream.read()
        if isinstance(data, str):
            data = data.encode("ascii")
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
    def from_svm_file(cls, svm_file_path) -> "SlateDataset":
        x, y, qids = parse_svmlight(svm_file_path)
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
    longest slate."""
    if binary_cache:
        raise NotImplementedError(
            "data.binary_cache is not yet ported to allrank_tpu_torch")
    path = os.path.join(input_path, f"{role}.txt")
    logger.info("loading %s data from %s", role, path)
    ds = SlateDataset.from_svm_file(path)
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
