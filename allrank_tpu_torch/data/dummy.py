"""Dummy libsvm dataset generator (the JAX package's ``data/dummy.py``): the
same ``RandomState`` draws, written by this module's own libsvm writer."""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def generate_dummy_data(num_queries: int = 100, results_len: int = 20,
                        num_labels: int = 5, num_features: int = 20,
                        rng: np.random.RandomState = None
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """X ~ N(0,1); y = max(0, int(mean((X+1)/2) * num_labels)); slates of a
    fixed size."""
    rng = rng or np.random
    X = rng.randn(num_queries * results_len, num_features)
    y = np.maximum(
        0, (((X + 1) / 2).mean(axis=-1) * num_labels).astype(np.int32))
    qid = np.repeat(np.arange(0, num_queries), results_len)
    return X, y, qid


def write_svmlight(path: str, X: np.ndarray, y: np.ndarray,
                   qid: np.ndarray) -> None:
    """Write ``label qid:N idx:val ...`` lines with zero-based feature
    indices and ``%.16g`` values, zero-valued features left out (the text
    scikit-learn's ``dump_svmlight_file`` writes)."""
    X = np.asarray(X)
    y = np.asarray(y)
    label = "%d" if np.issubdtype(y.dtype, np.integer) else "%.16g"
    head = label + " qid:%d"
    dense = head + "".join(f" {j}:%.16g" for j in range(X.shape[1])) + "\n"
    has_zero = ~X.all(axis=1)
    with open(path, "w") as f:
        # Python numbers format several times faster than numpy scalars
        for i, (target, q) in enumerate(zip(y.tolist(),
                                            np.asarray(qid).tolist())):
            row = X[i].tolist()
            if not has_zero[i]:  # one format call per line
                f.write(dense % (target, q, *row))
            else:
                f.write(head % (target, q) + " " + " ".join(
                    f"{j}:{v:.16g}" for j, v in enumerate(row) if v != 0)
                    + "\n")


def write_dummy_dataset(output_dir: str, num_queries: int = 100,
                        results_len: int = 20, num_labels: int = 5,
                        num_features: int = 20, seed: int = 42) -> str:
    """Write seeded train.txt + vali.txt under output_dir; returns
    output_dir."""
    rng = np.random.RandomState(seed)
    os.makedirs(output_dir, exist_ok=True)
    for role in ("train", "vali"):
        X, y, qid = generate_dummy_data(num_queries, results_len, num_labels,
                                        num_features, rng)
        write_svmlight(os.path.join(output_dir, f"{role}.txt"), X, y, qid)
    return output_dir


if __name__ == "__main__":
    from argparse import ArgumentParser

    parser = ArgumentParser("Dummy data")
    parser.add_argument("--num_queries", type=int, default=100)
    parser.add_argument("--results_len", type=int, default=20)
    parser.add_argument("--num_labels", type=int, default=5)
    parser.add_argument("--num_features", type=int, default=20)
    parser.add_argument("--output_dir", default="dummy_data")
    args = parser.parse_args()
    write_dummy_dataset(args.output_dir, args.num_queries, args.results_len,
                        args.num_labels, args.num_features)
