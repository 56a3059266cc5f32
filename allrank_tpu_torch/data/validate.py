"""Pre-flight dataset validation CLI (the JAX package's ``data/validate.py``):

    python -m allrank_tpu_torch.data.validate --ds_path <dir>
        [--roles train,vali] [--slate_length 240] [--strict]

Catches the data problems that otherwise surface as silent quality loss or
mid-training crashes:

  ERRORS (exit 1):
    * a role file that fails to parse, or is empty;
    * NaN / Inf feature values or labels;
    * feature-dimension mismatch across roles (the CLIs raise at load
      time; here it shows before a model is built);
  WARNINGS (exit 1 only with --strict):
    * non-contiguous qid rows (SlateDataset regroups these correctly with
      a warning);
    * negative labels other than the -1 padding convention;
    * non-integer graded labels (legal, but usually a preprocessing bug);
    * slates longer than --slate_length (they will be subsampled for the
      train role) and single-document slates;
    * all-zero feature columns (dead features; also the writer base-pin
      case).

Prints a per-role summary table either way.
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np

from allrank_tpu_torch.data.dataset import parse_svmlight
from allrank_tpu_torch.utils.ltr_logging import get_logger

logger = get_logger()


def validate_role(path: str, slate_length: int | None):
    """Returns (summary dict, errors [str], warnings [str])."""
    errors, warnings = [], []
    try:
        X, y, qids = parse_svmlight(path)
    except Exception as exc:
        return None, [f"failed to parse: {exc}"], []
    if len(y) == 0:
        return None, ["file parsed to zero rows"], []

    n_bad_x = int(np.count_nonzero(~np.isfinite(X)))
    if n_bad_x:
        errors.append(f"{n_bad_x} NaN/Inf feature values")
    if not np.all(np.isfinite(y)):
        errors.append("NaN/Inf labels")

    uniq, counts = np.unique(qids, return_counts=True)
    n_blocks = 1 + int(np.count_nonzero(qids[1:] != qids[:-1]))
    if n_blocks != len(uniq):
        warnings.append(
            f"non-contiguous qid rows ({n_blocks} blocks for {len(uniq)} "
            "qids) — SlateDataset regroups correctly (reference would "
            "scramble)")

    neg = y[(y < 0) & (y != -1.0)]
    if neg.size:
        warnings.append(f"{neg.size} negative labels outside the -1 "
                        "padding convention")
    frac = y[np.isfinite(y)]
    if np.any(frac != np.round(frac)):
        warnings.append("non-integer labels (legal, but unusual for "
                        "graded relevance)")

    if slate_length is not None:
        n_long = int(np.count_nonzero(counts > slate_length))
        if n_long:
            warnings.append(f"{n_long} slates longer than {slate_length} "
                            "(the train role subsamples these; eval roles "
                            "pad to their own longest)")
    n_single = int(np.count_nonzero(counts == 1))
    if n_single:
        warnings.append(f"{n_single} single-document slates")
    dead = int(np.count_nonzero(~np.any(X != 0.0, axis=0)))
    if dead:
        warnings.append(f"{dead} all-zero feature columns")

    # label range over REAL labels: -1.0 is the padding convention and is
    # reported separately (padding warning above), not as label_min
    real = y[y != -1.0]
    summary = {
        "rows": int(len(y)), "slates": int(len(uniq)),
        "features": int(X.shape[1]),
        "slate_len_min": int(counts.min()), "slate_len_max": int(counts.max()),
        "slate_len_mean": round(float(counts.mean()), 1),
        "label_min": float(real.min()) if real.size else -1.0,
        "label_max": float(real.max()) if real.size else -1.0,
        "padded_rows": int(len(y) - real.size),
    }
    return summary, errors, warnings


def run(ds_path: str, roles, slate_length=None, strict=False) -> int:
    n_errors = n_warnings = 0
    feature_dims = {}
    for role in roles:
        path = os.path.join(ds_path, f"{role}.txt")
        if not os.path.exists(path):
            logger.error("%s: missing (%s)", role, path)
            n_errors += 1
            continue
        summary, errors, warnings = validate_role(path, slate_length)
        if summary:
            feature_dims[role] = summary["features"]
            logger.info("%s: %s", role,
                        " ".join(f"{k}={v}" for k, v in summary.items()))
        for e in errors:
            logger.error("%s: %s", role, e)
        for w in warnings:
            logger.warning("%s: %s", role, w)
        n_errors += len(errors)
        n_warnings += len(warnings)

    if len(set(feature_dims.values())) > 1:
        logger.error("feature-dimension mismatch across roles: %s",
                     feature_dims)
        n_errors += 1

    if n_errors:
        logger.error("validation FAILED: %d error(s), %d warning(s)",
                     n_errors, n_warnings)
        return 1
    if n_warnings and strict:
        logger.error("validation FAILED (--strict): %d warning(s)",
                     n_warnings)
        return 1
    logger.info("validation OK: 0 errors, %d warning(s)", n_warnings)
    return 0


def main() -> None:
    ap = ArgumentParser("allRank-tpu-torch dataset validator")
    ap.add_argument("--ds_path", required=True)
    ap.add_argument("--roles", default="train,vali",
                    help="comma-separated role file stems")
    ap.add_argument("--slate_length", type=int, default=None)
    ap.add_argument("--strict", action="store_true",
                    help="warnings also fail (exit 1)")
    args = ap.parse_args()
    sys.exit(run(args.ds_path, [r for r in args.roles.split(",") if r],
                 args.slate_length, args.strict))


if __name__ == "__main__":
    main()
