"""Rank-and-click CLI (the JAX package's ``rank_and_click.py``): loads a
trained checkpoint, ranks every slate of the requested dataset roles on the
GPU, applies the configured click model, writes the click-through data back
in libsvm form and per-slate DCG/NDCG statistics as CSV::

    python -m allrank_tpu_torch.rank_and_click --job-dir /out \\
        --run-id clicks --config-file-name config.json \\
        --input-model-path model.npz --roles train,vali

Writes ``<role>.txt``, ``<role>_metrics.csv``, ``<role>_metrics_mean.csv``
and ``used_config.json`` under ``<job-dir>/results/<run-id>/``. A click
model with a batch formulation (``click_models/device_models.py``) runs on
the device fused with the ranking; any other (an
EverythingButDuplicatesClickModel among them) clicks on the host after it.
``data.device_cache: true`` feeds the ranking from the device feature
store; ``data.binary_cache: true`` loads each role through its ``.npy``
cache. The files are read and written by the host C++ parser and writer
(``data/native.py``), so they are byte for byte the JAX package's. Runs on
the GPU; ``run(args, device="cpu")`` runs the plain versions on the CPU.
Uses neither pandas nor scikit-learn.
"""

from __future__ import annotations

import csv
import os
import shutil
from argparse import ArgumentParser, Namespace
from pprint import pformat

import numpy as np
import torch

from allrank_tpu_torch.click_models.click_utils import click_on_slates
from allrank_tpu_torch.click_models.device_models import as_device_click_fn
from allrank_tpu_torch.config import Config
from allrank_tpu_torch.data.dataset import load_dataset_role
from allrank_tpu_torch.data.saving import write_to_libsvm_without_masked
from allrank_tpu_torch.inference.inference_utils import (
    metrics_on_clicked_slates,
    rank_and_click_dataset,
    rank_and_click_dataset_indexed,
    rank_slates,
    rank_slates_dataset_indexed,
)
from allrank_tpu_torch.models.factory import LTRModel, make_model
from allrank_tpu_torch.training.checkpoint import load_params
from allrank_tpu_torch.utils.args_utils import split_as_strings
from allrank_tpu_torch.utils.device import require_one_device, resolve_device
from allrank_tpu_torch.utils.file_utils import (
    PathsContainer,
    create_output_dirs,
)
from allrank_tpu_torch.utils.ltr_logging import init_logger
from allrank_tpu_torch.utils.python_utils import (
    all_equal,
    instantiate_from_recursive_name_args,
)

METRIC_COLUMNS = ("slate_length", "no_of_clicks", "dcg", "ndcg")


def parse_args(argv=None) -> Namespace:
    parser = ArgumentParser("allRank-tpu-torch rank and apply click model")
    parser.add_argument("--job-dir", required=True,
                        help="Base output path for all experiments")
    parser.add_argument("--run-id", required=True,
                        help="Name of this run (must be unique within "
                             "output dir)")
    parser.add_argument("--config-file-name", required=True,
                        help="Path of the json experiment config")
    parser.add_argument("--input-model-path", required=True,
                        help="Path to the .npz checkpoint to load")
    parser.add_argument("--roles", required=True, type=split_as_strings,
                        help="Comma-separated dataset roles to load and "
                             "process")
    return parser.parse_args(argv)


def _cell(v) -> str:
    """A CSV cell as pandas' ``to_csv`` writes it: ints as they are,
    floats in their shortest round-trip form."""
    return str(v) if isinstance(v, (int, np.integer)) else repr(float(v))


def write_metrics_csvs(rows, path: str, mean_path: str) -> dict:
    """``<role>_metrics.csv`` (one row a slate) and
    ``<role>_metrics_mean.csv`` (the column means, summed in float64 as
    pandas sums them); returns the means."""
    columns = {c: [r[c] for r in rows] for c in METRIC_COLUMNS}
    means = {c: float(np.sum(np.asarray(v), dtype=np.float64) / len(v))
             for c, v in columns.items()}
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(METRIC_COLUMNS)
        writer.writerows([_cell(r[c]) for c in METRIC_COLUMNS] for r in rows)
    with open(mean_path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(METRIC_COLUMNS)
        writer.writerow([repr(means[c]) for c in METRIC_COLUMNS])
    return means


def run(args: Namespace = None, device=None) -> dict:
    """Rank and click as the arguments say; returns ``{role: {column:
    mean}}``. ``device=None`` is the GPU (an error when there is none),
    ``device="cpu"`` the plain versions on the CPU."""
    args = args or parse_args()
    dev = resolve_device(device)
    np.random.seed(42)

    paths = PathsContainer.from_args(args.job_dir, args.run_id,
                                     args.config_file_name)
    os.makedirs(paths.base_output_path, exist_ok=True)
    create_output_dirs(paths.output_dir)
    logger = init_logger(paths.output_dir)
    logger.info("will save data in %s", paths.base_output_path)

    config = Config.from_json(paths.config_path)
    logger.info("Config: %s", pformat(config))
    shutil.copy2(paths.config_path,
                 os.path.join(paths.output_dir, "used_config.json"))
    require_one_device(config.parallel)

    datasets = {
        role: load_dataset_role(role, config.data.path,
                                config.data.slate_length,
                                binary_cache=config.data.binary_cache)
        for role in args.roles
    }
    n_features = [ds.n_features for ds, _ in datasets.values()]
    if not all_equal(n_features):
        raise ValueError(
            f"Last dimensions of datasets must match but got {n_features}")

    mdef = make_model(config.model, n_features[0])
    model = load_params(LTRModel(mdef, torch.Generator().manual_seed(42),
                                 device=dev), args.input_model_path)
    model.eval()
    logger.info("loaded model weights from %s", args.input_model_path)

    if config.click_model is None:
        raise ValueError("click_model must be defined in config for this run")
    click_model = instantiate_from_recursive_name_args(config.click_model)

    # a click model with a batch formulation runs on the device fused with
    # the ranking; data.device_cache also moves the features into the
    # device feature store, so batches carry [B, L] row ids
    device_cache = bool(config.data.device_cache)
    batch_size = config.data.batch_size
    device_click_fn = as_device_click_fn(click_model)
    if device_click_fn is not None:
        rank_click = (rank_and_click_dataset_indexed if device_cache
                      else rank_and_click_dataset)
        logger.info("click model runs on the device (fused with ranking%s)",
                    ", index-mode feed" if device_cache else "")
        clicked_slates = {
            role: rank_click(ds, slate_len, model, batch_size,
                             device_click_fn, include_empty=False)
            for role, (ds, slate_len) in datasets.items()
        }
    else:
        if device_cache:
            logger.info("index-mode ranking (device feature store)")
            ranked_slates = {
                role: rank_slates_dataset_indexed(ds, slate_len, model,
                                                  batch_size)
                for role, (ds, slate_len) in datasets.items()
            }
        else:
            ranked_slates = rank_slates(datasets, model, batch_size)
        clicked_slates = {
            role: click_on_slates(slates, click_model, include_empty=False)
            for role, slates in ranked_slates.items()
        }

    for role, slates in clicked_slates.items():
        write_to_libsvm_without_masked(
            os.path.join(paths.output_dir, f"{role}.txt"), *slates)

    summaries = {}
    for role, slates in clicked_slates.items():
        rows = list(metrics_on_clicked_slates(slates))
        summaries[role] = write_metrics_csvs(
            rows, os.path.join(paths.output_dir, f"{role}_metrics.csv"),
            os.path.join(paths.output_dir, f"{role}_metrics_mean.csv"))
        logger.info("%s metrics summary: %s", role, summaries[role])
    return summaries


if __name__ == "__main__":
    run()
