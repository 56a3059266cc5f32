"""Train CLI (the JAX package's ``main.py``).

Usage::

    python -m allrank_tpu_torch.main --config-file-name config.json \
        --run-id my_run --job-dir /tmp/output

Pipeline: parse args -> load the JSON config -> load libsvm train and
validation slates -> build model, optimizer, loss and scheduler by name ->
``fit`` -> dump ``experiment_result.json`` -> hard-assert
``expected_metrics`` (the built-in regression gate). Runs on the GPU.
``data.binary_cache`` parses each role once into ``.npy`` files beside it;
``data.device_cache`` keeps each role's features in device memory (one
``DeviceFeatureStore`` for train, one for validation) and feeds the steps
row indices; ``data.num_workers`` threads assemble the batches. The device
mesh and the compilation cache of the JAX CLI have no counterpart here yet:
a ``parallel`` layout of more than one device and a multi-process launch
raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
import shutil
from argparse import ArgumentParser, Namespace
from pprint import pformat

import numpy as np
import torch

from allrank_tpu_torch.config import Config
from allrank_tpu_torch.data.batching import BucketedSlateBatcher, SlateBatcher
from allrank_tpu_torch.data.dataset import load_dataset
from allrank_tpu_torch.data.feature_store import (
    DeviceFeatureStore,
    resolve_store_dtype,
)
from allrank_tpu_torch.losses import accumulation_weighting, get_loss
from allrank_tpu_torch.models.factory import LTRModel, make_model
from allrank_tpu_torch.training import fit, make_optimizer, make_scheduler
from allrank_tpu_torch.training.checkpoint import load_params
from allrank_tpu_torch.utils.device import require_one_device, resolve_device
from allrank_tpu_torch.utils.experiments import (
    assert_expected_metrics,
    dump_experiment_result,
)
from allrank_tpu_torch.utils.file_utils import (
    PathsContainer,
    create_output_dirs,
)
from allrank_tpu_torch.utils.ltr_logging import init_logger
from allrank_tpu_torch.utils.tensorboard_utils import TensorboardSummaryWriter


def parse_args() -> Namespace:
    parser = ArgumentParser("allRank-tpu-torch")
    parser.add_argument("--job-dir", required=True,
                        help="Base output path for all experiments")
    parser.add_argument("--run-id", required=True,
                        help="Name of this run (subdirectory of job-dir)")
    parser.add_argument("--config-file-name", required=True,
                        help="Path to the experiment JSON config")
    return parser.parse_args()


def run(args: Namespace = None, device=None) -> dict:
    """Train as the config says; ``device=None`` is the GPU (an error when
    there is none), ``device="cpu"`` the plain versions on the CPU."""
    args = args or parse_args()
    dev = resolve_device(device)
    np.random.seed(42)

    paths = PathsContainer.from_args(args.job_dir, args.run_id,
                                     args.config_file_name)
    create_output_dirs(paths.output_dir)
    logger = init_logger(paths.output_dir)
    logger.info("created paths container %s", paths)

    config = Config.from_json(paths.config_path)
    logger.info("Config: %s", pformat(config))
    shutil.copy2(paths.config_path,
                 os.path.join(paths.output_dir, "used_config.json"))
    require_one_device(config.parallel)
    if config.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)

    train_ds, train_len, val_ds, val_len = load_dataset(
        config.data.path, config.data.slate_length,
        config.data.validation_ds_role,
        binary_cache=config.data.binary_cache)
    n_features = train_ds.n_features
    if n_features != val_ds.n_features:
        raise ValueError(
            f"train/val feature size mismatch: {n_features} and "
            f"{val_ds.n_features}")

    device_cache = bool(config.data.device_cache)
    train_store = val_store = None
    if device_cache:
        store_dtype = resolve_store_dtype(config.data.device_cache_dtype,
                                          config.training.compute_dtype)
        sharding = config.data.device_cache_sharding
        train_store = DeviceFeatureStore(train_ds, device=dev,
                                         dtype=store_dtype, sharding=sharding)
        val_store = DeviceFeatureStore(val_ds, device=dev, dtype=store_dtype,
                                       sharding=sharding)
        logger.info(
            "device feature store: train %s, val %s rows resident on %s "
            "(dtype %s, %s)", train_store.sentinel, val_store.sentinel, dev,
            store_dtype or "float32", train_store.sharding)

    batch_size = config.data.batch_size
    train_batcher = SlateBatcher(
        train_ds, train_len, batch_size, shuffle=True,
        seed=config.data.shuffle_seed, num_workers=config.data.num_workers,
        emit_row_indices=device_cache)
    if config.data.eval_buckets > 0:
        val_batcher = BucketedSlateBatcher(
            val_ds, batch_size, n_buckets=config.data.eval_buckets,
            num_workers=config.data.num_workers,
            emit_row_indices=device_cache)
        logger.info("bucketed eval shapes: %s",
                    [(length, len(idx))
                     for length, idx in val_batcher.buckets])
    else:
        val_batcher = SlateBatcher(
            val_ds, val_len, batch_size, shuffle=False,
            seed=config.data.shuffle_seed,
            num_workers=config.data.num_workers,
            emit_row_indices=device_cache)

    mdef = make_model(config.model, n_features)
    model = LTRModel(mdef, torch.Generator().manual_seed(42), device=dev)
    if config.training.init_from:
        load_params(model, config.training.init_from)
        logger.info("warm-started weights from %s", config.training.init_from)
    logger.info("Model definition: %s (%d params) on %s", mdef,
                sum(p.numel() for p in model.parameters()), dev)

    optimizer = make_optimizer(config.optimizer.name, config.optimizer.args,
                               model.parameters())
    base_lr = float(config.optimizer.args.get("lr", 1e-3))
    scheduler = make_scheduler(config.lr_scheduler.name,
                               config.lr_scheduler.args, base_lr)
    loss_fn, needs_rng = get_loss(config.loss.name)

    result = fit(
        epochs=config.training.epochs,
        model=model,
        loss_fn=loss_fn,
        loss_kwargs=config.loss.args,
        needs_rng=needs_rng,
        optimizer=optimizer,
        scheduler=scheduler,
        train_batcher=train_batcher,
        val_batcher=val_batcher,
        metrics=config.metrics,
        val_metric=config.val_metric,
        early_stopping_patience=config.training.early_stopping_patience,
        gradient_clipping_norm=config.training.gradient_clipping_norm,
        output_dir=paths.output_dir,
        tensorboard_summary_writer=TensorboardSummaryWriter(
            paths.tensorboard_output_path),
        compute_dtype=config.training.compute_dtype,
        checkpoint_every=config.training.checkpoint_every,
        checkpoint_backend=config.training.checkpoint_backend,
        resume=config.training.resume,
        profiler_trace_dir=config.training.profiler_trace_dir,
        metrics_on_train=config.training.metrics_on_train,
        scan_steps=config.training.scan_steps,
        accumulation_steps=config.training.accumulation_steps,
        accum_weighting=accumulation_weighting(config.loss.name,
                                               config.loss.args),
        train_feature_table=None if train_store is None else train_store.table,
        val_feature_table=None if val_store is None else val_store.table,
    )

    result_for_dump = {k: v for k, v in result.items() if k != "model"}
    dump_experiment_result(args.run_id, config.to_dict(), paths.output_dir,
                           result_for_dump)
    assert_expected_metrics(result_for_dump, config.expected_metrics)
    return result


if __name__ == "__main__":
    run()
