"""Offline evaluation CLI (the JAX package's ``evaluate.py``): the configured
metrics and loss of a trained checkpoint on any dataset roles, without
training::

    python -m allrank_tpu_torch.evaluate --job-dir /out --run-id eval1 \
        --config-file-name config.json --input-model-path model.npz \
        --roles vali,test [--quantize int8_static]

Per role: validation shapes (each role padded to its longest slate, or the
``data.eval_buckets`` bucketed shapes), the training run's evaluation step,
one ``evaluation_result.json`` with ``<role>/<metric>`` keys. If the
config's ``expected_metrics`` names an evaluated role (``val`` stands for
``data.validation_ds_role``), the hard gate of training applies.

``--quantize int8`` or ``int8_static`` evaluates through the int8 serving
tower of ``quant.py``, with the config's ``training.compute_dtype`` as the
flow between its int8 layers; ``int8_static`` first calibrates on
``--calibration-batches`` batches of ``--calibration-role`` and writes
``act_scales.json``, which ``serve_http --act-scales`` loads.
``data.device_cache: true`` feeds the evaluation from the device feature
store (``data/feature_store.py``); ``data.binary_cache: true`` loads each
role through its ``.npy`` cache (``data/dataset.py``). Runs on the GPU; a
``parallel`` layout of more than one device and a multi-process launch are
not yet ported.
"""

from __future__ import annotations

import json
import os
import shutil
from argparse import ArgumentParser, Namespace
from pprint import pformat

import numpy as np
import torch

from allrank_tpu_torch.config import Config
from allrank_tpu_torch.data.batching import (
    BucketedSlateBatcher,
    DevicePrefetcher,
    SlateBatcher,
)
from allrank_tpu_torch.data.dataset import load_dataset_role
from allrank_tpu_torch.data.feature_store import (
    DeviceFeatureStore,
    resolve_store_dtype,
)
from allrank_tpu_torch.losses import get_loss
from allrank_tpu_torch.models.factory import LTRModel, as_dtype, make_model
from allrank_tpu_torch.training.checkpoint import load_params
from allrank_tpu_torch.training.train_utils import (
    compute_metrics,
    make_eval_fns,
)
from allrank_tpu_torch.utils.args_utils import split_as_strings
from allrank_tpu_torch.utils.device import require_one_device, resolve_device
from allrank_tpu_torch.utils.experiments import assert_expected_metrics
from allrank_tpu_torch.utils.file_utils import (
    PathsContainer,
    create_output_dirs,
)
from allrank_tpu_torch.utils.ltr_logging import init_logger
from allrank_tpu_torch.utils.python_utils import all_equal


def parse_args(argv=None) -> Namespace:
    parser = ArgumentParser("allRank-tpu-torch evaluate")
    parser.add_argument("--job-dir", required=True,
                        help="Base output path for all experiments")
    parser.add_argument("--run-id", required=True,
                        help="Name of this evaluation run")
    parser.add_argument("--config-file-name", required=True,
                        help="Path of the json experiment config")
    parser.add_argument("--input-model-path", required=True,
                        help="Path to the .npz checkpoint to score")
    parser.add_argument("--roles", required=True, type=split_as_strings,
                        help="Comma-separated dataset roles to evaluate")
    parser.add_argument("--quantize", default=None,
                        choices=["int8", "int8_static"],
                        help="evaluate through the int8 serving tower "
                             "(quant.py); 'int8_static' calibrates first "
                             "and writes act_scales.json")
    parser.add_argument("--calibration-role", default="train",
                        help="dataset role the int8_static calibration "
                             "batches are drawn from")
    parser.add_argument("--calibration-batches", type=int, default=8,
                        help="number of batches for int8_static calibration")
    return parser.parse_args(argv)


def _quantized_forward(model, config, datasets, args, output_dir, logger):
    """The int8 tower's forward for ``make_eval_fns``, calibrated first
    (and ``act_scales.json`` written) in the static mode."""
    from allrank_tpu_torch.quant import (
        calibrate_activations,
        calibration_batches_from_dataset,
        quantize_model,
    )

    act_scales = None
    if args.quantize == "int8_static":
        role = args.calibration_role
        if role in datasets:
            calib_ds = datasets[role][0]
        else:
            calib_ds = load_dataset_role(
                role, config.data.path, config.data.slate_length,
                binary_cache=config.data.binary_cache)[0]
        batches = calibration_batches_from_dataset(
            calib_ds, config.data.slate_length, config.data.batch_size,
            args.calibration_batches)
        act_scales = calibrate_activations(model, batches)
        logger.info("calibrated %d activation sites on %d '%s' batches",
                    len(act_scales), len(batches), role)
        with open(os.path.join(output_dir, "act_scales.json"), "w") as f:
            json.dump(act_scales, f, indent=1)
    qmodel = quantize_model(model, act_scales)
    # the flow follows the config's compute dtype, so the gate measures the
    # tower that serves
    dtype = as_dtype(config.training.compute_dtype or "float32")
    logger.info("evaluating through the %s int8 tower (%s flow)",
                args.quantize, dtype)

    def forward(x, mask, indices):
        return qmodel(x, mask, indices, compute_dtype=dtype)

    return forward


def run(args: Namespace = None, device=None) -> dict:
    """Evaluate as the arguments say; returns ``{role: {metric: value}}``.
    ``device=None`` is the GPU (an error when there is none),
    ``device="cpu"`` the plain versions on the CPU."""
    args = args or parse_args()
    dev = resolve_device(device)
    np.random.seed(42)

    paths = PathsContainer.from_args(args.job_dir, args.run_id,
                                     args.config_file_name)
    create_output_dirs(paths.output_dir)
    logger = init_logger(paths.output_dir)

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
    logger.info("loaded model weights from %s", args.input_model_path)

    quantize = args.quantize
    forward_fn = None
    if quantize in ("int8", "int8_static"):
        forward_fn = _quantized_forward(model, config, datasets, args,
                                        paths.output_dir, logger)
    elif quantize is not None:
        raise ValueError(f"unknown quantize mode '{quantize}'")

    loss_fn, needs_rng = get_loss(config.loss.name)
    eval_step = make_eval_fns(model, loss_fn, config.loss.args, needs_rng,
                              config.metrics, config.training.compute_dtype,
                              forward_fn=forward_fn)
    generator = torch.Generator().manual_seed(42)
    batch_size = config.data.batch_size

    device_cache = bool(config.data.device_cache)
    results = {}
    for role, (ds, slate_len) in datasets.items():
        table = None
        if device_cache:
            table = DeviceFeatureStore(
                ds, device=dev,
                dtype=resolve_store_dtype(config.data.device_cache_dtype,
                                          config.training.compute_dtype),
                sharding=config.data.device_cache_sharding).table
        if config.data.eval_buckets > 0:
            batcher = BucketedSlateBatcher(
                ds, batch_size, n_buckets=config.data.eval_buckets,
                emit_row_indices=device_cache)
        else:
            batcher = SlateBatcher(ds, slate_len, batch_size, shuffle=False,
                                   emit_row_indices=device_cache)
        metrics, loss = compute_metrics(
            eval_step, DevicePrefetcher(batcher, device=dev), generator,
            table=table)
        metrics["loss"] = loss
        results[role] = metrics
        logger.info("%s: %s", role,
                    {k: round(v, 6) for k, v in metrics.items()})

    flat = {f"{role}/{k}": v for role, m in results.items()
            for k, v in m.items()}
    out_path = os.path.join(paths.output_dir, "evaluation_result.json")
    with open(out_path, "w") as f:
        json.dump(flat, f, indent=1)
    logger.info("wrote %s", out_path)

    # the training gate keys validation expectations as "val"; offline that
    # alias means the configured validation_ds_role
    alias = {"val": config.data.validation_ds_role}
    gated_roles, unmatched = {}, []
    for r, v in (config.expected_metrics or {}).items():
        role = alias.get(r, r)
        if role in results:
            gated_roles[role] = v
        else:
            unmatched.append(r)
    if unmatched:
        logger.warning(
            "expected_metrics entries %s match no evaluated role %s — "
            "gate not applied to them", unmatched, sorted(results))
    if gated_roles:
        assert_expected_metrics(
            {f"{role}_metrics": m for role, m in results.items()},
            gated_roles)
        logger.info("expected_metrics gate passed for roles %s",
                    sorted(gated_roles))
    return results


if __name__ == "__main__":
    run()
