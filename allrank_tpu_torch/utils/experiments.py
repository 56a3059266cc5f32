"""Experiment result dump and the expected-metrics regression gate (the
port's copy of the JAX package's ``utils/experiments.py``)."""

from __future__ import annotations

import json
import os
from typing import Any, Dict

from allrank_tpu_torch.utils.ltr_logging import get_logger

logger = get_logger()


def flatten(d: Dict[str, Any], prefix: str = "",
            sep: str = "/") -> Dict[str, Any]:
    """Path-flatten a nested dict: {"a": {"b": 1}} -> {"a/b": 1}."""
    out: Dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key, sep))
        else:
            out[key] = v
    return out


def _to_plain(value):
    if hasattr(value, "item"):
        return value.item()
    if isinstance(value, dict):
        return {k: _to_plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_to_plain(v) for v in value]
    return value


def dump_experiment_result(
    run_id: str, config_dict: Dict[str, Any], output_dir: str,
    result: Dict[str, Any],
) -> str:
    """Write flattened(config) + flattened(result) + run metadata to
    experiment_result.json; returns the path."""
    flattened = flatten(config_dict)
    flattened.update(flatten(_to_plain(result)))
    flattened["run_id"] = run_id
    flattened["dir"] = output_dir
    path = os.path.join(output_dir, "experiment_result.json")
    with open(path, "w") as f:
        json.dump(flattened, f, default=str)
        f.write("\n")
    return path


def assert_expected_metrics(
    result: Dict[str, Any], expected_metrics: Dict[str, Dict[str, float]]
) -> None:
    """Hard-assert every expected metric was met: the built-in regression
    gate."""
    if not expected_metrics:
        return
    for role, metrics in expected_metrics.items():
        for name, expected_value in metrics.items():
            actual_value = result[f"{role}_metrics"][name]
            msg = (
                f"{role} {name} got {actual_value}. "
                f"It was expected to be at least {expected_value}"
            )
            if actual_value < expected_value:
                logger.info(msg)
            assert actual_value >= expected_value, msg
