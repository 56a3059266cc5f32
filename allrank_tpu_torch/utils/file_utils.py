"""Output path management (the JAX package's ``utils/file_utils.py``, local
paths only: ``gs://`` paths are not yet ported and raise)."""

from __future__ import annotations

import os
from dataclasses import dataclass
from urllib.parse import urlparse


def get_path_from_local_uri(uri) -> str:
    parsed = urlparse(uri)
    if parsed.scheme == "file":
        return parsed.netloc + parsed.path
    return uri


def is_gs_path(uri) -> bool:
    return urlparse(uri).scheme == "gs"


@dataclass
class PathsContainer:
    local_base_output_path: str
    base_output_path: str
    output_dir: str
    tensorboard_output_path: str
    config_path: str

    @classmethod
    def from_args(cls, job_dir: str, run_id: str,
                  config_path: str) -> "PathsContainer":
        base_output_path = get_path_from_local_uri(job_dir)
        if is_gs_path(base_output_path):
            raise NotImplementedError(
                "gs:// job directories are not yet ported to "
                "allrank_tpu_torch")
        output_dir = os.path.join(base_output_path, "results", run_id)
        tensorboard_output_path = os.path.join(
            base_output_path, "tb_evals", "single", run_id)
        return cls(base_output_path, base_output_path, output_dir,
                   tensorboard_output_path, config_path)


def create_output_dirs(output_path: str) -> None:
    for subdir in ["models", "evals", "predictions"]:
        os.makedirs(os.path.join(output_path, subdir), exist_ok=True)
