"""The experiment configuration the port reads.

Same JSON schema as the JAX package's ``config.py`` (and the reference
allRank's). Parsed here: ``model``, ``data``, ``optimizer``, ``loss``,
``lr_scheduler``, ``training``, ``metrics``, ``val_metric``,
``expected_metrics``, ``detect_anomaly``, ``click_model`` and ``parallel``,
with the JAX package's field names and defaults; an unknown top-level key
raises ``TypeError``, as there. The click model is parsed and kept (the
click pipeline is not ported yet); a ``parallel`` layout of more than one
device is refused by the entry points (``utils.device.require_one_device``).
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import asdict, dataclass, field, fields
from typing import Any, Dict, List, Optional


class MetricConfigError(Exception):
    pass


@dataclass
class PositionalEncodingConfig:
    strategy: str
    max_indices: int


@dataclass
class TransformerConfig:
    N: int
    d_ff: int
    h: int
    positional_encoding: Optional[PositionalEncodingConfig]
    dropout: float


@dataclass
class FCConfig:
    sizes: List[int]
    input_norm: bool
    activation: Optional[str]
    dropout: Optional[float]


@dataclass
class PostModelConfig:
    d_output: int
    output_activation: Optional[str] = None


@dataclass
class ModelConfig:
    fc_model: Optional[FCConfig]
    transformer: Optional[TransformerConfig]
    post_model: PostModelConfig


@dataclass
class DataConfig:
    slate_length: int
    path: Optional[str] = None
    num_workers: int = 1
    batch_size: int = 64
    validation_ds_role: str = "vali"
    shuffle_seed: int = 42
    eval_buckets: int = 0
    binary_cache: bool = False
    device_cache: bool = False
    device_cache_dtype: str = "auto"
    device_cache_sharding: str = "replicated"


@dataclass
class TrainingConfig:
    epochs: int
    gradient_clipping_norm: Optional[float]
    early_stopping_patience: int = 0
    compute_dtype: str = "float32"
    checkpoint_every: Optional[int] = None
    checkpoint_backend: str = "npz"
    resume: bool = False
    init_from: Optional[str] = None
    profiler_trace_dir: Optional[str] = None
    metrics_on_train: bool = True
    scan_steps: int = 1
    accumulation_steps: int = 1


@dataclass
class NameArgsConfig:
    name: str
    args: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ParallelConfig:
    """The JAX package's mesh layout; the port runs on one device."""

    data: int = -1  # -1: every device the run has
    model: int = 1
    sequence: int = 1


@dataclass
class Config:
    model: ModelConfig
    data: DataConfig
    optimizer: Optional[NameArgsConfig] = None
    loss: Optional[NameArgsConfig] = None
    lr_scheduler: Optional[NameArgsConfig] = None
    training: Optional[TrainingConfig] = None
    metrics: Dict[str, List[int]] = field(default_factory=dict)
    val_metric: Optional[str] = None
    expected_metrics: Dict[str, Dict[str, float]] = field(
        default_factory=dict)
    detect_anomaly: bool = False
    click_model: Optional[NameArgsConfig] = None
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    @classmethod
    def from_json(cls, config_path: str) -> "Config":
        with open(config_path) as config_file:
            return cls.from_dict(json.load(config_file))

    @classmethod
    def from_dict(cls, config: Dict[str, Any]) -> "Config":
        unknown = sorted(set(config) - {f.name for f in fields(cls)})
        if unknown:
            raise TypeError(f"unknown config section(s) {unknown}")
        model = dict(config["model"])
        fc = model.get("fc_model")
        transformer = model.get("transformer")
        if transformer:
            transformer = dict(transformer)
            pe = transformer.get("positional_encoding")
            transformer["positional_encoding"] = (
                PositionalEncodingConfig(**pe) if pe else None
            )
            transformer = TransformerConfig(**transformer)
        else:
            transformer = None
        return cls(
            model=ModelConfig(
                fc_model=FCConfig(**fc) if fc else None,
                transformer=transformer,
                post_model=PostModelConfig(**model["post_model"]),
            ),
            data=DataConfig(**config["data"]),
            optimizer=_name_args(config.get("optimizer")),
            loss=_name_args(config.get("loss")),
            lr_scheduler=_name_args(config.get("lr_scheduler")),
            training=(TrainingConfig(**config["training"])
                      if config.get("training") else None),
            metrics=cls._parse_metrics(config.get("metrics") or []),
            val_metric=config.get("val_metric"),
            expected_metrics=config.get("expected_metrics") or {},
            detect_anomaly=bool(config.get("detect_anomaly", False)),
            click_model=_name_args(config.get("click_model")),
            parallel=ParallelConfig(**(config.get("parallel") or {})),
        )

    @staticmethod
    def _parse_metrics(metrics: List[str]) -> Dict[str, List[int]]:
        """Parse ["ndcg_5", "mrr_10"] into {"ndcg": [5], "mrr": [10]}."""
        metrics_dict: Dict[str, List[int]] = defaultdict(list)
        for metric_string in metrics:
            try:
                name, at = metric_string.split("_")
                metrics_dict[name].append(int(at))
            except (ValueError, TypeError):
                raise MetricConfigError(
                    f"Wrong metric format '{metric_string}'. Expected "
                    "<name>_<at> where name is a valid metric name and at "
                    "is an int")
        return dict(metrics_dict)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


def _name_args(section: Optional[Dict[str, Any]]
               ) -> Optional[NameArgsConfig]:
    return NameArgsConfig(**section) if section else None
