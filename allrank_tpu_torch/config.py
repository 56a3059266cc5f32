"""The experiment configuration the port reads.

Same JSON schema as the JAX package's ``config.py`` (and the reference
allRank's). Parsed here: ``model``, ``data``, ``optimizer``, ``loss``,
``lr_scheduler`` and ``training``, with the JAX package's field names and
defaults. The sections the port does not use yet (metrics, click models,
the mesh layout) are accepted and ignored.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


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
class Config:
    model: ModelConfig
    data: DataConfig
    optimizer: Optional[NameArgsConfig] = None
    loss: Optional[NameArgsConfig] = None
    lr_scheduler: Optional[NameArgsConfig] = None
    training: Optional[TrainingConfig] = None

    @classmethod
    def from_json(cls, config_path: str) -> "Config":
        with open(config_path) as config_file:
            return cls.from_dict(json.load(config_file))

    @classmethod
    def from_dict(cls, config: Dict[str, Any]) -> "Config":
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
        )


def _name_args(section: Optional[Dict[str, Any]]
               ) -> Optional[NameArgsConfig]:
    return NameArgsConfig(**section) if section else None
