"""The parts of the experiment configuration that serving reads.

Same JSON schema as the JAX package's ``config.py`` (and the reference
allRank's): only ``model`` and ``data.slate_length`` are parsed here, every
other section of a training config is accepted and ignored.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
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


@dataclass
class Config:
    model: ModelConfig
    data: DataConfig

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
            data=DataConfig(slate_length=int(config["data"]["slate_length"])),
        )
