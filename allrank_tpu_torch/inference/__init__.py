"""Inference: slate ranking on the model's device and clicked-slate
metrics (the JAX package's ``inference/``)."""

from allrank_tpu_torch.inference.inference_utils import (  # noqa: F401
    metrics_on_clicked_slates,
    rank_slates,
    rank_slates_dataset,
)
