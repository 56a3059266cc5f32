"""Serving path: ``(x, lengths) -> scores`` and ``-> order`` over a model.

Padding comes from per-slate document counts (the natural serve-time
input; labels do not exist at serving time) and padded positions score
-inf, so they sort last under any ordering. As in the reference's inference
path, positional encodings see rank index 1 for every document (true ranks
are unknown at serve time). ``compute_dtype="bfloat16"`` runs the tower in
bf16; scores stay fp32. ``quantize="int8"`` or ``"int8_static"`` serves the
int8 tower of ``quant.py`` (the latter with ``act_scales`` from
``quant.calibrate_activations``).

The sharded scorer, ahead-of-time compilation and export of the JAX
package's serving module are not ported yet.
"""

from __future__ import annotations

import torch

from allrank_tpu_torch.models.factory import LTRModel, as_dtype
from allrank_tpu_torch.utils.device import resolve_device


def _mask_from_lengths(lengths: torch.Tensor, slate_length: int
                       ) -> torch.Tensor:
    positions = torch.arange(slate_length, device=lengths.device)[None, :]
    return positions >= lengths[:, None]


def _check_quantize(quantize, act_scales) -> None:
    if quantize not in ("int8", "int8_static"):
        raise ValueError(f"unknown quantize mode '{quantize}' "
                         "(supported: 'int8', 'int8_static')")
    if quantize == "int8_static" and act_scales is None:
        raise ValueError(
            "quantize='int8_static' needs act_scales from "
            "quant.calibrate_activations (run N representative batches "
            "through the fp32 tower first)")


def make_scorer(model: LTRModel, compute_dtype="float32", device=None,
                quantize=None, act_scales=None):
    """``(x [B, L, F], lengths [B]) -> scores [B, L]`` fp32 on ``device``
    (default: the GPU; the model is moved there). Inputs may be numpy
    arrays or tensors.

    ``quantize="int8"`` serves the int8 tower with dynamic activation
    scales, ``"int8_static"`` with the calibrated ``act_scales``; the
    weights are quantized once, here. On both, ``compute_dtype`` is the
    flow between the int8 layers (LayerNorms, residuals)."""
    dev = resolve_device(device)
    dtype = as_dtype(compute_dtype)
    model = model.to(dev).eval()
    if quantize is not None:
        _check_quantize(quantize, act_scales)
        from allrank_tpu_torch.quant import quantize_model

        model = quantize_model(
            model, act_scales if quantize == "int8_static" else None)

    def scorer(x, lengths) -> torch.Tensor:
        with torch.inference_mode():
            x = torch.as_tensor(x, dtype=torch.float32, device=dev)
            lengths = torch.as_tensor(lengths, device=dev).long()
            mask = _mask_from_lengths(lengths, x.shape[1])
            indices = torch.ones(x.shape[:2], dtype=torch.long, device=dev)
            scores = model.score(x, mask, indices, compute_dtype=dtype)
            return torch.where(mask, float("-inf"), scores.float())

    return scorer


def make_ranker(model: LTRModel, compute_dtype="float32", device=None,
                quantize=None, act_scales=None):
    """``(x, lengths) -> order [B, L]``: document indices in descending
    score order (a stable sort), padded positions last."""
    scorer = make_scorer(model, compute_dtype, device, quantize=quantize,
                         act_scales=act_scales)

    def ranker(x, lengths) -> torch.Tensor:
        with torch.inference_mode():
            return torch.argsort(scorer(x, lengths), dim=-1,
                                 descending=True, stable=True)

    return ranker
