"""Shared helpers of the losses (the JAX package's ``losses/common.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from allrank_tpu_torch.constants import PADDED_Y_VALUE


def as_f32(*arrays):
    """Each argument as a float32 tensor (autograd flows through a tensor
    argument's cast)."""
    return tuple(a.float() if isinstance(a, torch.Tensor)
                 else torch.as_tensor(a, dtype=torch.float32) for a in arrays)


def padding_mask(y_true: torch.Tensor,
                 padded_value_indicator: int = PADDED_Y_VALUE) -> torch.Tensor:
    """True at padded document positions."""
    return y_true == padded_value_indicator


def resolve_slate_mask(y_true: torch.Tensor,
                       slate_mask: Optional[torch.Tensor],
                       padded_value_indicator: int = PADDED_Y_VALUE
                       ) -> torch.Tensor:
    """[B] float weights: 1.0 for real slates. With slate_mask=None all
    slates count."""
    del padded_value_indicator  # the signature is the JAX package's
    if slate_mask is None:
        return torch.ones(y_true.shape[0], dtype=torch.float32,
                          device=y_true.device)
    return torch.as_tensor(slate_mask, device=y_true.device).float()


def masked_mean_over_slates(per_slate: torch.Tensor,
                            slate_weights: torch.Tensor) -> torch.Tensor:
    """Mean over slates weighted by validity (the plain mean when all are
    valid)."""
    denom = torch.clamp(slate_weights.sum(), min=1.0)
    return (per_slate * slate_weights).sum() / denom


class _ClampedLog(torch.autograd.Function):
    """``max(log(max(p, 0)), -100)`` with the backward ``1 / max(p, 1e-12)``
    (the JAX package's ``clamped_log`` and its custom JVP)."""

    @staticmethod
    def forward(ctx, p):
        ctx.save_for_backward(p)
        return torch.clamp(torch.log(torch.clamp(p, min=0.0)), min=-100.0)

    @staticmethod
    def backward(ctx, grad):
        (p,) = ctx.saved_tensors
        return grad / torch.clamp(p, min=1e-12)


def clamped_log(p: torch.Tensor) -> torch.Tensor:
    """log with its output clamped to >= -100 (torch's BCELoss convention)
    and a bounded backward pass, d/dp = 1 / max(p, 1e-12): a plain clamp of
    the log would give 0 * inf = NaN gradients once a sigmoid head saturates
    to exactly 0 or 1."""
    return _ClampedLog.apply(p)


def bce_elementwise(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on probabilities with the -100 log clamp."""
    return -(t * clamped_log(p) + (1.0 - t) * clamped_log(1.0 - p))


def bce_with_logits(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Numerically stable BCE on logits:
    max(x, 0) - x z + log(1 + exp(-|x|)).

    At x = 0 exactly (tied scores) the JAX function differentiates
    ``maximum(x, 0)`` with the subgradient 1/2 and ``abs(x)`` with +1, where
    ``torch.clamp`` and ``torch.abs`` take 1 and 0; the two terms are
    written here so that autograd takes the JAX function's values, and tied
    scores get the gradient the JAX package gives them."""
    abs_x = torch.where(x >= 0, x, -x)  # d|x|/dx = +1 at 0
    relu_x = 0.5 * (x + x.abs())  # d max(x, 0)/dx = 1/2 at 0
    return relu_x - x * z + torch.log1p(torch.exp(-abs_x))
