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
