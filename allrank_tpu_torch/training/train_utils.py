"""The train step: forward with dropout, loss, backward, global-norm clip
and the optimizer update (the JAX package's ``training/train_utils.py:61``
``make_train_step``).

On CUDA every sublayer of the encoder runs its hand-written kernels in both
directions (autograd Functions in ``ops/``) and lambdaLoss its pair-chain
kernels; on the CPU the same step runs their plain versions. The step
queues its work on the device and returns device scalars, with no host
synchronisation of its own.

``scan_steps`` is a JAX dispatch device (several steps in one compiled
program) and has no counterpart here; a CUDA graph per step is later work.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from allrank_tpu_torch.constants import PADDED_Y_VALUE
from allrank_tpu_torch.models.factory import LTRModel, as_dtype


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax's
    ``global_norm``)."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def make_train_step(model: LTRModel, loss_fn: Callable,
                    loss_kwargs: Optional[Dict[str, Any]], needs_rng: bool,
                    optimizer: torch.optim.Optimizer,
                    gradient_clipping_norm: Optional[float],
                    compute_dtype="float32", accumulation_steps: int = 1,
                    accum_weighting=None,
                    generator: Optional[torch.Generator] = None):
    """Build ``step(x, y, indices, slate_mask=None) -> (loss, n_real)``.

    The batch is a slate batch as the JAX package's ``SlateBatch``: x
    [B, L, F], y [B, L] with ``PADDED_Y_VALUE`` at padded documents,
    indices [B, L] and slate_mask [B] (True at real slates; None: all),
    numpy arrays or tensors; it is moved to the model's device. One call is
    one optimizer step on ``optimizer`` (built over ``model.parameters()``).

    Dropout draws its seeds from ``generator``, a CPU ``torch.Generator``
    (default: seeded with 0): the same generator state gives the same step.
    With ``accumulation_steps = A > 1`` the batch runs as A sequential
    micro-batches whose gradients combine under ``accum_weighting``
    (``losses.accumulation_weighting(name, args)``; default valid-slate
    weighting) before the one step, as in the JAX package. With
    ``gradient_clipping_norm`` c the gradients are scaled by
    ``min(1, c / (global_norm + 1e-6))``.
    """
    dtype = as_dtype(compute_dtype)
    loss_kwargs = dict(loss_kwargs or {})
    a_steps = max(1, int(accumulation_steps or 1))
    if accum_weighting is None:
        weight_fn, normalize = (lambda y, sm: sm.float().sum()), True
    else:
        weight_fn, normalize = accum_weighting
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = [p for p in model.parameters() if p.requires_grad]
    dev = next(model.parameters()).device

    def loss_of(x, mask, indices, y, slate_mask):
        preds = model(x, mask, indices, compute_dtype=dtype, train=True,
                      generator=generator)
        kw = dict(loss_kwargs)
        if needs_rng:
            kw["generator"] = generator
        return loss_fn(preds, y, slate_mask=slate_mask, **kw)

    def step(x, y, indices, slate_mask=None):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        y = torch.as_tensor(y, dtype=torch.float32, device=dev)
        indices = torch.as_tensor(indices, device=dev).long()
        if slate_mask is None:
            slate_mask = torch.ones(y.shape[0], dtype=torch.bool, device=dev)
        slate_mask = torch.as_tensor(slate_mask, device=dev).bool()
        mask = y == PADDED_Y_VALUE
        optimizer.zero_grad(set_to_none=True)

        if a_steps == 1:
            loss = loss_of(x, mask, indices, y, slate_mask)
            loss.backward()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            loss = loss.detach()
        else:
            b = x.shape[0]
            if b % a_steps:
                raise ValueError(f"batch_size {b} not divisible by "
                                 f"accumulation_steps {a_steps}")
            size = b // a_steps
            grads = [torch.zeros_like(p) for p in params]
            loss = torch.zeros((), device=dev)
            w_sum = torch.zeros((), device=dev)
            for i in range(a_steps):
                part = slice(i * size, (i + 1) * size)
                for p in params:
                    p.grad = None
                micro = loss_of(x[part], mask[part], indices[part], y[part],
                                slate_mask[part])
                micro.backward()
                w = weight_fn(y[part], slate_mask[part])
                for acc, p in zip(grads, params):
                    if p.grad is not None:
                        acc.add_(p.grad * w)
                loss = loss + micro.detach() * w
                w_sum = w_sum + w
            if normalize:
                denom = torch.clamp(w_sum, min=1.0)
                loss = loss / denom
                grads = [g / denom for g in grads]

        if gradient_clipping_norm:
            scale = torch.clamp(
                gradient_clipping_norm / (global_norm(grads) + 1e-6), max=1.0)
            grads = [g * scale for g in grads]
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        return loss, slate_mask.float().sum()

    return step
