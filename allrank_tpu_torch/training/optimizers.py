"""Optimizer registry: config names -> ``torch.optim`` optimizers.

The reference dispatches optimizer names straight into ``torch.optim``, and
the JAX package maps the same names and arguments onto optax chains pinned
to torch's trajectories (its tests/training/test_optimizer_parity.py). Here
the names go to torch.optim itself, with the JAX package's spelling
(``lr``, ``betas``) and its default learning rates, which differ from
torch's for SGD.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable

import torch

# name -> the JAX package's default learning rate
OPTIMIZERS = {
    "Adam": 1e-3,
    "AdamW": 1e-3,
    "SGD": 1e-2,
    "RMSprop": 1e-2,
    "Adagrad": 1e-2,
    "Adadelta": 1.0,
    "NAdam": 2e-3,
    "RAdam": 1e-3,
}


def make_optimizer(name: str, args: Dict[str, Any],
                   params: Iterable[torch.nn.Parameter]
                   ) -> torch.optim.Optimizer:
    """The optimizer of a config ``{"name": ..., "args": {...}}`` entry over
    ``params``. Adam's ``amsgrad`` is ignored, as the JAX package ignores
    it (optax has none)."""
    if name not in OPTIMIZERS:
        raise ValueError(
            f"Unknown optimizer '{name}'. Available: {sorted(OPTIMIZERS)}")
    args = dict(args or {})
    if "learning_rate" in args:
        args["lr"] = args.pop("learning_rate")
    args.setdefault("lr", OPTIMIZERS[name])
    if "betas" in args:
        args["betas"] = tuple(args["betas"])
    if name == "Adam":
        args.pop("amsgrad", None)
    return getattr(torch.optim, name)(params, **args)


def set_learning_rate(optimizer: torch.optim.Optimizer,
                      learning_rate: float) -> None:
    """Sets the learning rate of every parameter group, between steps."""
    for group in optimizer.param_groups:
        group["lr"] = float(learning_rate)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])
