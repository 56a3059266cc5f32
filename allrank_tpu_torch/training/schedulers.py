"""LR schedulers: host-side, epoch-granular schedules under torch's names and
arguments (the port's copy of the JAX package's ``training/schedulers.py``).

Plain Python objects: each ``step()`` returns the learning rate of the next
epoch, which the loop writes into the optimizer with ``set_learning_rate``;
plateau schedulers receive the validation metric.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence


class LRScheduler:
    """Base: lr(epoch) schedules. ``step()`` advances one epoch and returns
    the new LR (mirrors torch semantics where step() after epoch e sets the
    LR used during epoch e+1)."""

    needs_metric = False

    def __init__(self, base_lr: float):
        self.base_lr = float(base_lr)
        self.last_epoch = 0
        self.current_lr = self._lr_at(0)

    def _lr_at(self, epoch: int) -> float:
        raise NotImplementedError

    def step(self, metric=None) -> float:
        del metric
        self.last_epoch += 1
        self.current_lr = self._lr_at(self.last_epoch)
        return self.current_lr


class StepLR(LRScheduler):
    def __init__(self, base_lr: float, step_size: int, gamma: float = 0.1):
        self.step_size = int(step_size)
        self.gamma = float(gamma)
        super().__init__(base_lr)

    def _lr_at(self, epoch: int) -> float:
        return self.base_lr * self.gamma ** (epoch // self.step_size)


class MultiStepLR(LRScheduler):
    def __init__(self, base_lr: float, milestones: Sequence[int],
                 gamma: float = 0.1):
        self.milestones = sorted(int(m) for m in milestones)
        self.gamma = float(gamma)
        super().__init__(base_lr)

    def _lr_at(self, epoch: int) -> float:
        passed = sum(1 for m in self.milestones if m <= epoch)
        return self.base_lr * self.gamma**passed


class ExponentialLR(LRScheduler):
    def __init__(self, base_lr: float, gamma: float):
        self.gamma = float(gamma)
        super().__init__(base_lr)

    def _lr_at(self, epoch: int) -> float:
        return self.base_lr * self.gamma**epoch


class ConstantLR(LRScheduler):
    def __init__(self, base_lr: float, factor: float = 1.0 / 3,
                 total_iters: int = 5):
        self.factor = float(factor)
        self.total_iters = int(total_iters)
        super().__init__(base_lr)

    def _lr_at(self, epoch: int) -> float:
        return self.base_lr * (
            self.factor if epoch < self.total_iters else 1.0)


class CosineAnnealingLR(LRScheduler):
    def __init__(self, base_lr: float, T_max: int, eta_min: float = 0.0):
        self.T_max = int(T_max)
        self.eta_min = float(eta_min)
        super().__init__(base_lr)

    def _lr_at(self, epoch: int) -> float:
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * epoch / self.T_max)
        ) / 2


class LinearLR(LRScheduler):
    """torch.optim.lr_scheduler.LinearLR: linearly interpolate the factor
    from ``start_factor`` to ``end_factor`` over ``total_iters`` epochs."""

    def __init__(self, base_lr: float, start_factor: float = 1.0 / 3,
                 end_factor: float = 1.0, total_iters: int = 5):
        self.start_factor = float(start_factor)
        self.end_factor = float(end_factor)
        self.total_iters = int(total_iters)
        super().__init__(base_lr)

    def _lr_at(self, epoch: int) -> float:
        frac = min(epoch, self.total_iters) / self.total_iters
        return self.base_lr * (
            self.start_factor + (self.end_factor - self.start_factor) * frac
        )


class CosineAnnealingWarmRestarts(LRScheduler):
    """torch.optim.lr_scheduler.CosineAnnealingWarmRestarts (closed form):
    cosine anneal over a window of ``T_0`` epochs, restarting with the
    window growing by ``T_mult`` each restart."""

    def __init__(self, base_lr: float, T_0: int, T_mult: int = 1,
                 eta_min: float = 0.0):
        if T_0 <= 0:
            raise ValueError("T_0 must be positive")
        if T_mult < 1:
            raise ValueError("T_mult must be >= 1")
        self.T_0 = int(T_0)
        self.T_mult = int(T_mult)
        self.eta_min = float(eta_min)
        super().__init__(base_lr)

    def _lr_at(self, epoch: int) -> float:
        if self.T_mult == 1:
            t_cur = epoch % self.T_0
            t_i = self.T_0
        else:
            n = int(math.log(epoch / self.T_0 * (self.T_mult - 1) + 1,
                             self.T_mult))

            # float-log truncation guard: at exact restart boundaries the log
            # can land just below an integer (e.g. T_0=1, T_mult=3, epoch=121
            # -> log = 4.999...; int() gives 4 and the lr collapses to
            # eta_min instead of restarting at base_lr). Repair n with exact
            # integer arithmetic: gsum(n) <= epoch < gsum(n + 1).
            def gsum(k: int) -> int:
                return self.T_0 * (self.T_mult**k - 1) // (self.T_mult - 1)

            while n > 0 and gsum(n) > epoch:
                n -= 1
            while gsum(n + 1) <= epoch:
                n += 1
            t_cur = epoch - gsum(n)
            t_i = self.T_0 * self.T_mult**n
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * t_cur / t_i)
        ) / 2


class LambdaLR(LRScheduler):
    """torch.optim.lr_scheduler.LambdaLR with a JSON-friendly twist: since
    configs can't carry Python callables, ``lr_lambda`` may be a string
    expression in ``epoch`` (evaluated with ``math`` available and no other
    globals), e.g. ``"0.95 ** epoch"``. A real callable is accepted too for
    programmatic use."""

    def __init__(self, base_lr: float, lr_lambda):
        if isinstance(lr_lambda, str):
            expr = compile(lr_lambda, "<lr_lambda>", "eval")

            def fn(epoch: int) -> float:
                return float(eval(expr, {"__builtins__": {}, "math": math,
                                         "min": min, "max": max},
                                  {"epoch": epoch}))

            self.lr_lambda = fn
        elif callable(lr_lambda):
            self.lr_lambda = lr_lambda
        else:
            raise ValueError(
                "lr_lambda must be a string expression or callable")
        super().__init__(base_lr)

    def _lr_at(self, epoch: int) -> float:
        return self.base_lr * float(self.lr_lambda(epoch))


class ReduceLROnPlateau(LRScheduler):
    """Multiply LR by ``factor`` after ``patience`` epochs without metric
    improvement. ``mode="max"`` for NDCG-style metrics."""

    needs_metric = True

    def __init__(
        self,
        base_lr: float,
        mode: str = "min",
        factor: float = 0.1,
        patience: int = 10,
        threshold: float = 1e-4,
        threshold_mode: str = "rel",
        cooldown: int = 0,
        min_lr: float = 0.0,
    ):
        self.mode = mode
        self.factor = float(factor)
        self.patience = int(patience)
        self.threshold = float(threshold)
        self.threshold_mode = threshold_mode
        self.cooldown = int(cooldown)
        self.min_lr = float(min_lr)
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad_epochs = 0
        self.cooldown_counter = 0
        super().__init__(base_lr)

    def _lr_at(self, epoch: int) -> float:
        return self.base_lr

    def _is_better(self, current: float) -> bool:
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return current < self.best * (1.0 - self.threshold)
            return current < self.best - self.threshold
        if self.threshold_mode == "rel":
            return current > self.best * (1.0 + self.threshold)
        return current > self.best + self.threshold

    def step(self, metric=None) -> float:
        if metric is None:
            raise ValueError(
                "ReduceLROnPlateau.step requires the tracked metric")
        current = float(metric)
        self.last_epoch += 1
        if self._is_better(current):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.current_lr = max(self.current_lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.current_lr


SCHEDULERS = {
    "StepLR": StepLR,
    "MultiStepLR": MultiStepLR,
    "ExponentialLR": ExponentialLR,
    "ConstantLR": ConstantLR,
    "CosineAnnealingLR": CosineAnnealingLR,
    "CosineAnnealingWarmRestarts": CosineAnnealingWarmRestarts,
    "LinearLR": LinearLR,
    "LambdaLR": LambdaLR,
    "ReduceLROnPlateau": ReduceLROnPlateau,
}


def make_scheduler(name: str, args: Dict[str, Any],
                   base_lr: float) -> LRScheduler:
    if name not in SCHEDULERS:
        raise ValueError(f"Unknown lr_scheduler '{name}'. Available: "
                         f"{sorted(SCHEDULERS)}")
    return SCHEDULERS[name](base_lr, **(args or {}))
