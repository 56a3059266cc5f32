"""Early stopping on the validation metric (the port's copy of the JAX
package's ``training/early_stop.py``)."""

from __future__ import annotations


class EarlyStop:
    """Tracks the best (higher-is-better) validation metric; signals stop when
    no improvement for more than ``patience`` epochs. ``patience <= 0``
    disables stopping (the reference's configs use patience == epochs for
    that)."""

    def __init__(self, patience: int):
        self.patience = patience
        self.best_value = 0.0
        self.best_epoch = 0

    def step(self, current_value: float, current_epoch: int) -> None:
        if current_value > self.best_value:
            self.best_value = current_value
            self.best_epoch = current_epoch

    def stop_training(self, epoch: int) -> bool:
        return self.patience > 0 and epoch - self.best_epoch > self.patience
