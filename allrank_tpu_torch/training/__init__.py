"""Training: the optimizer registry and the train step."""

from allrank_tpu_torch.training.optimizers import (  # noqa: F401
    get_learning_rate,
    make_optimizer,
    set_learning_rate,
)
from allrank_tpu_torch.training.train_utils import make_train_step  # noqa: F401
