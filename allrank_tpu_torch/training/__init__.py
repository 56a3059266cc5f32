"""Training: the optimizer and scheduler registries, the train step and the
epoch loop."""

from allrank_tpu_torch.training.optimizers import (  # noqa: F401
    get_learning_rate,
    make_optimizer,
    set_learning_rate,
)
from allrank_tpu_torch.training.schedulers import make_scheduler  # noqa: F401
from allrank_tpu_torch.training.train_utils import (  # noqa: F401
    fit,
    make_train_step,
)
