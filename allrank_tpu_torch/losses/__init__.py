"""The losses: functions ``loss(y_pred, y_true, **kwargs) -> scalar`` over
[B, L] score and label tensors, where padded documents carry
``y_true == PADDED_Y_VALUE`` and an optional ``slate_mask`` [B] marks real
slates (the JAX package's ``losses/__init__.py`` contract).

The registry holds the JAX package's thirteen names. A loss with
``needs_rng`` takes a ``generator`` keyword (a CPU ``torch.Generator``)
where the JAX function takes ``rng``.
"""

from allrank_tpu_torch.constants import DEFAULT_EPS, PADDED_Y_VALUE  # noqa: F401
from allrank_tpu_torch.losses.approxndcg import approxNDCGLoss  # noqa: F401
from allrank_tpu_torch.losses.bce import bce  # noqa: F401
from allrank_tpu_torch.losses.lambdaloss import lambdaLoss  # noqa: F401
from allrank_tpu_torch.losses.listmle import listMLE  # noqa: F401
from allrank_tpu_torch.losses.listnet import (  # noqa: F401
    binary_listNet,
    listNet,
)
from allrank_tpu_torch.losses.neuralndcg import (  # noqa: F401
    neuralNDCG,
    neuralNDCG_transposed,
)
from allrank_tpu_torch.losses.ordinal import ordinal, with_ordinals  # noqa: F401
from allrank_tpu_torch.losses.pointwise import pointwise_rmse  # noqa: F401
from allrank_tpu_torch.losses.ranknet import (  # noqa: F401
    rankNet,
    rankNet_weightByGTDiff,
    rankNet_weightByGTDiff_pow,
)

# config loss names -> (fn, needs_rng), as in the JAX package's registry
LOSSES = {
    "listNet": (listNet, False),
    "binary_listNet": (binary_listNet, False),
    "listMLE": (listMLE, True),
    "rankNet": (rankNet, False),
    "rankNet_weightByGTDiff": (rankNet_weightByGTDiff, False),
    "rankNet_weightByGTDiff_pow": (rankNet_weightByGTDiff_pow, False),
    "ordinal": (ordinal, False),
    "pointwise_rmse": (pointwise_rmse, False),
    "bce": (bce, False),
    "lambdaLoss": (lambdaLoss, False),
    "approxNDCGLoss": (approxNDCGLoss, False),
    "neuralNDCG": (neuralNDCG, True),
    "neuralNDCG_transposed": (neuralNDCG_transposed, True),
}


def get_loss(name: str):
    """Return (loss_fn, needs_rng) for a config loss name."""
    if name not in LOSSES:
        raise ValueError(
            f"Unknown loss '{name}'. Available: {sorted(LOSSES)}")
    return LOSSES[name]


def accumulation_weighting(name: str, args=None):
    """Micro-batch combination rule for gradient accumulation: returns
    ``(weight_fn, normalize)``, as the JAX package's
    ``accumulation_weighting``. The combined loss is
    ``sum_i(loss_i * w_i) / sum_i(w_i)`` when ``normalize`` (w_i from
    ``weight_fn(y_true_i, slate_mask_i)``, a float32 tensor) and the plain
    ``sum_i(loss_i)`` otherwise: lambdaLoss with reduction='sum' sums;
    ordinal weighs by valid documents, bce by slates with any valid
    document, every other loss by valid slates."""
    import torch

    args = args or {}

    def slates(y, slate_mask):
        return slate_mask.float().sum()

    def valid_docs(y, slate_mask):
        return ((y != PADDED_Y_VALUE) & slate_mask[:, None]).float().sum()

    def slates_with_valid(y, slate_mask):
        valid = (y != PADDED_Y_VALUE) & slate_mask[:, None]
        return valid.any(dim=-1).float().sum()

    if name == "lambdaLoss" and args.get("reduction", "sum") == "sum":
        return (lambda y, sm: torch.ones((), device=y.device)), False
    if name == "ordinal":
        return valid_docs, True
    if name == "bce":
        return slates_with_valid, True
    return slates, True
