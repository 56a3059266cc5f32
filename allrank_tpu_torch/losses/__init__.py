"""The losses: functions ``loss(y_pred, y_true, **kwargs) -> scalar`` over
[B, L] score and label tensors, where padded documents carry
``y_true == PADDED_Y_VALUE`` and an optional ``slate_mask`` [B] marks real
slates (the JAX package's ``losses/__init__.py`` contract).

Only lambdaLoss is ported so far; the rest of the JAX package's loss zoo
comes with a later slice of the port, and ``get_loss`` names those losses
as not yet ported.
"""

from allrank_tpu_torch.constants import DEFAULT_EPS, PADDED_Y_VALUE  # noqa: F401
from allrank_tpu_torch.losses.lambdaloss import lambdaLoss  # noqa: F401

# config loss names -> (fn, needs_rng), as in the JAX package's registry
LOSSES = {
    "lambdaLoss": (lambdaLoss, False),
}
NOT_YET_PORTED = ("listNet", "binary_listNet", "listMLE", "rankNet",
                  "rankNet_weightByGTDiff", "rankNet_weightByGTDiff_pow",
                  "ordinal", "pointwise_rmse", "bce", "approxNDCGLoss",
                  "neuralNDCG", "neuralNDCG_transposed")


def get_loss(name: str):
    """Return (loss_fn, needs_rng) for a config loss name."""
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"loss '{name}' is not yet ported to allrank_tpu_torch (ported: "
            f"{sorted(LOSSES)})")
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
