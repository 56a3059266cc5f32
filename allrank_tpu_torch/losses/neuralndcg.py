"""NeuralNDCG losses (the JAX package's ``losses/neuralndcg.py``; paper:
arXiv 2102.07831).

Differentiable NDCG through the NeuralSort relaxation: an approximate
permutation matrix, Sinkhorn-scaled to doubly stochastic, soft-sorts the
gains (or, in the transposed variant, spreads the discounts over the
original positions). The stochastic variant draws its Gumbel perturbations
from an explicit ``generator``.

Dispatch, as in the JAX package: on CUDA with L <= 512 the fused kernel of
``ops/neuralsort.py``, which never materialises [L, L]; on CUDA with
512 < L <= 768 the materialised chain through ``sinkhorn_scaling``, which
there runs the Sinkhorn kernel of ``ops/sinkhorn.py``; above 768, and on the
CPU, the plain chain with the tolerance freeze. 512 and 768 are the JAX
kernels' own caps, kept as the port's envelope; any other crossover is a
later measurement on the H100.
"""

from __future__ import annotations

from typing import Optional

import torch

from allrank_tpu_torch.constants import DEFAULT_EPS, PADDED_Y_VALUE
from allrank_tpu_torch.losses.common import as_f32, padding_mask
from allrank_tpu_torch.metrics import (
    dcg,
    discounts_on,
    identity_gain,
    pow2_gain,
)
from allrank_tpu_torch.ops import neuralsort
from allrank_tpu_torch.ops.soft_sort import (
    deterministic_neural_sort,
    perturbed_scores,
    sinkhorn_scaling,
    stochastic_neural_sort,
)


def soft_sort_available(y_pred: torch.Tensor, slate_length: int) -> bool:
    """True when the fused soft-sort kernel takes this input."""
    return (y_pred.device.type == "cuda"
            and slate_length <= neuralsort.MAX_FUSED_LENGTH)


def _p_hat(y_pred, mask, temperature, stochastic, n_samples, beta,
           log_scores, generator):
    if stochastic:
        return stochastic_neural_sort(
            y_pred, n_samples=n_samples, tau=temperature, mask=mask,
            generator=generator, beta=beta, log_scores=log_scores)
    return deterministic_neural_sort(y_pred, tau=temperature, mask=mask)[None]


def _sinkhorn_over_samples(p_hat, mask, tol=1e-6, max_iter=50):
    s, b, L, _ = p_hat.shape
    flat = sinkhorn_scaling(p_hat.reshape(s * b, L, L), mask.repeat(s, 1),
                            tol=tol, max_iter=max_iter)
    return flat.reshape(s, b, L, L)


def _flat_scores(y_pred, mask, stochastic, n_samples, beta, log_scores,
                 generator):
    """Scores and mask flattened sample-major: ([S*B, L], [S*B, L], S)."""
    if stochastic:
        scores = perturbed_scores(y_pred, n_samples, generator, beta,
                                  log_scores)
        return scores, mask.repeat(n_samples, 1), n_samples
    return y_pred, mask, 1


def _mean_over_valid(ndcg_val, idcg, slate_mask):
    """-mean over the slates with IDCG != 0 (and, with ``slate_mask``, the
    real ones) and over the samples; 0 when there is none."""
    idcg_valid = idcg != 0.0
    if slate_mask is not None:
        idcg_valid = idcg_valid & torch.as_tensor(
            slate_mask, device=idcg.device).bool()
    valid_f = idcg_valid.float()
    ndcg_val = ndcg_val * valid_f[None, :]
    denom = valid_f.sum() * ndcg_val.shape[0]
    mean_ndcg = torch.where(denom == 0.0, 0.0,
                            ndcg_val.sum() / torch.clamp(denom, min=1.0))
    return -mean_ndcg


def _check_generator(stochastic, generator):
    if stochastic and generator is None:
        raise ValueError("stochastic NeuralNDCG requires a generator")


def neuralNDCG(y_pred, y_true, padded_value_indicator: int = PADDED_Y_VALUE,
               temperature: float = 1.0, powered_relevancies: bool = True,
               k: Optional[int] = None, stochastic: bool = False,
               n_samples: int = 32, beta: float = 0.1,
               log_scores: bool = True,
               generator: Optional[torch.Generator] = None,
               slate_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-mean NeuralNDCG@k: soft-sorted discounted gains over IDCG. Slates
    with IDCG == 0 (and batch-padding slates) are left out of the mean."""
    _check_generator(stochastic, generator)
    y_pred, y_true = as_f32(y_pred, y_true)
    slate_length = y_true.shape[1]
    k_eff = slate_length if k is None else min(int(k), slate_length)
    mask = padding_mask(y_true, padded_value_indicator)
    gain_fn = pow2_gain if powered_relevancies else identity_gain
    gains = gain_fn(torch.where(mask, 0.0, y_true))

    if soft_sort_available(y_pred, slate_length):
        scores, mask_t, s_dim = _flat_scores(
            y_pred, mask, stochastic, n_samples, beta, log_scores, generator)
        ground_truth = neuralsort.fused_soft_sort_contract(
            scores, mask_t, gains.repeat(s_dim, 1), tau=temperature
        ).reshape(s_dim, -1, slate_length)
    else:
        p_hat = _p_hat(y_pred, mask, temperature, stochastic, n_samples,
                       beta, log_scores, generator)
        p_hat = _sinkhorn_over_samples(p_hat, mask)
        pair_pad = mask[:, :, None] | mask[:, None, :]
        p_hat = torch.where(pair_pad[None], 0.0, p_hat)
        # [S, B, L]: soft-sorted gains
        ground_truth = torch.einsum("sbij,bj->sbi", p_hat, gains)
    discounted_gains = ground_truth * discounts_on(slate_length,
                                                   y_pred.device)
    idcg = dcg(y_true, y_true, ats=[k_eff], gain_function=gain_fn)[:, 0]
    ndcg_val = discounted_gains[:, :, :k_eff].sum(dim=-1) / (
        idcg + DEFAULT_EPS)
    return _mean_over_valid(ndcg_val, idcg, slate_mask)


def neuralNDCG_transposed(y_pred, y_true,
                          padded_value_indicator: int = PADDED_Y_VALUE,
                          temperature: float = 1.0,
                          powered_relevancies: bool = True,
                          k: Optional[int] = None, stochastic: bool = False,
                          n_samples: int = 32, beta: float = 0.1,
                          log_scores: bool = True, max_iter: int = 50,
                          tol: float = 1e-6,
                          generator: Optional[torch.Generator] = None,
                          slate_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Transposed NeuralNDCG: P_hat^T spreads the truncated discount vector
    over the original positions ("expected discounts")."""
    _check_generator(stochastic, generator)
    y_pred, y_true = as_f32(y_pred, y_true)
    slate_length = y_true.shape[1]
    k_eff = slate_length if k is None else min(int(k), slate_length)
    mask = padding_mask(y_true, padded_value_indicator)
    discounts = discounts_on(slate_length, y_pred.device)
    discounts = torch.where(
        torch.arange(slate_length, device=y_pred.device) >= k_eff, 0.0,
        discounts)

    if soft_sort_available(y_pred, slate_length):
        scores, mask_t, s_dim = _flat_scores(
            y_pred, mask, stochastic, n_samples, beta, log_scores, generator)
        expected_discounts = neuralsort.fused_soft_sort_contract(
            scores, mask_t, discounts[None, :].expand(scores.shape),
            tau=temperature, max_iter=max_iter, transpose=True,
        ).reshape(s_dim, -1, slate_length)
    else:
        p_hat = _p_hat(y_pred, mask, temperature, stochastic, n_samples,
                       beta, log_scores, generator)
        p_hat = _sinkhorn_over_samples(p_hat, mask, tol=tol,
                                       max_iter=max_iter)
        # expected discount at original position j: sum_i P_hat[i, j] d_i
        expected_discounts = torch.einsum("sbij,i->sbj", p_hat, discounts)

    gain_fn = pow2_gain if powered_relevancies else identity_gain
    gains = gain_fn(torch.where(mask, 0.0, y_true))
    discounted_gains = gains[None, :, :] * expected_discounts
    # the reference takes the powered-gain IDCG in both branches; kept
    idcg = dcg(y_true, y_true, ats=[k_eff], gain_function=pow2_gain)[:, 0]
    ndcg_val = discounted_gains.sum(dim=2) / (idcg + DEFAULT_EPS)
    return _mean_over_valid(ndcg_val, idcg, slate_mask)
