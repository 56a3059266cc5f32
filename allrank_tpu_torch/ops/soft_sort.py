"""Differentiable sorting primitives: the NeuralSort relaxation and Sinkhorn
scaling (the single-device part of the JAX package's ``ops/soft_sort.py``).

* ``sinkhorn_scaling`` carries the iteration in diagonal-scaling form (two
  [N, M] vectors, one matvec per half-step). On a CUDA tensor with
  M <= 768 it runs the fixed-trip kernel of ``ops/sinkhorn.py``; elsewhere
  the plain chain below, whose updates freeze once the batch-global
  tolerance is met (the reference's early ``break``, kept differentiable).
* ``deterministic_neural_sort`` / ``stochastic_neural_sort``: the relaxed
  permutation matrices [N, L, L]. Randomness comes from an explicit
  ``torch.Generator``.

The mesh and sequence-parallel paths of the JAX module are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from allrank_tpu_torch.constants import DEFAULT_EPS
from allrank_tpu_torch.ops import sinkhorn
from allrank_tpu_torch.ops.sinkhorn import SCALING_CAP


def sinkhorn_scaling(mat: torch.Tensor, mask: Optional[torch.Tensor] = None,
                     tol: float = 1e-6, max_iter: int = 50,
                     backend: Optional[str] = None) -> torch.Tensor:
    """Row/column renormalisation to an (approximately) doubly stochastic
    matrix. mat: [N, M, M]; mask: optional [N, M], True = padded.

    Padded rows and columns are zeroed and the fully padded diagonal block
    set to 1 before scaling, and re-zeroed after; columns are normalised
    first, then rows. ``backend``: ``"kernel"`` forces the fixed-trip
    kernel path (its plain version on the CPU), ``"plain"`` the freezing
    chain; None picks the kernel for CUDA tensors inside its envelope. The
    two differ only after convergence, where further iterations move the
    sums by less than ``tol``.
    """
    if backend not in (None, "kernel", "plain"):
        raise ValueError(f"unknown backend {backend!r}")
    if mask is not None:
        either = mask[:, None, :] | mask[:, :, None]
        both = mask[:, None, :] & mask[:, :, None]
        mat = torch.where(either, 0.0, mat)
        mat = torch.where(both, 1.0, mat)

    if backend == "kernel" or (
            backend is None and mat.device.type == "cuda"
            and mat.shape[-1] <= sinkhorn.MAX_FUSED_LENGTH):
        mat = sinkhorn.sinkhorn_core_fused(mat, max_iter)
        if mask is not None:
            mat = torch.where(either, 0.0, mat)
        return mat

    m0 = mat
    a = torch.ones(mat.shape[:2], dtype=mat.dtype, device=mat.device)
    b = torch.ones_like(a)
    done = torch.zeros((), dtype=torch.bool, device=mat.device)
    row_resid = torch.full((), float("inf"), dtype=mat.dtype,
                           device=mat.device)
    for _ in range(max_iter):
        col = b * torch.einsum("nij,ni->nj", m0, a)
        # convergence of the previous full iteration: its row sums are 1 up
        # to the eps clamp (row_resid), its column sums are ``col``
        resid = torch.maximum((col - 1.0).abs().max(), row_resid)
        done = done | (resid < tol)
        # an exactly zero column or row can never be normalised: its
        # scaling freezes instead of growing by 1/eps per iteration
        b = torch.where(done | (col == 0.0), b, torch.clamp(
            b / torch.clamp(col, min=DEFAULT_EPS), max=SCALING_CAP))
        row = a * torch.einsum("nij,nj->ni", m0, b)
        a = torch.where(done | (row == 0.0), a, torch.clamp(
            a / torch.clamp(row, min=DEFAULT_EPS), max=SCALING_CAP))
        row_resid = torch.where(
            done, row_resid,
            (row / torch.clamp(row, min=DEFAULT_EPS) - 1.0).abs().max())
    mat = a[:, :, None] * m0 * b[:, None, :]
    if mask is not None:
        mat = torch.where(either, 0.0, mat)
    return mat


def deterministic_neural_sort(s: torch.Tensor, tau: float,
                              mask: torch.Tensor) -> torch.Tensor:
    """NeuralSort relaxation (ICLR 2019) with padding support. s: [N, L]
    scores; mask: [N, L], True at padded positions. Returns [N, L, L]: row
    i approximates the one-hot of the i-th largest element."""
    n = s.shape[1]
    s = torch.where(mask, -1e8, s)
    a_s = (s[:, :, None] - s[:, None, :]).abs()
    pair_pad = mask[:, :, None] | mask[:, None, :]
    a_s = torch.where(pair_pad, 0.0, a_s)
    row_sums = a_s.sum(dim=2)
    valid_n = (n - mask.sum(dim=1)).float()
    j = torch.arange(1, n + 1, dtype=torch.float32, device=s.device)
    scaling = torch.where(j[None, :] <= valid_n[:, None],
                          valid_n[:, None] + 1.0 - 2.0 * j[None, :], 0.0)
    s_zeroed = torch.where(mask, 0.0, s)
    # P_max[i, j] = scaling_i * s_j - rowsum_j
    p_max = scaling[:, :, None] * s_zeroed[:, None, :] - row_sums[:, None, :]
    p_max = torch.where(pair_pad, float("-inf"), p_max)
    both_pad = mask[:, :, None] & mask[:, None, :]
    p_max = torch.where(both_pad, 1.0, p_max)
    return torch.softmax(p_max / tau, dim=-1)


def sample_gumbel(generator: torch.Generator, shape, eps: float = 1e-10,
                  device=None) -> torch.Tensor:
    """Gumbel(0, 1) samples by the inverse CDF of uniform draws from
    ``generator`` (drawn on the generator's device, then moved)."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    if device is not None:
        u = u.to(device)
    return -torch.log(-torch.log(u + eps) + eps)


def perturbed_scores(s: torch.Tensor, n_samples: int,
                     generator: torch.Generator, beta: float = 1.0,
                     log_scores: bool = True,
                     eps: float = 1e-10) -> torch.Tensor:
    """Gumbel-perturbed score samples, flattened sample-major: [S*N, L]."""
    batch, n = s.shape
    s_positive = s + s.min().abs()
    if log_scores:
        s_positive = torch.log(s_positive + eps)
    gumbel = beta * sample_gumbel(generator, (n_samples, batch, n),
                                  device=s.device)
    return (s_positive[None, :, :] + gumbel).reshape(n_samples * batch, n)


def stochastic_neural_sort(s: torch.Tensor, n_samples: int, tau: float,
                           mask: torch.Tensor, generator: torch.Generator,
                           beta: float = 1.0, log_scores: bool = True,
                           eps: float = 1e-10) -> torch.Tensor:
    """Gumbel-perturbed NeuralSort. s: [N, L]; returns [n_samples, N, L, L],
    the masks tiled sample-major to match the data."""
    batch, n = s.shape
    s_perturb = perturbed_scores(s, n_samples, generator, beta, log_scores,
                                 eps)
    p_hat = deterministic_neural_sort(s_perturb, tau,
                                      mask.repeat(n_samples, 1))
    return p_hat.reshape(n_samples, batch, n, n)
