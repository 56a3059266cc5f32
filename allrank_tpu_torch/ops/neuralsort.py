"""The fused NeuralNDCG soft-sort, NeuralSort -> Sinkhorn -> one contraction:
the CUDA kernels of ``csrc/neuralsort.cu`` (forward and backward) for CUDA
tensors and their plain PyTorch versions for CPU tensors, tied into autograd
by ``SoftSortContract``.

Replaces the TPU kernel ``fused_soft_sort_contract`` of the JAX package's
``ops/neuralsort_pallas.py:237`` (forward ``pallas_call`` at line 186,
backward at line 214). The loss only ever uses the relaxed permutation
matrix through one contraction, so the function returns the [N, L] vector
(and the Sinkhorn records for its backward); per slate, with pad = 1 at
padded documents::

    s_f = pad ? -1e8 : s;  s_z = pad ? 0 : s
    rs[j]    = sum_k |s_f[j] - s_f[k]| over valid pairs
    pm[i, j] = scaling[i] * s_z[j] - rs[j]    (-inf / 1.0 pad fills)
    P_hat = softmax(pm / tau);  M0 = P_hat with 0 / 1 pad fills
    P = sinkhorn(M0)                          (fixed trip count)
    out = (P masked to valid pairs) @ vec     [or its transpose @ vec]

Gradients flow to ``s`` only. The backward is the TPU kernel's analytic
chain (``_bwd_kernel``), not autograd. fp32 only.
"""

from __future__ import annotations

import ctypes

import torch

from allrank_tpu_torch.ops import _build
from allrank_tpu_torch.ops.sinkhorn import (
    sinkhorn_bwd_plain,
    sinkhorn_fwd_plain,
)

# the kernel's envelope, the JAX kernel's own MAX_FUSED_LENGTH
MAX_FUSED_LENGTH = 512
_NEG_FILL = -1e8
_TAIL = [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 2 + [
    ctypes.c_void_p]
_SIGNATURES = {"soft_sort_fwd": [ctypes.c_void_p] * 7 + _TAIL,
               "soft_sort_bwd": [ctypes.c_void_p] * 9 + _TAIL}


def _chain(s, pad_f, tau):
    """The NeuralSort chain on [N, L] scores and 0/1 pad floats: returns
    ``(m0, p_hat, pair_valid, valid_f, s_filled, scaling)`` (the TPU
    kernel's ``_chain``)."""
    l = s.shape[1]
    valid_f = 1.0 - pad_f
    padded = pad_f > 0.5
    s_filled = torch.where(padded, _NEG_FILL, s)
    s_zeroed = s * valid_f
    pair_valid = valid_f[:, :, None] * valid_f[:, None, :]
    pair_pad = (1.0 - pair_valid) > 0.5
    both_pad = (pad_f[:, :, None] * pad_f[:, None, :]) > 0.5
    diffs = (s_filled[:, :, None] - s_filled[:, None, :]).abs() * pair_valid
    row_sums = diffs.sum(dim=2)
    valid_n = valid_f.sum(dim=1, keepdim=True)
    rank = torch.arange(1, l + 1, dtype=s.dtype, device=s.device)[None, :]
    scaling = torch.where(rank <= valid_n, valid_n + 1.0 - 2.0 * rank, 0.0)
    p_max = scaling[:, :, None] * s_zeroed[:, None, :] - row_sums[:, None, :]
    p_max = torch.where(pair_pad, float("-inf"), p_max)
    p_max = torch.where(both_pad, 1.0, p_max)
    z = p_max / tau
    e = torch.exp(z - z.max(dim=2, keepdim=True).values)
    p_hat = e / e.sum(dim=2, keepdim=True)
    m0 = torch.where(pair_pad, 0.0, p_hat)
    m0 = torch.where(both_pad, 1.0, m0)
    return m0, p_hat, pair_valid, valid_f, s_filled, scaling


def soft_sort_fwd_plain(s, pad_f, vec, tau, max_iter=50, transpose=False):
    """(out [N, L], a_hist, b_hist [N, T + 1, L]) in plain PyTorch ops."""
    m0, _, pair_valid, *_ = _chain(s, pad_f, tau)
    p, a_hist, b_hist = sinkhorn_fwd_plain(m0, max_iter)
    p = p * pair_valid
    if transpose:
        out = (p * vec[:, :, None]).sum(dim=1)   # out[j] = sum_i P[i,j] v[i]
    else:
        out = (p * vec[:, None, :]).sum(dim=2)   # out[i] = sum_j P[i,j] v[j]
    return out, a_hist, b_hist


def soft_sort_bwd_plain(s, pad_f, vec, a_hist, b_hist, dout, tau,
                        max_iter=50, transpose=False):
    """ds [N, L] for the output cotangent ``dout`` [N, L], in plain PyTorch
    ops (the TPU kernel's ``_bwd_kernel``)."""
    m0, p_hat, pair_valid, valid_f, s_filled, scaling = _chain(s, pad_f, tau)
    if transpose:
        dp = dout[:, None, :] * vec[:, :, None]
    else:
        dp = dout[:, :, None] * vec[:, None, :]
    dp = dp * pair_valid
    dm0 = sinkhorn_bwd_plain(m0, a_hist, b_hist, dp, max_iter)
    dphat = dm0 * pair_valid
    inner = (dphat * p_hat).sum(dim=2, keepdim=True)
    dpm = ((dphat - inner) * p_hat / tau) * pair_valid
    ds_zero = (dpm * scaling[:, :, None]).sum(dim=1)
    drs = -dpm.sum(dim=1)
    sgn = torch.sign(s_filled[:, :, None] - s_filled[:, None, :]) * pair_valid
    ds_abs = drs * sgn.sum(dim=2) - (drs[:, :, None] * sgn).sum(dim=1)
    return (ds_zero + ds_abs) * valid_f


def _check(s, pad_f, vec, tau, max_iter):
    if s.dim() != 2:
        raise ValueError(f"scores must be [N, L], got {tuple(s.shape)}")
    if pad_f.shape != s.shape or vec.shape != s.shape:
        raise ValueError("scores, pad_mask and vec must share one shape")
    if not tau > 0.0:
        raise ValueError(f"tau must be positive, got {tau}")
    if max_iter < 1:
        raise ValueError(f"max_iter must be positive, got {max_iter}")
    if s.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no soft-sort for device {s.device}")
    if s.device.type == "cuda" and s.shape[1] > MAX_FUSED_LENGTH:
        raise NotImplementedError(
            f"the fused soft-sort kernel covers L <= {MAX_FUSED_LENGTH}, got "
            f"{s.shape[1]}; longer slates take the materialised chain "
            f"through soft_sort.sinkhorn_scaling")


def _grid(n: int, dev) -> int:
    """One block per SM at most; the blocks walk the slates, so the scratch
    stays [blocks, L, L] whatever ``n`` is."""
    return min(n, torch.cuda.get_device_properties(dev).multi_processor_count)


def soft_sort_fwd(s, pad_f, vec, tau, max_iter=50, transpose=False):
    """(out, a_hist, b_hist). A CPU tensor takes the plain version; a CUDA
    tensor launches the forward kernel or raises."""
    _check(s, pad_f, vec, tau, max_iter)
    if s.device.type == "cpu":
        return soft_sort_fwd_plain(s, pad_f, vec, tau, max_iter, transpose)
    n, l = s.shape
    dev = s.device
    for name, t in (("scores", s), ("pad_mask", pad_f), ("vec", vec)):
        _build.require(t, name, (n, l), torch.float32, dev)
    grid = _grid(n, dev)
    out = torch.empty_like(s)
    a_hist = torch.empty(n, max_iter + 1, l, dtype=torch.float32, device=dev)
    b_hist = torch.empty_like(a_hist)
    scratch = torch.empty(grid, l, l, dtype=torch.float32, device=dev)
    lib = _build.load("neuralsort", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.soft_sort_fwd(
            *map(_build.ptr, (s, pad_f, vec, scratch, out, a_hist, b_hist)),
            n, l, max_iter, float(tau), int(transpose), grid,
            _build.stream_of(s))
    _build.check_launch(lib, rc, "soft_sort_fwd")
    soft_sort_fwd.launches += 1
    return out, a_hist, b_hist


soft_sort_fwd.launches = 0


def soft_sort_bwd(s, pad_f, vec, a_hist, b_hist, dout, tau, max_iter=50,
                  transpose=False):
    """ds [N, L]. A CPU tensor takes the plain version; a CUDA tensor
    launches the backward kernel or raises."""
    _check(s, pad_f, vec, tau, max_iter)
    if s.device.type == "cpu":
        return soft_sort_bwd_plain(s, pad_f, vec, a_hist, b_hist, dout, tau,
                                   max_iter, transpose)
    n, l = s.shape
    dev = s.device
    for name, t in (("scores", s), ("pad_mask", pad_f), ("vec", vec),
                    ("dout", dout)):
        _build.require(t, name, (n, l), torch.float32, dev)
    for name, t in (("a_hist", a_hist), ("b_hist", b_hist)):
        _build.require(t, name, (n, max_iter + 1, l), torch.float32, dev)
    grid = _grid(n, dev)
    ds = torch.empty_like(s)
    scratch = torch.empty(grid, 2, l, l, dtype=torch.float32, device=dev)
    uv = torch.empty(grid, 2, max_iter, l, dtype=torch.float32, device=dev)
    lib = _build.load("neuralsort", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.soft_sort_bwd(
            *map(_build.ptr, (s, pad_f, vec, a_hist, b_hist, dout, scratch,
                              uv, ds)),
            n, l, max_iter, float(tau), int(transpose), grid,
            _build.stream_of(s))
    _build.check_launch(lib, rc, "soft_sort_bwd")
    soft_sort_bwd.launches += 1
    return ds


soft_sort_bwd.launches = 0


class SoftSortContract(torch.autograd.Function):
    """The fused chain under autograd; gradients flow to the scores only."""

    @staticmethod
    def forward(ctx, s, pad_f, vec, tau, max_iter, transpose):
        out, a_hist, b_hist = soft_sort_fwd(s, pad_f, vec, tau, max_iter,
                                            transpose)
        ctx.save_for_backward(s, pad_f, vec, a_hist, b_hist)
        ctx.args = (tau, max_iter, transpose)
        return out

    @staticmethod
    def backward(ctx, dout):
        ds = soft_sort_bwd(*ctx.saved_tensors, dout.float().contiguous(),
                           *ctx.args)
        return ds, None, None, None, None, None


def fused_soft_sort_contract(scores, pad_mask, vec, *, tau: float,
                             max_iter: int = 50, transpose: bool = False):
    """``sinkhorn(neural_sort(scores, tau)) @ vec`` [N, L]; scores and vec
    [N, L], pad_mask [N, L] (True or 1 at padded positions), all cast to
    fp32. ``transpose=False`` contracts rank rows with ``vec`` (soft-sorted
    gains), ``transpose=True`` rank columns (expected discounts). On CUDA,
    L above ``MAX_FUSED_LENGTH`` raises ``NotImplementedError``."""
    return SoftSortContract.apply(
        scores.float().contiguous(), pad_mask.float().contiguous(),
        vec.float().contiguous(), float(tau), int(max_iter), bool(transpose))
