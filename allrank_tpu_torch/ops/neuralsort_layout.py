"""The fused NeuralNDCG soft-sort with its Sinkhorn records held on chip
(X4): the CUDA kernels of ``csrc/neuralsort_layout.cu`` (forward and
backward) for CUDA tensors, tied into autograd by ``LayoutSoftSortContract``.

Replaces the TPU kernel ``make_fused_C`` of the JAX package's
``tools/exp_sinkhorn_layout.py:186`` (forward ``pallas_call`` at line 205,
backward at line 231), the probe that asks whether B8's scaling records
belong in fast memory in iteration-major order. X4 computes B8's function
(``ops/neuralsort.py``), so its plain versions are B8's:
``soft_sort_fwd_plain`` and ``soft_sort_bwd_plain``, which a CPU tensor
takes here as well. On the card the kernels run the slate bodies of B8's
route "l2" (``csrc/neuralsort.cu``, ``launch_fwd("l2", ...)``) with the
records (and, in the backward, the U and V stacks) in shared memory, so
out, a_hist, b_hist and ds equal that route's bit for bit.

Shared memory bounds the slate length: the backward holds
``(4 T + 24) L`` floats, so at T = 50 iterations L <= 259
(``max_length``). A longer slate raises ``ValueError``; nothing falls back
to B8.
"""

from __future__ import annotations

import ctypes

import torch

from allrank_tpu_torch.ops import _build
from allrank_tpu_torch.ops.neuralsort import (
    _check,
    _grid,
    soft_sort_bwd_plain,
    soft_sort_fwd_plain,
)

# a block's shared memory on the H100 (232,448 bytes, the opt-in maximum)
SMEM_BYTES = 232_448
# the O(L) vectors of B8's slate bodies (csrc/soft_sort.cuh's
# kSoftSortFwdVectors and kSoftSortBwdVectors; csrc/neuralsort_layout.cu's
# soft_sort_layout_vectors returns the totals)
FWD_VECTORS, BWD_VECTORS = 25, 22
_TAIL = [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 2 + [
    ctypes.c_void_p]
_SIGNATURES = {"soft_sort_layout_fwd": [ctypes.c_void_p] * 7 + _TAIL,
               "soft_sort_layout_bwd": [ctypes.c_void_p] * 8 + _TAIL,
               "soft_sort_layout_vectors": [ctypes.c_int] * 2}


def smem_floats(l: int, max_iter: int, backward: bool) -> int:
    """Floats of shared memory a block of the forward or backward takes."""
    if backward:
        return (4 * max_iter + 2 + BWD_VECTORS) * l
    return (2 * max_iter + 2 + FWD_VECTORS) * l


def max_length(max_iter: int = 50) -> int:
    """The longest slate both kernels take at ``max_iter`` iterations."""
    return SMEM_BYTES // (4 * smem_floats(1, max_iter, backward=True))


def check_length(l: int, max_iter: int) -> None:
    """Raises ``ValueError`` past ``max_length(max_iter)``."""
    cap = max_length(max_iter)
    if l > cap:
        raise ValueError(
            f"the on-chip soft-sort holds its records in shared memory and "
            f"covers L <= {cap} at {max_iter} iterations, got {l}")


def _check_cuda(s, pad_f, vec, tau, max_iter):
    if s.dim() == 2:
        check_length(s.shape[1], max_iter)
    _check(s, pad_f, vec, tau, max_iter)
    n, l = s.shape
    for name, t in (("scores", s), ("pad_mask", pad_f), ("vec", vec)):
        _build.require(t, name, (n, l), torch.float32, s.device)
    return n, l


def layout_vectors(max_iter: int, backward: bool) -> int:
    """The kernel's own count of ``smem_floats(1, ...)`` (builds and loads
    the library; for the checks on the card)."""
    lib = _build.load("neuralsort_layout", _SIGNATURES)
    return lib.soft_sort_layout_vectors(max_iter, int(backward))


def layout_soft_sort_fwd(s, pad_f, vec, tau, max_iter=50, transpose=False):
    """(out, a_hist, b_hist), as B8's ``soft_sort_fwd``. A CPU tensor takes
    the plain version; a CUDA tensor launches the forward kernel or
    raises."""
    if s.device.type == "cpu":
        _check(s, pad_f, vec, tau, max_iter)
        return soft_sort_fwd_plain(s, pad_f, vec, tau, max_iter, transpose)
    n, l = _check_cuda(s, pad_f, vec, tau, max_iter)
    dev = s.device
    grid = _grid(n, dev)
    out = torch.empty_like(s)
    a_hist = torch.empty(n, max_iter + 1, l, dtype=torch.float32, device=dev)
    b_hist = torch.empty_like(a_hist)
    scratch = torch.empty(grid, l, l, dtype=torch.float32, device=dev)
    lib = _build.load("neuralsort_layout", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.soft_sort_layout_fwd(
            *map(_build.ptr, (s, pad_f, vec, scratch, out, a_hist, b_hist)),
            n, l, max_iter, float(tau), int(transpose), grid,
            _build.stream_of(s))
    _build.check_launch(lib, rc, "soft_sort_layout_fwd")
    layout_soft_sort_fwd.launches += 1
    return out, a_hist, b_hist


layout_soft_sort_fwd.launches = 0


def layout_soft_sort_bwd(s, pad_f, vec, a_hist, b_hist, dout, tau,
                         max_iter=50, transpose=False):
    """ds [N, L], as B8's ``soft_sort_bwd``. A CPU tensor takes the plain
    version; a CUDA tensor launches the backward kernel or raises."""
    if s.device.type == "cpu":
        _check(s, pad_f, vec, tau, max_iter)
        return soft_sort_bwd_plain(s, pad_f, vec, a_hist, b_hist, dout, tau,
                                   max_iter, transpose)
    n, l = _check_cuda(s, pad_f, vec, tau, max_iter)
    dev = s.device
    _build.require(dout, "dout", (n, l), torch.float32, dev)
    for name, t in (("a_hist", a_hist), ("b_hist", b_hist)):
        _build.require(t, name, (n, max_iter + 1, l), torch.float32, dev)
    grid = _grid(n, dev)
    ds = torch.empty_like(s)
    scratch = torch.empty(grid, 2, l, l, dtype=torch.float32, device=dev)
    lib = _build.load("neuralsort_layout", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.soft_sort_layout_bwd(
            *map(_build.ptr, (s, pad_f, vec, a_hist, b_hist, dout, scratch,
                              ds)),
            n, l, max_iter, float(tau), int(transpose), grid,
            _build.stream_of(s))
    _build.check_launch(lib, rc, "soft_sort_layout_bwd")
    layout_soft_sort_bwd.launches += 1
    return ds


layout_soft_sort_bwd.launches = 0


class LayoutSoftSortContract(torch.autograd.Function):
    """X4 under autograd; saves what B8's ``SoftSortContract`` saves and
    gives gradients to the scores only."""

    @staticmethod
    def forward(ctx, s, pad_f, vec, tau, max_iter, transpose):
        out, a_hist, b_hist = layout_soft_sort_fwd(s, pad_f, vec, tau,
                                                   max_iter, transpose)
        ctx.save_for_backward(s, pad_f, vec, a_hist, b_hist)
        ctx.args = (tau, max_iter, transpose)
        return out

    @staticmethod
    def backward(ctx, dout):
        ds = layout_soft_sort_bwd(*ctx.saved_tensors,
                                  dout.float().contiguous(), *ctx.args)
        return ds, None, None, None, None, None


def layout_soft_sort_contract(scores, pad_mask, vec, *, tau: float,
                              max_iter: int = 50, transpose: bool = False):
    """B8's ``fused_soft_sort_contract`` through X4: ``sinkhorn(neural_sort(
    scores, tau)) @ vec`` [N, L], gradients to the scores."""
    return LayoutSoftSortContract.apply(
        scores.float().contiguous(), pad_mask.float().contiguous(),
        vec.float().contiguous(), float(tau), int(max_iter), bool(transpose))
