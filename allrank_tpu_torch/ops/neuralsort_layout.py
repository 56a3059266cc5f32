"""The fused NeuralNDCG soft-sort with its Sinkhorn records held on chip
(X4): the CUDA kernels of ``csrc/neuralsort_layout.cu`` (forward and
backward) for CUDA tensors, tied into autograd by ``LayoutSoftSortContract``.

Replaces the TPU kernel ``make_fused_C`` of the JAX package's
``tools/exp_sinkhorn_layout.py:186`` (forward ``pallas_call`` at line 205,
backward at line 231), the probe that asks whether B8's scaling records
belong in fast memory in iteration-major order. X4 computes B8's function
(``ops/neuralsort.py``), so its plain versions are B8's:
``soft_sort_fwd_plain`` and ``soft_sort_bwd_plain``, which a CPU tensor
takes here as well. On the card the kernels are B8's main route "cluster"
kernels (``csrc/soft_sort_cluster_kernels.cuh``, built with
``kRecordsOnChip`` set) at B8's cluster sizes and register shapes, with the
records (and, in the backward, the U and V stacks) in shared memory for the
whole loop, so out, a_hist, b_hist and ds equal that route's bit for bit.

Shared memory bounds the slate length: the backward keeps its stacks in
the room of the block's rows of M0, ``(2 T + 1) (round8(R) +
round128(L))`` floats, so at T = 50 iterations L <= 384 (``max_length``).
A longer slate raises ``ValueError``; nothing falls back to B8.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from allrank_tpu_torch.ops import _build
from allrank_tpu_torch.ops import neuralsort as b8
from allrank_tpu_torch.ops.neuralsort import (
    _check,
    soft_sort_bwd_plain,
    soft_sort_fwd_plain,
)

SMEM_BYTES = b8.SMEM_BYTES
_TAIL = [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]
_LIBRARY = ("neuralsort_layout",
            {"soft_sort_layout_fwd": [ctypes.c_void_p] * 6 + _TAIL,
             "soft_sort_layout_bwd": [ctypes.c_void_p] * 7 + _TAIL,
             "soft_sort_layout_occupancy": [ctypes.c_int] * 4,
             "soft_sort_layout_floats": [ctypes.c_int] * 4})


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def smem_floats(l: int, cluster: int, max_iter: int, backward: bool) -> int:
    """Floats of shared memory a block takes (``csrc/neuralsort_layout.cu``'s
    ``layout_smem_floats``). Forward: B8's, and the block's records [T + 1,
    round4(R)] of a (its rows) and b (its share of the columns). Backward:
    B8's without its staging room, the rows' softmax max and sum, and the
    stacks in the room of M0's rows: a and U for the block's rows [T + 1 |
    T, round8(R)], b and V for every column [T + 1 | T, round128(L)]."""
    pitch, rows = _up(l, 4), -(-l // cluster)
    if not backward:
        return (b8.cluster_smem_floats(l, cluster, False)
                + 2 * (max_iter + 1) * _up(rows, 4))
    tiles = -(-l // b8._TILE_COLS)
    loop = (2 * max(cluster * pitch, b8._XCH_FLOATS)
            + 2 * b8._WARPS * _up(rows, 4))
    room = max(loop, 2 * (b8._WARPS // tiles) * pitch)
    m0_room = max(rows * pitch, (2 * max_iter + 1)
                  * (_up(rows, 8) + tiles * b8._TILE_COLS))
    return m0_room + b8._BWD_VECTORS * pitch + 6 * _up(rows, 4) + room


def layout_plan(l: int, max_iter: int, backward: bool) -> tuple:
    """(blocks a cluster, shared-memory bytes a block): B8's cluster size
    at ``l`` (``neuralsort.register_shape``) and this kernel's bytes, which
    may pass ``SMEM_BYTES`` (``max_length`` says where)."""
    cluster = b8.register_shape(l)[0]
    return cluster, 4 * smem_floats(l, cluster, max_iter, backward)


@functools.lru_cache(maxsize=None)
def max_length(max_iter: int = 50) -> int:
    """The longest slate L such that both kernels take every length up to
    L at ``max_iter`` iterations (384 at 50)."""
    for l in range(1, b8.MAX_FUSED_LENGTH + 1):
        if any(layout_plan(l, max_iter, bwd)[1] > SMEM_BYTES
               for bwd in (False, True)):
            return l - 1
    return b8.MAX_FUSED_LENGTH


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


def kernel_smem_floats(l: int, cluster: int, max_iter: int,
                       backward: bool) -> int:
    """The kernels' own count of ``smem_floats`` (builds and loads the
    library; for the checks on the card)."""
    lib = _build.load(*_LIBRARY)
    return lib.soft_sort_layout_floats(l, cluster, max_iter, int(backward))


def _clusters(lib, n: int, l: int, plan: tuple, backward: bool, dev) -> int:
    """The clusters to launch: ``n``, or as many as the card holds at once
    (``cudaOccupancyMaxActiveClusters``), which then walk the slates."""
    return min(n, _build.cluster_occupancy(
        lib, "soft_sort_layout_occupancy", dev, int(backward), l, *plan))


def layout_soft_sort_fwd(s, pad_f, vec, tau, max_iter=50, transpose=False):
    """(out, a_hist, b_hist), as B8's ``soft_sort_fwd``. A CPU tensor takes
    the plain version; a CUDA tensor launches the forward kernel or
    raises."""
    if s.device.type == "cpu":
        _check(s, pad_f, vec, tau, max_iter)
        return soft_sort_fwd_plain(s, pad_f, vec, tau, max_iter, transpose)
    n, l = _check_cuda(s, pad_f, vec, tau, max_iter)
    dev = s.device
    out = torch.empty_like(s)
    a_hist = torch.empty(n, max_iter + 1, l, dtype=torch.float32, device=dev)
    b_hist = torch.empty_like(a_hist)
    lib = _build.load(*_LIBRARY)
    plan = layout_plan(l, max_iter, backward=False)
    clusters = _clusters(lib, n, l, plan, False, dev)
    with torch.cuda.device(dev):
        rc = lib.soft_sort_layout_fwd(
            *map(_build.ptr, (s, pad_f, vec, out, a_hist, b_hist)), n, l,
            max_iter, float(tau), int(transpose), *plan, clusters,
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
    ds = torch.empty_like(s)
    lib = _build.load(*_LIBRARY)
    plan = layout_plan(l, max_iter, backward=True)
    clusters = _clusters(lib, n, l, plan, True, dev)
    with torch.cuda.device(dev):
        rc = lib.soft_sort_layout_bwd(
            *map(_build.ptr, (s, pad_f, vec, a_hist, b_hist, dout, ds)), n,
            l, max_iter, float(tau), int(transpose), *plan, clusters,
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
