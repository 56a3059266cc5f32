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

Two routes on the card, each counting its launches in
``soft_sort_fwd.route_launches`` / ``soft_sort_bwd.route_launches``:
``"cluster"`` (``csrc/neuralsort_cluster.cu``), the main path at every
L <= 512 (``route``): a slate's M0 split by rows across a thread-block
cluster of ``cluster_plan(L, backward)[0]`` blocks, held in their shared
memory for the whole loop; and ``"l2"`` (``csrc/neuralsort.cu``), one
block per slate re-reading M0 from L2, by name only (``launch_fwd("l2",
...)``), as X4 (``ops/neuralsort_layout.py``) twins it bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from allrank_tpu_torch.ops import _build
from allrank_tpu_torch.ops.sinkhorn import (
    sinkhorn_bwd_plain,
    sinkhorn_fwd_plain,
)

# the kernels' envelope, the JAX kernel's own MAX_FUSED_LENGTH
MAX_FUSED_LENGTH = 512
_NEG_FILL = -1e8
ROUTES = ("cluster", "l2")
# a block's shared memory on the H100 (232,448 bytes, the opt-in maximum)
SMEM_BYTES = 232_448
# csrc/neuralsort_cluster.cu's block: 512 threads (16 warps) whose
# registers hold the block's rows of M0 during the loop, 64 floats a thread
# at most: rows_per_lane x quads_per_warp = (8, 2) to L = 128, (4, 4) to
# 256, (2, 8) to 512, hence clusters of 1, 2 and 8 blocks
_WARPS = 16
_SHAPES = ((128, 1, (8, 2)), (256, 2, (4, 4)), (512, 8, (2, 8)))
# the loop's exchange buffers (each block's column sums, at least 512
# floats), the epilogue's product tile (8 rows x 128 columns a warp) and
# its staged iterations (two buffers of 4)
_XCH_FLOATS, _TILE_ROWS, _TILE_COLS, _STAGE = 512, 8, 128, 8
# the O(L) vectors of a block: the chain's six and b; backward also go,
# b_t, db, v, drs and the block's two column sums
_FWD_VECTORS, _BWD_VECTORS = 7, 13
_TAIL = [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 2 + [
    ctypes.c_void_p]
_CLUSTER_TAIL = [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]
_LIBRARIES = {
    "l2": ("neuralsort",
           {"soft_sort_fwd": [ctypes.c_void_p] * 7 + _TAIL,
            "soft_sort_bwd": [ctypes.c_void_p] * 9 + _TAIL}),
    "cluster": ("neuralsort_cluster",
                {"soft_sort_cluster_fwd": [ctypes.c_void_p] * 6
                 + _CLUSTER_TAIL,
                 "soft_sort_cluster_bwd": [ctypes.c_void_p] * 8
                 + _CLUSTER_TAIL,
                 "soft_sort_cluster_occupancy": [ctypes.c_int] * 4,
                 "soft_sort_cluster_floats": [ctypes.c_int] * 3,
                 "soft_sort_cluster_blocks": [ctypes.c_int]}),
}


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
    """Route "l2": one block per SM at most; the blocks walk the slates, so
    the scratch stays [blocks, L, L] whatever ``n`` is."""
    return min(n, torch.cuda.get_device_properties(dev).multi_processor_count)


def route(l: int) -> str:
    """The kernels that ``soft_sort_fwd`` and ``soft_sort_bwd`` launch on
    the card at slate length ``l``: "cluster" at every 1 <= l <=
    ``MAX_FUSED_LENGTH``; a longer slate raises."""
    if not 1 <= l <= MAX_FUSED_LENGTH:
        raise NotImplementedError(
            f"the fused soft-sort kernels cover 1 <= L <= {MAX_FUSED_LENGTH}"
            f", got {l}")
    return "cluster"


def cluster_rows(rank: int, cluster: int, l: int) -> range:
    """The rows of M0 (and the documents whose ds) block ``rank`` of a
    ``cluster``-block cluster holds: ``ceil(l / cluster)`` in a run."""
    per = -(-l // cluster)
    return range(min(l, rank * per), min(l, (rank + 1) * per))


def register_shape(l: int) -> tuple:
    """(blocks a cluster, (rows a lane, column quads a warp)) of the
    "cluster" route at slate length ``l``: a block's rows of M0 in the
    registers of its 16 warps during the loop, at most 64 floats a
    thread."""
    route(l)
    for top, cluster, shape in _SHAPES:
        if l <= top:
            return cluster, shape
    raise NotImplementedError(f"no register shape for a slate of {l}")


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def cluster_smem_floats(l: int, cluster: int, backward: bool) -> int:
    """Floats of shared memory a block of the "cluster" route takes
    (``csrc/neuralsort_cluster.cu``'s ``smem_floats``): its rows of M0 at a
    pitch of ``l`` rounded up to 4 (16-byte rows), the O(L) vectors, its
    own rows' vectors, the loop's exchanges and row partials and, in the
    backward, the epilogue's column sums and staged stacks in the same
    room."""
    pitch, rows = _up(l, 4), -(-l // cluster)
    loop = (2 * max(cluster * pitch, _XCH_FLOATS)
            + (2 if backward else 1) * _WARPS * _up(rows, 4))
    if not backward:
        return rows * pitch + _FWD_VECTORS * pitch + _up(rows, 4) + loop
    tiles = -(-l // _TILE_COLS)
    room = max(loop, 2 * (_WARPS // tiles) * pitch,
               _STAGE * (2 * _up(rows, 8) + 2 * _up(l, _TILE_COLS)))
    return rows * pitch + _BWD_VECTORS * pitch + 4 * _up(rows, 4) + room


def cluster_plan(l: int, backward: bool) -> tuple:
    """(blocks a cluster, shared-memory bytes a block) of the "cluster"
    route at slate length ``l``: ``register_shape``'s cluster (2 at L =
    240, 8 at L = 512), whose blocks fit ``SMEM_BYTES``."""
    cluster = register_shape(l)[0]
    nbytes = 4 * cluster_smem_floats(l, cluster, backward)
    if nbytes > SMEM_BYTES:
        raise NotImplementedError(f"no cluster holds a slate of {l}")
    return cluster, nbytes


def kernel_smem_floats(l: int, cluster: int, backward: bool) -> int:
    """The "cluster" kernels' own count of ``cluster_smem_floats`` (builds
    and loads the library; for the checks on the card)."""
    lib = _build.load(*_LIBRARIES["cluster"])
    return lib.soft_sort_cluster_floats(l, cluster, int(backward))


def kernel_cluster_blocks(l: int) -> int:
    """The "cluster" kernels' own cluster size at length ``l``."""
    lib = _build.load(*_LIBRARIES["cluster"])
    return lib.soft_sort_cluster_blocks(l)


def _clusters(lib, n: int, l: int, plan: tuple, backward: bool, dev) -> int:
    """The clusters to launch: ``n``, or as many as the card holds at once
    (``cudaOccupancyMaxActiveClusters``), which then walk the slates."""
    return min(n, _build.cluster_occupancy(
        lib, "soft_sort_cluster_occupancy", dev, int(backward), l, *plan))


def _check_way(way: str, l: int) -> None:
    if way not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {way!r}")
    route(l)


def soft_sort_fwd(s, pad_f, vec, tau, max_iter=50, transpose=False):
    """(out, a_hist, b_hist). A CPU tensor takes the plain version; a CUDA
    tensor launches the forward kernel of ``route(L)`` or raises."""
    _check(s, pad_f, vec, tau, max_iter)
    if s.device.type == "cpu":
        return soft_sort_fwd_plain(s, pad_f, vec, tau, max_iter, transpose)
    return launch_fwd(route(s.shape[1]), s, pad_f, vec, tau, max_iter,
                      transpose)


def launch_fwd(way, s, pad_f, vec, tau, max_iter=50, transpose=False):
    """``soft_sort_fwd`` through the kernel of route ``way`` ("cluster" or
    "l2"); counts the launch as the wrapper's. A CPU tensor takes the plain
    version."""
    _check(s, pad_f, vec, tau, max_iter)
    n, l = s.shape
    _check_way(way, l)
    if s.device.type == "cpu":
        return soft_sort_fwd_plain(s, pad_f, vec, tau, max_iter, transpose)
    dev = s.device
    for name, t in (("scores", s), ("pad_mask", pad_f), ("vec", vec)):
        _build.require(t, name, (n, l), torch.float32, dev)
    out = torch.empty_like(s)
    a_hist = torch.empty(n, max_iter + 1, l, dtype=torch.float32, device=dev)
    b_hist = torch.empty_like(a_hist)
    lib = _build.load(*_LIBRARIES[way])
    if way == "cluster":
        plan = cluster_plan(l, backward=False)
        clusters = _clusters(lib, n, l, plan, False, dev)
        with torch.cuda.device(dev):
            rc = lib.soft_sort_cluster_fwd(
                *map(_build.ptr, (s, pad_f, vec, out, a_hist, b_hist)),
                n, l, max_iter, float(tau), int(transpose), *plan, clusters,
                _build.stream_of(s))
    else:
        grid = _grid(n, dev)
        scratch = torch.empty(grid, l, l, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            rc = lib.soft_sort_fwd(
                *map(_build.ptr, (s, pad_f, vec, scratch, out, a_hist,
                                  b_hist)),
                n, l, max_iter, float(tau), int(transpose), grid,
                _build.stream_of(s))
    _build.check_launch(lib, rc, f"soft_sort_fwd ({way})")
    soft_sort_fwd.launches += 1
    soft_sort_fwd.route_launches[way] += 1
    return out, a_hist, b_hist


soft_sort_fwd.launches = 0
soft_sort_fwd.route_launches = dict.fromkeys(ROUTES, 0)


def soft_sort_bwd(s, pad_f, vec, a_hist, b_hist, dout, tau, max_iter=50,
                  transpose=False):
    """ds [N, L]. A CPU tensor takes the plain version; a CUDA tensor
    launches the backward kernel of ``route(L)`` or raises."""
    _check(s, pad_f, vec, tau, max_iter)
    if s.device.type == "cpu":
        return soft_sort_bwd_plain(s, pad_f, vec, a_hist, b_hist, dout, tau,
                                   max_iter, transpose)
    return launch_bwd(route(s.shape[1]), s, pad_f, vec, a_hist, b_hist, dout,
                      tau, max_iter, transpose)


def launch_bwd(way, s, pad_f, vec, a_hist, b_hist, dout, tau, max_iter=50,
               transpose=False):
    """``soft_sort_bwd`` through the kernel of route ``way``, on records
    from either route's forward; counts the launch as the wrapper's. A CPU
    tensor takes the plain version."""
    _check(s, pad_f, vec, tau, max_iter)
    n, l = s.shape
    _check_way(way, l)
    if s.device.type == "cpu":
        return soft_sort_bwd_plain(s, pad_f, vec, a_hist, b_hist, dout, tau,
                                   max_iter, transpose)
    dev = s.device
    for name, t in (("scores", s), ("pad_mask", pad_f), ("vec", vec),
                    ("dout", dout)):
        _build.require(t, name, (n, l), torch.float32, dev)
    for name, t in (("a_hist", a_hist), ("b_hist", b_hist)):
        _build.require(t, name, (n, max_iter + 1, l), torch.float32, dev)
    ds = torch.empty_like(s)
    lib = _build.load(*_LIBRARIES[way])
    if way == "cluster":
        plan = cluster_plan(l, backward=True)
        clusters = _clusters(lib, n, l, plan, True, dev)
        # each block's U [T, rows rounded up to 8] and V [T, L] stacks
        uv = torch.empty(clusters * plan[0], max_iter,
                         _up(-(-l // plan[0]), 8) + l, dtype=torch.float32,
                         device=dev)
        with torch.cuda.device(dev):
            rc = lib.soft_sort_cluster_bwd(
                *map(_build.ptr, (s, pad_f, vec, a_hist, b_hist, dout, uv,
                                  ds)),
                n, l, max_iter, float(tau), int(transpose), *plan, clusters,
                _build.stream_of(s))
    else:
        grid = _grid(n, dev)
        scratch = torch.empty(grid, 2, l, l, dtype=torch.float32, device=dev)
        uv = torch.empty(grid, 2, max_iter, l, dtype=torch.float32,
                         device=dev)
        with torch.cuda.device(dev):
            rc = lib.soft_sort_bwd(
                *map(_build.ptr, (s, pad_f, vec, a_hist, b_hist, dout,
                                  scratch, uv, ds)),
                n, l, max_iter, float(tau), int(transpose), grid,
                _build.stream_of(s))
    _build.check_launch(lib, rc, f"soft_sort_bwd ({way})")
    soft_sort_bwd.launches += 1
    soft_sort_bwd.route_launches[way] += 1
    return ds


soft_sort_bwd.launches = 0
soft_sort_bwd.route_launches = dict.fromkeys(ROUTES, 0)


class SoftSortContract(torch.autograd.Function):
    """The fused chain under autograd; gradients flow to the scores only.
    ``way`` names a route on the card, or None for ``route(L)``'s."""

    @staticmethod
    def forward(ctx, s, pad_f, vec, tau, max_iter, transpose, way):
        if way is None:
            out, a_hist, b_hist = soft_sort_fwd(s, pad_f, vec, tau,
                                                max_iter, transpose)
        else:
            out, a_hist, b_hist = launch_fwd(way, s, pad_f, vec, tau,
                                             max_iter, transpose)
        ctx.save_for_backward(s, pad_f, vec, a_hist, b_hist)
        ctx.args = (tau, max_iter, transpose)
        ctx.way = way
        return out

    @staticmethod
    def backward(ctx, dout):
        args = (*ctx.saved_tensors, dout.float().contiguous(), *ctx.args)
        if ctx.way is None:
            ds = soft_sort_bwd(*args)
        else:
            ds = launch_bwd(ctx.way, *args)
        return ds, None, None, None, None, None, None


def fused_soft_sort_contract(scores, pad_mask, vec, *, tau: float,
                             max_iter: int = 50, transpose: bool = False,
                             way=None):
    """``sinkhorn(neural_sort(scores, tau)) @ vec`` [N, L]; scores and vec
    [N, L], pad_mask [N, L] (True or 1 at padded positions), all cast to
    fp32. ``transpose=False`` contracts rank rows with ``vec`` (soft-sorted
    gains), ``transpose=True`` rank columns (expected discounts). On CUDA,
    L above ``MAX_FUSED_LENGTH`` raises ``NotImplementedError``; ``way``
    names a route ("l2" for the comparisons with X4), None takes
    ``route(L)``'s."""
    return SoftSortContract.apply(
        scores.float().contiguous(), pad_mask.float().contiguous(),
        vec.float().contiguous(), float(tau), int(max_iter), bool(transpose),
        way)
