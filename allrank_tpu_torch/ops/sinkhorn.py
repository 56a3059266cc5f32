"""Fixed-trip Sinkhorn scaling of pre-masked matrices: the CUDA kernels of
two routes (forward and backward) for CUDA tensors and their plain PyTorch
versions for CPU tensors, tied into autograd by ``SinkhornCore``.

Replaces the TPU kernel ``sinkhorn_core_fused`` of the JAX package's
``ops/sinkhorn_pallas.py:275`` (forward ``pallas_call`` at line 286,
backward at line 325). Every sequence of row and column scalings is
``P = diag(a) M0 diag(b)``; one iteration is::

    c = b * (M0^T a);  b <- b           where c == 0
                            min(b / max(c, eps), 1e15) elsewhere
    r = a * (M0 b);    a <- likewise

always ``max_iter`` iterations (no tolerance freeze), with every (a_t, b_t)
recorded. The backward is the TPU kernel's analytic reverse pass, not
autograd: it rebuilds each iteration's matvec values from the records by
true division and collects ``dM0 = dP * outer(a_T, b_T) + sum_t outer(u_t,
b_t) + outer(a_{t-1}, v_t)``. fp32 only.

Two routes on the card, each counting its launches in
``sinkhorn_fwd.route_launches`` / ``sinkhorn_bwd.route_launches``:
``"cluster"`` (``csrc/sinkhorn_cluster.cu``), the main path at every
1 <= L <= 768 (``route``): a slate's M0 split by rows across a
thread-block cluster of ``cluster_plan(L, backward)[0]`` blocks, held in
their shared memory for the whole loop; and ``"l2"``
(``csrc/sinkhorn.cu``), one block a slate re-reading M0 from L2, by name
only (``launch_fwd("l2", ...)``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from allrank_tpu_torch.constants import DEFAULT_EPS
from allrank_tpu_torch.ops import _build

# the kernels' envelope, the JAX kernel's own cap (its dispatch table's
# ``sinkhorn_max_fused_len``)
MAX_FUSED_LENGTH = 768
SCALING_CAP = 1e15
# the clamp max(., eps) passes gradient only where it is inactive
CLAMP_GATE = DEFAULT_EPS * 1.0001
ROUTES = ("cluster", "l2")
# a block's shared memory on the H100 (232,448 bytes, the opt-in maximum)
SMEM_BYTES = 232_448
# csrc/sinkhorn_cluster.cu's block: 1024 threads; a column pass puts a
# thread on a column quad and a group of rows; clusters of 1 to 16 blocks
_THREADS, _MAX_CLUSTER = 1024, 16
_LIBRARIES = {
    "l2": ("sinkhorn",
           {"sinkhorn_fwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
            + [ctypes.c_void_p],
            "sinkhorn_bwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
            + [ctypes.c_void_p]}),
    "cluster": ("sinkhorn_cluster",
                {"sinkhorn_cluster_fwd": [ctypes.c_void_p] * 4
                 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
                 "sinkhorn_cluster_bwd": [ctypes.c_void_p] * 6
                 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
                 "sinkhorn_cluster_occupancy": [ctypes.c_int] * 3,
                 "sinkhorn_cluster_floats": [ctypes.c_int] * 3,
                 "sinkhorn_cluster_blocks": [ctypes.c_int]}),
}


def _rescale(scale, total):
    """One half-iteration's update of a scaling vector from its sums."""
    return torch.where(
        total == 0.0, scale,
        torch.clamp(scale / torch.clamp(total, min=DEFAULT_EPS),
                    max=SCALING_CAP))


def sinkhorn_fwd_plain(m0: torch.Tensor, max_iter: int = 50):
    """(P [N, L, L], a_hist, b_hist [N, T + 1, L]) in plain PyTorch ops."""
    n, l, _ = m0.shape
    a = torch.ones(n, l, dtype=m0.dtype, device=m0.device)
    b = torch.ones_like(a)
    a_hist, b_hist = [a], [b]
    for _ in range(max_iter):
        b = _rescale(b, b * torch.einsum("nij,ni->nj", m0, a))
        a = _rescale(a, a * torch.einsum("nij,nj->ni", m0, b))
        a_hist.append(a)
        b_hist.append(b)
    p = a[:, :, None] * m0 * b[:, None, :]
    return p, torch.stack(a_hist, dim=1), torch.stack(b_hist, dim=1)


def sinkhorn_bwd_plain(m0, a_hist, b_hist, dp, max_iter: int = 50):
    """dM0 [N, L, L] from the output cotangent ``dp`` and the records, in
    plain PyTorch ops (the TPU kernel's ``sinkhorn_bwd_core``)."""
    a_t, b_t = a_hist[:, max_iter], b_hist[:, max_iter]
    g = dp * m0
    da = (g * b_t[:, None, :]).sum(dim=2)
    db = (g * a_t[:, :, None]).sum(dim=1)
    us, vs = [], []
    for t in range(max_iter, 0, -1):
        a_prev, b_prev = a_hist[:, t - 1], b_hist[:, t - 1]
        m_r = a_prev / a_t          # max(r_t, eps)
        m_c = b_prev / b_t          # max(c_t, eps)
        mb = m_r / a_prev           # M0 b_t
        mta = m_c / b_prev          # M0^T a_{t-1}
        dr = torch.where(m_r > CLAMP_GATE, -da * a_prev / (m_r * m_r), 0.0)
        da_prev = da / m_r + dr * mb
        u = dr * a_prev
        cot = db + torch.einsum("nij,ni->nj", m0, u)
        dc = torch.where(m_c > CLAMP_GATE, -cot * b_prev / (m_c * m_c), 0.0)
        db_prev = cot / m_c + dc * mta
        v = dc * b_prev
        da_prev = da_prev + torch.einsum("nij,nj->ni", m0, v)
        us.append(u)
        vs.append(v)
        da, db, a_t, b_t = da_prev, db_prev, a_prev, b_prev
    u_all = torch.stack(us[::-1], dim=1)   # [N, T, L], row s is u_{s+1}
    v_all = torch.stack(vs[::-1], dim=1)
    a_T, b_T = a_hist[:, max_iter], b_hist[:, max_iter]
    return (dp * a_T[:, :, None] * b_T[:, None, :]
            + torch.einsum("nti,ntj->nij", u_all, b_hist[:, 1:max_iter + 1])
            + torch.einsum("nti,ntj->nij", a_hist[:, :max_iter], v_all))


def _check(m0, max_iter):
    if m0.dim() != 3 or m0.shape[1] != m0.shape[2]:
        raise ValueError(f"m0 must be [N, L, L], got {tuple(m0.shape)}")
    if max_iter < 1:
        raise ValueError(f"max_iter must be positive, got {max_iter}")
    if m0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no Sinkhorn scaling for device {m0.device}")
    if m0.device.type == "cuda" and m0.shape[1] > MAX_FUSED_LENGTH:
        raise NotImplementedError(
            f"the Sinkhorn kernel covers L <= {MAX_FUSED_LENGTH}, got "
            f"{m0.shape[1]}; longer slates take soft_sort.sinkhorn_scaling's "
            f"plain chain")


def route(l: int) -> str:
    """The kernels that ``sinkhorn_fwd`` and ``sinkhorn_bwd`` launch on the
    card at slate length ``l``: "cluster" at every 1 <= l <=
    ``MAX_FUSED_LENGTH``; a longer slate raises."""
    if not 1 <= l <= MAX_FUSED_LENGTH:
        raise NotImplementedError(
            f"the Sinkhorn kernels cover 1 <= L <= {MAX_FUSED_LENGTH}, got "
            f"{l}")
    return "cluster"


@functools.lru_cache(maxsize=None)
def cluster_blocks(l: int) -> int:
    """The blocks of a "cluster" route's cluster at slate length ``l``: the
    smallest power of two whose blocks' shares fit ``SMEM_BYTES`` in both
    directions (fewer blocks exchange less: 8 at L = 640, 16 at 768)."""
    route(l)
    cluster = 1
    while cluster < _MAX_CLUSTER and 4 * max(
            cluster_smem_floats(l, cluster, bwd)
            for bwd in (False, True)) > SMEM_BYTES:
        cluster *= 2
    return cluster


def cluster_rows(rank: int, cluster: int, l: int) -> range:
    """The rows of M0 (and the columns whose records) block ``rank`` of a
    ``cluster``-block cluster holds: ``ceil(l / cluster)`` in a run."""
    per = -(-l // cluster)
    return range(min(l, rank * per), min(l, (rank + 1) * per))


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def cluster_smem_floats(l: int, cluster: int, backward: bool) -> int:
    """Floats of shared memory a block of the "cluster" route takes
    (``csrc/sinkhorn_cluster.cu``'s ``sink_smem_floats``): its rows of M0
    at a pitch of ``l`` rounded up to 4 (in the backward also the room of
    the epilogue's staged stacks, one iteration at least), the row groups'
    partials of a column pass, two published buffers of column sums, the
    vectors of all columns (b; backward b_t, db, and v in the partials'
    room: never live together) and of the block's rows (a; backward a_t,
    da, u)."""
    pitch, rows = _up(l, 4), -(-l // cluster)
    room = max(rows * pitch, 2 * (pitch + _up(rows, 4)))
    groups = max(1, min(_THREADS // (pitch // 4), rows))
    return (room + (groups + 2 + (2 if backward else 1)) * pitch
            + (3 if backward else 1) * _up(rows, 4))


def cluster_plan(l: int, backward: bool) -> tuple:
    """(blocks a cluster, shared-memory bytes a block) of the "cluster"
    route at slate length ``l`` (8 blocks of 80 rows of M0 at L = 640, 16
    of 48 at 768), whose blocks fit ``SMEM_BYTES``."""
    cluster = cluster_blocks(l)
    return cluster, 4 * cluster_smem_floats(l, cluster, backward)


def kernel_smem_floats(l: int, cluster: int, backward: bool) -> int:
    """The "cluster" kernels' own count of ``cluster_smem_floats`` (builds
    and loads the library; for the checks on the card)."""
    lib = _build.load(*_LIBRARIES["cluster"])
    return lib.sinkhorn_cluster_floats(l, cluster, int(backward))


def kernel_cluster_blocks(l: int) -> int:
    """The "cluster" kernels' own cluster size at length ``l``."""
    lib = _build.load(*_LIBRARIES["cluster"])
    return lib.sinkhorn_cluster_blocks(l)


def cluster_occupancy(plan: tuple, backward: bool, dev) -> int:
    """The clusters of ``plan`` that the card holds at once
    (``cudaOccupancyMaxActiveClusters``); raises if it holds none."""
    return _build.cluster_occupancy(
        _build.load(*_LIBRARIES["cluster"]), "sinkhorn_cluster_occupancy",
        dev, int(backward), *plan)


def _check_way(way: str, l: int) -> None:
    if way not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {way!r}")
    route(l)


def sinkhorn_fwd(m0: torch.Tensor, max_iter: int = 50):
    """(P, a_hist, b_hist). A CPU tensor takes the plain version; a CUDA
    tensor launches the forward kernel of ``route(L)`` or raises."""
    _check(m0, max_iter)
    if m0.device.type == "cpu":
        return sinkhorn_fwd_plain(m0, max_iter)
    return launch_fwd(route(m0.shape[1]), m0, max_iter)


def launch_fwd(way: str, m0: torch.Tensor, max_iter: int = 50):
    """``sinkhorn_fwd`` through the kernel of route ``way`` ("cluster" or
    "l2"); counts the launch as the wrapper's. A CPU tensor takes the plain
    version."""
    _check(m0, max_iter)
    n, l, _ = m0.shape
    _check_way(way, l)
    if m0.device.type == "cpu":
        return sinkhorn_fwd_plain(m0, max_iter)
    dev = m0.device
    _build.require(m0, "m0", (n, l, l), torch.float32, dev)
    p = torch.empty_like(m0)
    a_hist = torch.empty(n, max_iter + 1, l, dtype=torch.float32, device=dev)
    b_hist = torch.empty_like(a_hist)
    lib = _build.load(*_LIBRARIES[way])
    if way == "cluster":
        plan = cluster_plan(l, False)
        clusters = min(n, cluster_occupancy(plan, False, dev))
        with torch.cuda.device(dev):
            rc = lib.sinkhorn_cluster_fwd(
                *map(_build.ptr, (m0, p, a_hist, b_hist)), n, l, max_iter,
                *plan, clusters, _build.stream_of(m0))
    else:
        with torch.cuda.device(dev):
            rc = lib.sinkhorn_fwd(*map(_build.ptr, (m0, p, a_hist, b_hist)),
                                  n, l, max_iter, n, _build.stream_of(m0))
    _build.check_launch(lib, rc, f"sinkhorn_fwd ({way})")
    sinkhorn_fwd.launches += 1
    sinkhorn_fwd.route_launches[way] += 1
    return p, a_hist, b_hist


sinkhorn_fwd.launches = 0
sinkhorn_fwd.route_launches = dict.fromkeys(ROUTES, 0)


def sinkhorn_bwd(m0, a_hist, b_hist, dp, max_iter: int = 50):
    """dM0 [N, L, L]. A CPU tensor takes the plain version; a CUDA tensor
    launches the backward kernel of ``route(L)`` or raises."""
    _check(m0, max_iter)
    if m0.device.type == "cpu":
        return sinkhorn_bwd_plain(m0, a_hist, b_hist, dp, max_iter)
    return launch_bwd(route(m0.shape[1]), m0, a_hist, b_hist, dp, max_iter)


def launch_bwd(way: str, m0, a_hist, b_hist, dp, max_iter: int = 50):
    """``sinkhorn_bwd`` through the kernel of route ``way``, on records from
    either route's forward; counts the launch as the wrapper's. A CPU tensor
    takes the plain version."""
    _check(m0, max_iter)
    n, l, _ = m0.shape
    _check_way(way, l)
    if m0.device.type == "cpu":
        return sinkhorn_bwd_plain(m0, a_hist, b_hist, dp, max_iter)
    dev = m0.device
    _build.require(m0, "m0", (n, l, l), torch.float32, dev)
    _build.require(dp, "dp", (n, l, l), torch.float32, dev)
    for name, t in (("a_hist", a_hist), ("b_hist", b_hist)):
        _build.require(t, name, (n, max_iter + 1, l), torch.float32, dev)
    dm0 = torch.empty_like(m0)
    lib = _build.load(*_LIBRARIES[way])
    if way == "cluster":
        plan = cluster_plan(l, True)
        clusters = min(n, cluster_occupancy(plan, True, dev))
        # each cluster's U and V stacks [T, L]
        uv = torch.empty(clusters, 2, max_iter, l, dtype=torch.float32,
                         device=dev)
        with torch.cuda.device(dev):
            rc = lib.sinkhorn_cluster_bwd(
                *map(_build.ptr, (m0, a_hist, b_hist, dp, uv, dm0)), n, l,
                max_iter, *plan, clusters, _build.stream_of(m0))
    else:
        uv = torch.empty(n, 2, max_iter, l, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            rc = lib.sinkhorn_bwd(
                *map(_build.ptr, (m0, a_hist, b_hist, dp, uv, dm0)), n, l,
                max_iter, n, _build.stream_of(m0))
    _build.check_launch(lib, rc, f"sinkhorn_bwd ({way})")
    sinkhorn_bwd.launches += 1
    sinkhorn_bwd.route_launches[way] += 1
    return dm0


sinkhorn_bwd.launches = 0
sinkhorn_bwd.route_launches = dict.fromkeys(ROUTES, 0)


class SinkhornCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m0, max_iter):
        p, a_hist, b_hist = sinkhorn_fwd(m0, max_iter)
        ctx.save_for_backward(m0, a_hist, b_hist)
        ctx.max_iter = max_iter
        return p

    @staticmethod
    def backward(ctx, dp):
        m0, a_hist, b_hist = ctx.saved_tensors
        return sinkhorn_bwd(m0, a_hist, b_hist, dp.float().contiguous(),
                            ctx.max_iter), None


def sinkhorn_core_fused(m0: torch.Tensor, max_iter: int = 50) -> torch.Tensor:
    """Fixed-trip Sinkhorn on pre-masked matrices [N, L, L], cast to fp32;
    differentiable in ``m0``. On CUDA, L above ``MAX_FUSED_LENGTH`` raises
    ``NotImplementedError``."""
    return SinkhornCore.apply(m0.float().contiguous(), int(max_iter))
