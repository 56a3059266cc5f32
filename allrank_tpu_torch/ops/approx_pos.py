"""The approxNDCG rank sum ``pos_i = sum_j m_ij max(sigmoid(-alpha (s_i -
s_j)), eps)`` over valid off-diagonal pairs: the CUDA kernels of
``csrc/approx_pos.cu`` (forward and backward) for CUDA tensors and their
plain PyTorch versions for CPU tensors, tied into autograd by ``ApproxPos``.

Replaces the TPU kernel ``fused_approx_pos`` of the JAX package's
``ops/approx_pallas.py:107`` (forward ``pallas_call`` at line 79, backward
at line 94). The backward reduces the pair cotangents analytically, as
there (lines 15-23)::

    t_ij = sigmoid(-alpha (s_i - s_j))                on valid pairs
    ds_k = sum_j c_kj - sum_i c_ik,
    c_ij = u_i m_ij [t_ij > eps] (-alpha) t_ij (1 - t_ij)

with ``u`` the cotangent of the rank sums; the clamp's subgradient takes
the sigmoid branch iff ``t > eps``. Gradients flow to the scores only. fp32
only, as the JAX loss upcasts.

The TPU kernel's cap of 384 is a VMEM fact (it holds a [bb, L, L] block);
the CUDA kernel holds nothing [L, L] and covers L <= ``MAX_LENGTH``. It
runs over each slate's valid documents only (any mask, compacted in the
block), takes the sigmoid sign-folded (``e = exp(-|x|)``, ``r = 1 / (1 +
e)``: ``t_ij`` and ``t_ji`` are ``r`` and ``e r``) and the backward's pair
term as ``g = -alpha (e r) r``, so that ``ds_k = sum_j g_kj (u_k [t_kj >
eps] - u_j [t_jk > eps])`` is a row-local sum: one exponential an ordered
pair.
"""

from __future__ import annotations

import ctypes

import torch

from allrank_tpu_torch.ops import _build

# the kernel's envelope, the encoder's cap (models/transformer.py): a
# slate's compacted scores and cotangents, 64 KB of shared memory at 8192
MAX_LENGTH = 8192
_SIGNATURES = {
    "approx_pos_fwd": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    + [ctypes.c_float] * 2 + [ctypes.c_void_p],
    "approx_pos_bwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    + [ctypes.c_float] * 2 + [ctypes.c_void_p],
    "approx_rcp_check": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]}


def _pair_chain(s, valid, alpha):
    """(t, pv) on [B, L, L]: the TPU kernel's ``_pair_chain``."""
    n = s.shape[1]
    pv = (valid[:, :, None] > 0.5) & (valid[:, None, :] > 0.5)
    pv = pv & ~torch.eye(n, dtype=torch.bool, device=s.device)
    d = torch.where(pv, s[:, :, None] - s[:, None, :], 0.0)
    return torch.sigmoid(-alpha * d), pv


def _check(s, valid):
    if s.dim() != 2:
        raise ValueError(f"inputs must be [B, L], got {tuple(s.shape)}")
    _build.require(valid, "valid", s.shape, torch.float32, s.device)
    if s.dtype != torch.float32:
        raise TypeError(f"y_pred_sorted must be float32, got {s.dtype}")


def approx_pos_fwd_plain(s, valid, alpha, eps):
    """Rank sums [B, L] in plain PyTorch ops."""
    _check(s, valid)
    t, pv = _pair_chain(s, valid, alpha)
    return (pv.float() * torch.clamp(t, min=eps)).sum(dim=2)


def approx_pos_bwd_plain(s, valid, u, alpha, eps):
    """ds [B, L] for the rank sums' cotangent ``u`` [B, L], in plain PyTorch
    ops (the TPU kernel's ``_bwd_kernel``)."""
    _check(s, valid)
    t, pv = _pair_chain(s, valid, alpha)
    tprime = torch.where(t > eps, -alpha * t * (1.0 - t), 0.0)
    c = u[:, :, None] * pv.float() * tprime
    return c.sum(dim=2) - c.sum(dim=1)


def _launch(name, s, valid, extra, out, alpha, eps):
    b, n = s.shape
    if n > MAX_LENGTH:
        raise NotImplementedError(
            f"the approxNDCG rank-sum kernel covers L <= {MAX_LENGTH}, got "
            f"{n}")
    dev = s.device
    for t_name, t in (("y_pred_sorted", s), ("valid", valid), *extra):
        _build.require(t, t_name, (b, n), torch.float32, dev)
    lib = _build.load("approx_pos", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = getattr(lib, name)(
            *map(_build.ptr, (s, valid, *(t for _, t in extra), out)), b, n,
            float(alpha), float(eps), _build.stream_of(s))
    _build.check_launch(lib, rc, name)


def approx_pos_fwd(s, valid, alpha, eps):
    """Rank sums [B, L]. A CPU tensor takes the plain version; a CUDA tensor
    launches the forward kernel or raises."""
    if s.device.type == "cpu":
        return approx_pos_fwd_plain(s, valid, alpha, eps)
    if s.device.type != "cuda":
        raise ValueError(f"no approxNDCG rank sum for device {s.device}")
    _check(s, valid)
    pos = torch.empty_like(s)
    if s.numel():
        _launch("approx_pos_fwd", s, valid, (), pos, alpha, eps)
        approx_pos_fwd.launches += 1
    return pos


approx_pos_fwd.launches = 0


def approx_pos_bwd(s, valid, u, alpha, eps):
    """ds [B, L]. A CPU tensor takes the plain version; a CUDA tensor
    launches the backward kernel or raises."""
    if s.device.type == "cpu":
        return approx_pos_bwd_plain(s, valid, u, alpha, eps)
    if s.device.type != "cuda":
        raise ValueError(f"no approxNDCG rank sum for device {s.device}")
    _check(s, valid)
    ds = torch.empty_like(s)
    if s.numel():
        _launch("approx_pos_bwd", s, valid, (("u", u),), ds, alpha, eps)
        approx_pos_bwd.launches += 1
    return ds


approx_pos_bwd.launches = 0


def reciprocal_mismatches(device) -> int:
    """How many floats y of [1, 2] the kernels' reciprocal of 1 + e (the
    instructions of ``__frcp_rn`` without its slow path) gives other bits
    than ``__frcp_rn`` for, checked on the CUDA ``device``: 0 shows it
    correctly rounded."""
    blocks = -(-((1 << 23) + 1) // 256)
    counts = torch.empty(blocks, dtype=torch.int32, device=device)
    lib = _build.load("approx_pos", _SIGNATURES)
    with torch.cuda.device(counts.device):
        rc = lib.approx_rcp_check(_build.ptr(counts), blocks,
                                  _build.stream_of(counts))
    _build.check_launch(lib, rc, "approx_rcp_check")
    return int(counts.sum().item())


class ApproxPos(torch.autograd.Function):
    """The rank sums under autograd; gradients flow to the scores only."""

    @staticmethod
    def forward(ctx, s, valid, alpha, eps):
        ctx.save_for_backward(s, valid)
        ctx.alpha, ctx.eps = alpha, eps
        return approx_pos_fwd(s, valid, alpha, eps)

    @staticmethod
    def backward(ctx, u):
        s, valid = ctx.saved_tensors
        ds = approx_pos_bwd(s, valid, u.float().contiguous(), ctx.alpha,
                            ctx.eps)
        return ds, None, None, None


def fused_approx_pos(y_pred_sorted, valid, *, alpha: float, eps: float):
    """Masked sigmoid rank sums [B, L]; inputs [B, L] (``valid`` as 0/1
    floats), cast to fp32. On CUDA, L above ``MAX_LENGTH`` raises
    ``NotImplementedError``."""
    return ApproxPos.apply(y_pred_sorted.float().contiguous(),
                           valid.float().contiguous(), float(alpha),
                           float(eps))
