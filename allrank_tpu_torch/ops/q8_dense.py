"""The int8 dense layer of the quantized serving tower (X1): quantize the
activation, multiply int8 by int8 into int32, dequantize, add the bias. The
CUDA kernel of ``csrc/q8_dense.cu`` for CUDA tensors and its plain PyTorch
version, of the same signature, for CPU tensors.

Replaces the TPU kernel ``fused_q8_dense`` of the JAX package's
``tools/exp_int8_matmul_kernel.py`` (``pallas_call`` at line 50), the fused
form of ``quant.q_dense_apply``'s static mode there (``quant.py:93-107``);
its dynamic mode (``quant.py:108-116``, left to XLA there) takes the same
kernel with a per-row scale. ``x`` is ``[..., K]`` fp32 or bf16, ``w_t``
the int8 weights transposed, ``[N, K]`` (``quantize_model`` makes it once
from the JAX layout ``w_q [K, N]``), ``scale`` and ``b`` ``[N]`` fp32:

- static (``x_inv_scale`` given, one value or ``[K]``): ``x_q =
  int8(clip(round(x * x_inv_scale), +-127))``, ``y = acc * scale + b`` with
  ``scale`` the layer's ``out_scale``, in x's dtype;
- dynamic: ``xs = max(rowwise max |x|, 1e-30) / 127`` in PyTorch ops (as
  JAX computes it outside any kernel), ``x_q = int8(clip(round(x / xs),
  +-127))`` by IEEE division, ``y = ((acc * xs) * scale) + b`` with
  ``scale`` the layer's ``w_scale``, in fp32 whatever x is (quant.py's
  behaviour, kept).

Rounding is half to even; every product and sum of the epilogue is rounded
on its own, as quant.py's chain, so kernel, plain version and the JAX
package agree bit for bit. The int32 sums are exact while ``127^2 K <
2^31``: K <= ``MAX_K``.

On the card a block owns ``ROWS`` rows of x across all of N and holds their
quantized values for up to ``SLAB`` of K (``tile_plan``); a wider K splits
into slabs whose int32 sums meet in an [M, N] scratch of zeros that this
wrapper allocates.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from allrank_tpu_torch.ops import _build

QMAX = 127.0
TINY = 1e-30  # absmax floor: an all-zero row quantizes to zeros, not NaN
MAX_K = 133_144  # 127^2 * K < 2^31
DTYPES = (torch.float32, torch.bfloat16)
# csrc/q8_dense.cu's block: kQRows rows of x, the weight staged in groups
# of kQCols columns, at most kQSlab of K held, kQShared bytes of shared
# memory aimed at
ROWS, COLS, SLAB, SHARED = 64, 64, 1024, 112 * 1024
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"q8_dense": [_P, _P, _P, _I, _P, _P, _P, _P, _P] + [_I] * 5
               + [_P]}


def tile_plan(m: int, k: int, n: int) -> dict:
    """The kernel's grid for x [m, k] and w_t [n, k]: row tiles of
    ``ROWS`` rows across all of N, K slabs of at most ``SLAB`` (more than
    one needs the int32 scratch), the weight columns staged at once (the
    most ``COLS``-column groups that fit beside the x tile in ``SHARED``
    bytes, at least one) and the block's shared-memory bytes."""
    if m < 1 or not 1 <= k <= MAX_K or n < 1:
        raise ValueError(f"no tile plan for ({m}, {k}, {n})")
    pitch = -(-min(k, SLAB) // 32) * 32 + 16
    fit = (SHARED - ROWS * pitch) // pitch // COLS
    cols = min(max(fit, 1), -(-n // COLS)) * COLS
    slabs = -(-k // SLAB)
    return {"row_tiles": -(-m // ROWS), "slabs": slabs,
            "weight_columns": cols, "shared_bytes": (ROWS + cols) * pitch,
            "scratch": slabs > 1}


def _check(x, w_t, scale, b, x_inv_scale):
    """Validates the arguments; returns (x as [M, K], N)."""
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w_t.dim() != 2:
        raise ValueError(f"w_t must be [N, K], got {tuple(w_t.shape)}")
    n, k = w_t.shape
    if x.dim() < 1 or x.shape[-1] != k:
        raise ValueError(f"x must be [..., {k}], got {tuple(x.shape)}")
    if not 1 <= k <= MAX_K:
        raise NotImplementedError(
            f"int8 dense covers 1 <= K <= {MAX_K} (exact int32 sums), got "
            f"{k}")
    _build.require(w_t, "w_t", (n, k), torch.int8, x.device)
    _build.require(scale, "scale", (n,), torch.float32, x.device)
    _build.require(b, "b", (n,), torch.float32, x.device)
    if x_inv_scale is not None and tuple(x_inv_scale.shape) not in ((), (k,)):
        raise ValueError(f"x_inv_scale must be one value or [{k}], got "
                         f"{tuple(x_inv_scale.shape)}")
    if x_inv_scale is not None:
        _build.require(x_inv_scale, "x_inv_scale", x_inv_scale.shape,
                       torch.float32, x.device)
    return x.reshape(-1, k), n


def row_scales(x2d: torch.Tensor) -> torch.Tensor:
    """The dynamic mode's per-row scale [M] fp32: max(max |x|, 1e-30) /
    127, in PyTorch ops. The divisor is a tensor on x's device: CUDA
    divides by a Python number as a multiply by its reciprocal."""
    absmax = torch.clamp_min(x2d.float().abs().amax(dim=-1), TINY)
    return absmax / absmax.new_full((), QMAX)


def quantize_rows(x2d: torch.Tensor, x_inv_scale: Optional[torch.Tensor] = None,
                  xs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_q [M, K] int8: ``x * x_inv_scale`` (static) or ``x / xs`` per row
    (dynamic), rounded half to even, clipped to +-127."""
    xf = x2d.float()
    v = xf * x_inv_scale if x_inv_scale is not None else xf / xs[:, None]
    return torch.clamp(torch.round(v), -QMAX, QMAX).to(torch.int8)


def int8_product(x_q: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """acc [M, N] int32 = x_q . w_t^T, through a float64 product: exact for
    |acc| < 2^53 (``torch.matmul`` has no int32 product on CUDA)."""
    return (x_q.double() @ w_t.double().t()).to(torch.int32)


def q8_dense_plain(x, w_t, scale, b, x_inv_scale=None):
    """The kernel's function in PyTorch ops, each rounding on its own."""
    x2d, n = _check(x, w_t, scale, b, x_inv_scale)
    out_shape = (*x.shape[:-1], n)
    if x_inv_scale is not None:
        acc = int8_product(quantize_rows(x2d, x_inv_scale=x_inv_scale), w_t)
        return (acc.float() * scale + b).to(x.dtype).reshape(out_shape)
    xs = row_scales(x2d)
    acc = int8_product(quantize_rows(x2d, xs=xs), w_t)
    return (acc.float() * xs[:, None] * scale + b).reshape(out_shape)


def q8_dense(x, w_t, scale, b, x_inv_scale=None):
    """``y [..., N]``: static with ``x_inv_scale``, else dynamic (see the
    module). A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises."""
    if x.device.type == "cpu":
        return q8_dense_plain(x, w_t, scale, b, x_inv_scale)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 dense for device {x.device}")
    x2d, n = _check(x, w_t, scale, b, x_inv_scale)
    x2d = x2d.contiguous()
    m, k = x2d.shape
    static = x_inv_scale is not None
    out_dtype = x.dtype if static else torch.float32
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return y.reshape(*x.shape[:-1], n)
    xs = None if static else row_scales(x2d)
    acc = (torch.zeros((m, n), dtype=torch.int32, device=x.device)
           if tile_plan(m, k, n)["scratch"] else None)
    lib = _build.load("q8_dense", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.q8_dense(
            _build.ptr(x2d), _build.ptr(w_t),
            _build.ptr(x_inv_scale) if static else None,
            int(static and x_inv_scale.dim() == 1),
            None if static else _build.ptr(xs), _build.ptr(scale),
            _build.ptr(b), _build.ptr(y),
            None if acc is None else _build.ptr(acc), m, k, n,
            int(x.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), _build.stream_of(x))
    _build.check_launch(lib, rc, "q8_dense")
    q8_dense.launches += 1
    return y.reshape(*x.shape[:-1], n)


q8_dense.launches = 0
