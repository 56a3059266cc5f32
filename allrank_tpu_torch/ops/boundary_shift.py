"""The two synthetic kernels of the boundary-shift probe (X2), bf16:
the CUDA kernels of ``csrc/boundary_shift_mma.cu`` (on B2's tensor-core
tile bodies) for CUDA tensors and their plain PyTorch versions for CPU
tensors.

Replaces the TPU kernel ``make_calls`` of the JAX package's
``tools/exp_boundary_shift.py:87`` (``pallas_call`` at lines 95 and 102)::

    plain:   y = x + relu(LN(x) . W1) . W2
    shifted: out = x + relu(pre) . W2,  pre_out = LN(out) . W1'

with LN the unbiased-std LayerNorm without gain or bias
(``(v - mean) / (sqrt(max(var, 1e-24)) + 1e-6)``), its output and the ReLU
output rounded to bf16 before each product, every product accumulated in
fp32, the residual added in fp32; the shifted kernel normalises the fp32
residual sum. ``x`` is ``[..., d]`` with d <= 256, ``pre`` ``[..., d3]``,
``W1`` ``[d, d3]``, ``W2`` ``[d3, d]``, all bf16, any d3 and any number of
rows. The plain kernel is B2's bf16 forward (``ops/ffn_block.py``) at unit
LN gain and zero biases; both kernels read the weights as B2's rounded
scratch, zero-padded to whole 16-row and 64-column steps (``W1`` and
``W2`` themselves where d % 16 == 0 and d3 % 64 == 0). The probe CLI is
``allrank_tpu_torch.tools.exp_boundary_shift``.
"""

from __future__ import annotations

import ctypes

import torch

from allrank_tpu_torch.ops import _build

MAX_WIDTH = 256  # a warp keeps [16, 128] of the output in registers
_P = ctypes.c_void_p
_SIGNATURES = {"boundary_fwd_mma": [_P] * 8 + [ctypes.c_int] * 3 + [_P]}


def _ln(v32):
    d = v32.shape[-1]
    mean = v32.mean(dim=-1, keepdim=True)
    c = v32 - mean
    var = (c * c).sum(dim=-1, keepdim=True) / max(d - 1, 1)
    return c / (torch.sqrt(torch.clamp(var, min=1e-24)) + 1e-6)


def boundary_plain_plain(x, w1, w2):
    """The plain kernel's function in plain PyTorch ops."""
    x32 = x.float()
    n = _ln(x32).to(x.dtype).float()
    h = torch.relu(n @ w1.float()).to(x.dtype).float()
    return (x32 + h @ w2.float()).to(x.dtype)


def boundary_shift_plain(x, pre, w2, w1n):
    """The shifted kernel's function in plain PyTorch ops: ``(out,
    pre_out)``."""
    x32 = x.float()
    h = torch.relu(pre.float()).to(x.dtype).float()
    out32 = x32 + h @ w2.float()
    n = _ln(out32).to(x.dtype).float()
    return out32.to(x.dtype), (n @ w1n.float()).to(x.dtype)


def _check(x, pre, w1, w2):
    """Validates the arguments; returns (M, d, d3)."""
    if x.dim() < 1:
        raise ValueError(f"x must be [..., d], got {tuple(x.shape)}")
    d = x.shape[-1]
    if w1.dim() != 2 or w1.shape[0] != d:
        raise ValueError(f"W1 must be [{d}, d3], got {tuple(w1.shape)}")
    d3 = w1.shape[1]
    m = x.numel() // max(d, 1)
    if not 1 <= d <= MAX_WIDTH or d3 < 1 or m < 1:
        raise NotImplementedError(
            f"the boundary kernels cover 1 <= d <= {MAX_WIDTH}, d3 >= 1 and "
            f"at least one row, got d={d}, d3={d3}, {m} rows")
    dev = x.device
    _build.require(x, "x", tuple(x.shape), torch.bfloat16, dev)
    _build.require(w1, "W1", (d, d3), torch.bfloat16, dev)
    _build.require(w2, "W2", (d3, d), torch.bfloat16, dev)
    if pre is not None:
        _build.require(pre, "pre", tuple(x.shape[:-1]) + (d3,),
                       torch.bfloat16, dev)
    return m, d, d3


def _padded(w, rows: int, cols: int):
    """``w`` as a contiguous [rows, cols] bf16 matrix on 16-byte aligned
    storage, zero past its own shape: ``w`` itself where it already is."""
    if (tuple(w.shape) == (rows, cols) and w.is_contiguous()
            and w.data_ptr() % 16 == 0):
        return w
    out = torch.zeros((rows, cols), dtype=w.dtype, device=w.device)
    out[:w.shape[0], :w.shape[1]] = w
    return out


def _launch(x, pre, w1, w2, shifted):
    m, d, d3 = _check(x, pre, w1, w2)
    dpad, ffp = -(-d // 16) * 16, -(-d3 // 64) * 64
    w1b, w2b = _padded(w1, dpad, ffp), _padded(w2, ffp, dpad)
    # B2's LN gain and biases, which only the plain kernel reads
    unit = (None, None)
    if not shifted:
        unit = (torch.ones(d, device=x.device),
                torch.zeros(max(d, d3), device=x.device))
    y = torch.empty_like(x)
    pre_out = (torch.empty(tuple(x.shape[:-1]) + (d3,), dtype=x.dtype,
                           device=x.device) if shifted else None)
    lib = _build.load("boundary_shift_mma", _SIGNATURES)
    with torch.cuda.device(x.device):
        rc = lib.boundary_fwd_mma(
            _build.ptr(x), _build.ptr(pre) if shifted else None,
            _build.ptr(w1b), _build.ptr(w2b),
            *(None if u is None else _build.ptr(u) for u in unit),
            _build.ptr(y),
            _build.ptr(pre_out) if shifted else None, m, d, d3,
            _build.stream_of(x))
    _build.check_launch(lib, rc, "boundary_fwd_mma")
    return y, pre_out


def _device(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no boundary kernel for device {x.device}")
    return x.device.type


def boundary_plain(x, w1, w2):
    """``x + relu(LN(x) W1) W2``. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    if _device(x) == "cpu":
        _check(x, None, w1, w2)
        return boundary_plain_plain(x, w1, w2)
    y, _ = _launch(x, None, w1, w2, shifted=False)
    boundary_plain.launches += 1
    return y


boundary_plain.launches = 0


def boundary_shift(x, pre, w2, w1n):
    """``(x + relu(pre) W2, LN(that) W1')``, the JAX kernel's argument
    order. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if _device(x) == "cpu":
        _check(x, pre, w1n, w2)
        return boundary_shift_plain(x, pre, w2, w1n)
    out = _launch(x, pre, w1n, w2, shifted=True)
    boundary_shift.launches += 1
    return out


boundary_shift.launches = 0
