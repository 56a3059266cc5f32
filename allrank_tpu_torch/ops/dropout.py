"""Counter-based dropout masks shared by the sublayer kernels and their
plain versions (the device half is ``csrc/dropout.cuh``).

Replaces the TPU's on-core generator (``pltpu.prng_seed`` /
``prng_random_bits`` and ``_dropout_keep`` in the JAX package's
``ops/attention_pallas.py:71-75``). A GPU cannot reproduce the TPU's bits,
so the port keys its own: the keep bit of element ``i`` of stream ``s``
under seed ``k`` is a pure function of ``(k, s, i)``, where ``i`` is the
element's index in the whole logical tensor (for the attention
probabilities ``((b * h + head) * L + q) * L + key``). A mask therefore
does not depend on tiles, block sizes or launch order, the backward replays
the forward's mask bit for bit, and a slice of a mask is the mask of the
slice's indices.

The bits are a keyed murmur3 finaliser over uint32::

    bits(i) = fmix32(((fmix32(lo(i) ^ k0) ^ hi(i)) + k1)

kept iff ``bits >= uint32(p * (2**32 - 1))`` (the TPU kernels' threshold)
and scaled by ``1 / (1 - p)``. Here every uint32 product is done in int64
tensors with one factor split into 16-bit halves, so no intermediate
leaves int64's range and the CPU and the card give identical bits.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

M32 = 0xFFFFFFFF
_FMIX_MULS = (0x85EBCA6B, 0xC2B2AE35)
_GOLDEN = 0x9E3779B9
_K1_SALT = 0x6A09E667

# the streams of the sublayers: one stream id per tensor a mask covers
ATTN_PROBS, ATTN_RESID, FFN_HIDDEN, FFN_RESID = 0, 1, 2, 3


def check_rate(p: float) -> float:
    p = float(p)
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {p}")
    return p


def threshold(p: float) -> int:
    """The uint32 keep threshold of rate ``p``, as the TPU kernels take it."""
    return int(check_rate(p) * (2 ** 32 - 1))


def _fmix_int(x: int) -> int:
    m1, m2 = _FMIX_MULS
    x ^= x >> 16
    x = (x * m1) & M32
    x ^= x >> 13
    x = (x * m2) & M32
    return x ^ (x >> 16)


def stream_key(seed: int, stream: int) -> Tuple[int, int]:
    """The two uint32 key words of ``(seed, stream)`` (Python ints)."""
    k0 = _fmix_int((int(seed) & M32) ^ ((_GOLDEN * (int(stream) + 1)) & M32))
    return k0, _fmix_int(k0 ^ _K1_SALT)


def kernel_keys(seed: int, stream: int, p: float) -> list:
    """``[k0, k1, threshold]``, the host array a kernel launch reads."""
    return [*stream_key(seed, stream), threshold(p)]


def key_array(*streams) -> ctypes.Array:
    """A ctypes uint32 array of several streams' ``kernel_keys``."""
    flat = [k for s in streams for k in s]
    return (ctypes.c_uint32 * len(flat))(*flat)


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x * m mod 2**32`` for int64 ``x`` in [0, 2**32): each partial
    product stays below 2**48."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _fmix(x: torch.Tensor) -> torch.Tensor:
    m1, m2 = _FMIX_MULS
    x = x ^ (x >> 16)
    x = _mul32(x, m1)
    x = x ^ (x >> 13)
    x = _mul32(x, m2)
    return x ^ (x >> 16)


def random_bits(seed: int, stream: int, index: torch.Tensor) -> torch.Tensor:
    """uint32 bits (as int64) of the elements at ``index`` (int64, >= 0)."""
    k0, k1 = stream_key(seed, stream)
    x = _fmix((index & M32) ^ k0)
    return _fmix(((x ^ (index >> 32)) + k1) & M32)


def keep_mask(seed: int, stream: int, p: float, shape,
              device=None) -> torch.Tensor:
    """The bool keep mask of a whole logical tensor of ``shape`` (row-major
    element indices)."""
    n = 1
    for s in shape:
        n *= int(s)
    index = torch.arange(n, dtype=torch.int64, device=device)
    return (random_bits(seed, stream, index) >= threshold(p)).reshape(
        tuple(shape))
