"""``ops/ffn_block.gate_flips``: the ReLU gates that another backward of
the FFN sublayer took the other way, found from its dx, and their replay in
``ffn_sublayer_bwd_plain`` (``flip``). On the card phase 7 of
``chip_smoke.py`` and ``tests/test_torch_gpu.py`` hold B2's backward
kernel against the plain version with those gates replayed (ROADMAP Queue
C5); here a plain backward with known flips stands in for the kernel."""

import pytest
import torch

from allrank_tpu_torch.ops.ffn_block import (
    _bwd_parts,
    ffn_sublayer_bwd_plain,
    gate_flips,
)

B, L, D, D_FF = 3, 9, 16, 32
SEEDS = (5, 6)
# (batch, row, unit) of the units put at their kink, one a row
KINKS = [(0, 1, 3), (1, 4, 7), (2, 8, 30)]


def _inputs(dtype, seed=1):
    gen = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    params = [1 + r(D, scale=0.1), r(D, scale=0.1),
              r(D, D_FF, scale=D ** -0.5), r(D_FF, scale=0.1),
              r(D_FF, D, scale=D_FF ** -0.5), r(D, scale=0.1)]
    return r(B, L, D).to(dtype), params, r(B, L, D).to(dtype)


def _at_kinks(x, params, dy, p):
    """Moves b1 so that each of ``KINKS``' units sits at its ReLU kink in
    its row; returns the kept ones as a flip mask."""
    pre = _bwd_parts(x, *params[:5], dy, p, p, SEEDS)[2]
    for i, j, k in KINKS:
        params[3][k] -= pre[i, j, k]
    dh = _bwd_parts(x, *params[:5], dy, p, p, SEEDS)[5]
    flip = torch.zeros(B, L, D_FF, dtype=torch.bool)
    for i, j, k in KINKS:
        flip[i, j, k] = bool(dh[i, j, k] != 0.0)
    return flip


@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_flips_finds_the_flipped_gates(dtype, p):
    x, params, dy = _inputs(dtype)
    want = _at_kinks(x, params, dy, p)
    assert want.any()
    other = ffn_sublayer_bwd_plain(x, *params, dy, p, p, SEEDS, flip=want)
    # the rows differ by nothing else: every flip is searched for
    got = gate_flips(other[0], x, *params, dy, p, p, SEEDS, rtol=1e-6)
    assert torch.equal(got, want)
    replayed = ffn_sublayer_bwd_plain(x, *params, dy, p, p, SEEDS, flip=got)
    assert all(torch.equal(a, b) for a, b in zip(replayed, other))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_no_flips_without_a_difference(dtype):
    x, params, dy = _inputs(dtype, seed=2)
    ref = ffn_sublayer_bwd_plain(x, *params, dy, 0.3, 0.3, SEEDS)
    flip = gate_flips(ref[0], x, *params, dy, 0.3, 0.3, SEEDS)
    assert not flip.any()
    again = ffn_sublayer_bwd_plain(x, *params, dy, 0.3, 0.3, SEEDS, flip=flip)
    assert all(torch.equal(a, b) for a, b in zip(again, ref))
