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


def _step_grads(p, flip=None, scale=0.5):
    """One block's FFN gradients as a train step keeps them (named as the
    encoder's parameters, scaled as a global-norm clip scales them), with
    ``flip``'s gates replayed, beside one gradient of another layer."""
    x, params, dy = _inputs(torch.float32, seed=3)
    want = _at_kinks(x, params, dy, p)
    grads = ffn_sublayer_bwd_plain(x, *params, dy, p, p, SEEDS, flip=flip)
    pre = "transformer.layers.0."
    named = {pre + "ff1.b": grads[4], pre + "ff1.w": grads[3],
             pre + "ff2.w": grads[5], "other": grads[6]}
    call = {"args": [x, *params], "rates": (p, p, SEEDS), "dy": dy}
    gates = (_bwd_parts(x, *params[:5], dy, p, p, SEEDS)[2] > 0).reshape(
        -1, D_FF)
    return ({k: v * scale for k, v in named.items()}, want, call,
            (gates,), torch.ones(B * L, dtype=torch.bool))


@pytest.mark.parametrize("p", [0.0, 0.3])
def test_step_rule_replays_the_kernels_own_gate_flips(p):
    """``chip_smoke.step_grad_rule``: a GPU step whose FFN kernel took the
    gates at the kinks the other way passes once they are replayed, and
    the units count as replayed, not held out."""
    import chip_smoke

    cg, want, call, gates, valid = _step_grads(p)
    gg = _step_grads(p, flip=want)[0]
    units = int(want.reshape(-1, D_FF).any(dim=0).sum())
    assert units
    with pytest.raises(AssertionError):
        chip_smoke.step_grad_rule(gg, cg)
    worst, flips = chip_smoke.step_grad_rule(gg, cg, None, (gates, gates),
                                             [call], valid)
    assert flips == [(0, units)] and worst < 0.5


@pytest.mark.parametrize("fault", ["w1_column", "b1_off_kink", "no_call"])
def test_step_rule_fails_a_fault_that_is_no_gate_flip(fault):
    """A miss in a flipped unit's W1 column, or a b1 miss at a unit with
    no pre-activation near its kink, or one with no CPU call to replay,
    breaks the rule however few units it touches."""
    import chip_smoke

    cg, want, call, gates, valid = _step_grads(0.0)
    gg = _step_grads(0.0, flip=want)[0]
    pre = "transformer.layers.0."
    unit = KINKS[0][2]
    if fault == "w1_column":
        gg[pre + "ff1.w"][:, unit] *= 1.01
    elif fault == "b1_off_kink":
        gg = dict(cg)
        far = next(j for j in range(D_FF) if j not in
                   {k for _, _, k in KINKS})
        gg[pre + "ff1.b"] = cg[pre + "ff1.b"].clone()
        gg[pre + "ff1.b"][far] += 0.1 * cg[pre + "ff1.b"].abs().max()
    with pytest.raises(AssertionError):
        chip_smoke.step_grad_rule(gg, cg, None, (gates, gates),
                                  [] if fault == "no_call" else [call],
                                  valid)
