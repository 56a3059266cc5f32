"""B2's routes of kernels (allrank_tpu_torch/ops/ffn_block.py): the
pure-Python choice between the tensor-core kernels in bf16
(csrc/ffn_block_mma.cu) and in fp32 as 3xTF32 split products
(csrc/ffn_block_tf32x3.cu), made from dtype, d and d_ff alone before any
launch; the plain bf16 forward and backward,
which the card holds both routes to, against the JAX package's TPU kernel
in Pallas interpret mode at one width of each padding class the tensor-core
kernels take (d a multiple of 16 or not, d < 16; d_ff a multiple of 64 or
not), L in {1, 65}, with a slate of zero rows (a padded slate's LayerNorm
at its variance floor) and a last 64-row block that the rows do not fill;
and ``gate_flips`` on a constructed near-zero pre-activation in bf16.

On the CPU the wrappers take the plain versions; tests/test_torch_gpu.py
holds every tensor-core instantiation against them on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from allrank_tpu.ops.ffn_block import ffn_sublayer
from allrank_tpu_torch.models.core import std_layer_norm
from allrank_tpu_torch.ops.ffn_block import (
    MAX_FF,
    ffn_sublayer_bwd,
    ffn_sublayer_bwd_plain,
    ffn_sublayer_fwd,
    gate_flips,
    route,
)

torch.set_num_threads(2)

BF16 = torch.bfloat16
GRADS = ("dx", "dg", "db", "dw1", "db1", "dw2", "db2")


# ----------------------------------------------------------------------------
# the route


@pytest.mark.parametrize("d_ff", [384, 512, 1024])
@pytest.mark.parametrize("d", [32, 96, 128, 144, 256])
def test_bf16_takes_the_tensor_cores_and_fp32_3xtf32(d, d_ff):
    """Every width of the envelope: bf16 on the tensor cores, fp32 on them
    as 3xTF32 split products (fp32's parity; no width falls back to the
    SIMT units)."""
    assert route(BF16, d, d_ff) == "mma"
    assert route(torch.float32, d, d_ff) == "tf32x3"


@pytest.mark.parametrize("dtype,d,d_ff,match", [
    (torch.float16, 128, 512, "float32 or bfloat16"),
    (torch.float64, 128, 512, "float32 or bfloat16"),
    (BF16, 257, 512, "d_model <= 256"),
    (BF16, 0, 512, "d_model <= 256"),
    (BF16, 128, MAX_FF + 1, "d_ff <= 1024"),
    (torch.float32, 128, 0, "d_ff <= 1024"),
])
def test_outside_the_envelope_raises_before_any_launch(dtype, d, d_ff, match):
    with pytest.raises(NotImplementedError, match=match):
        route(dtype, d, d_ff)


def test_the_route_reads_no_tensor_and_counts_nothing():
    """The choice is a function of (dtype, d, d_ff): the same answer every
    time, and no launch counted for asking."""
    fwd = dict(ffn_sublayer_fwd.route_launches)
    bwd = dict(ffn_sublayer_bwd.route_launches)
    totals = (ffn_sublayer_fwd.launches, ffn_sublayer_bwd.launches)
    answers = {route(BF16, 128, 512) for _ in range(3)}
    assert answers == {"mma"}
    assert ffn_sublayer_fwd.route_launches == fwd
    assert ffn_sublayer_bwd.route_launches == bwd
    assert (ffn_sublayer_fwd.launches, ffn_sublayer_bwd.launches) == totals
    assert set(fwd) == set(bwd) == {"mma", "tf32x3", "simt"}


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    x, _, params = _inputs(16, 40, 5, seed=0)
    totals = (ffn_sublayer_fwd.launches, ffn_sublayer_bwd.launches)
    y = ffn_sublayer_fwd(torch.tensor(x).to(BF16), *map(torch.tensor, params))
    assert y.dtype == BF16 and torch.isfinite(y.float()).all()
    assert (ffn_sublayer_fwd.launches, ffn_sublayer_bwd.launches) == totals


# ----------------------------------------------------------------------------
# the plain bf16 versions against the TPU kernel, at the padding classes of
# the tensor-core kernels


def _inputs(d, d_ff, l, seed, zero_slate=True):
    """x and dy [3, L, d]: with ``zero_slate`` slate 2 all zeros (a padded
    slate); 3 L rows leave the last 64-row block of the kernels part
    empty."""
    rng = np.random.RandomState(seed)
    x = rng.randn(3, l, d).astype(np.float32)
    if zero_slate:
        x[2] = 0.0
    dy = rng.randn(3, l, d).astype(np.float32)
    params = [(1.0 + 0.1 * rng.randn(d)).astype(np.float32),
              (0.1 * rng.randn(d)).astype(np.float32),
              (rng.randn(d, d_ff) / np.sqrt(d)).astype(np.float32),
              (0.1 * rng.randn(d_ff)).astype(np.float32),
              (rng.randn(d_ff, d) / np.sqrt(d_ff)).astype(np.float32),
              (0.1 * rng.randn(d)).astype(np.float32)]
    return x, dy, params


# (d, d_ff): both whole steps (16-column and 64-unit); d padded 40 -> 48 and
# d_ff 100 -> 128; d < 16 (padded to 16) with d_ff 72 -> 128
WIDTHS = [(64, 128), (40, 100), (8, 72)]


@pytest.mark.parametrize("l", [1, 65])
@pytest.mark.parametrize("d,d_ff", WIDTHS)
def test_bf16_forward_plain_matches_tpu_kernel(d, d_ff, l):
    """The same rounding points as the TPU kernel (the LN output, the
    hidden activation): at most one or two bf16 ulps where an fp32 sum lands
    on the other side of a rounding edge, 2^-6 relative and absolute
    (phase 3's kernel tolerance)."""
    x, _, params = _inputs(d, d_ff, l, seed=d + d_ff + l)
    with pltpu.force_tpu_interpret_mode():
        ref = ffn_sublayer(jnp.asarray(x, jnp.bfloat16),
                           *map(jnp.asarray, params),
                           jnp.zeros(2, jnp.int32), 0.0, 0.0)
    got = ffn_sublayer_fwd(torch.tensor(x).to(BF16),
                           *map(torch.tensor, params))
    assert got.dtype == BF16 and got.shape == (3, l, d)
    assert torch.isfinite(got.float()).all()  # the zero slate too
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2 ** -6, atol=2 ** -6)


@pytest.mark.parametrize("l", [1, 65])
@pytest.mark.parametrize("d,d_ff", WIDTHS)
def test_bf16_backward_plain_matches_tpu_kernel_vjp(d, d_ff, l):
    """dx and the six parameter gradients, each within 2^-5 of its largest
    value (phase 7's kernel tolerance): the same rounding points (dout, dh),
    where an fp32 sum on the other side of a rounding edge moves one bf16
    intermediate by an ulp and every weight gradient summed over it a
    little."""
    x, dy, params = _inputs(d, d_ff, l, seed=2 * d + d_ff + l)

    def f(x, *p):
        return ffn_sublayer(x, *p, jnp.zeros(2, jnp.int32), 0.0, 0.0)

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, jnp.asarray(x, jnp.bfloat16),
                         *map(jnp.asarray, params))
        ref = vjp(jnp.asarray(dy, jnp.bfloat16))
    got = ffn_sublayer_bwd(torch.tensor(x).to(BF16),
                           *map(torch.tensor, params),
                           torch.tensor(dy).to(BF16))
    assert got[0].dtype == BF16
    for name, g, r in zip(GRADS, got, ref):
        g = g.float().numpy()
        r = np.asarray(r.astype(jnp.float32))
        assert g.shape == r.shape, name
        assert np.isfinite(g).all(), name
        # dx slate by slate: the zero slate's LayerNorm backward divides by
        # its floored std (1e-6) and would set the scale of the others
        for i, (gi, ri) in enumerate(zip(g, r) if name == "dx" else [(g, r)]):
            scale = float(np.abs(ri).max())
            err = float(np.abs(gi - ri).max())
            assert err <= 2 ** -5 * scale + 1e-6, (name, i, err, scale)


# ----------------------------------------------------------------------------
# the gate-flip replay


def test_gate_flips_finds_a_constructed_flip_in_bf16():
    """A hidden unit whose pre-activation is put within rounding of 0 (by
    its bias) gates either way in two sums of the same terms. A backward
    that took that one gate the other way (the plain version with ``flip``)
    differs from the plain one in that row's dx by more than the tolerance,
    and ``gate_flips`` names exactly that unit; replayed, the two agree
    bit for bit."""
    d, d_ff, l = 32, 64, 9
    x, dy, params = _inputs(d, d_ff, l, seed=3, zero_slate=False)
    xt, dyt = torch.tensor(x).to(BF16), torch.tensor(dy).to(BF16)
    pt = list(map(torch.tensor, params))
    # the bf16 LN output and weights, as the backward's pre-activation
    n = std_layer_norm(xt.float(), pt[0], pt[1]).to(BF16).float()
    w1c = pt[2].to(BF16).float()
    w2c = pt[4].to(BF16).float()
    dh = dyt.float() @ w2c.t()
    row, slate = 4, 1
    # the kept unit of that row whose dh is largest moves dx the most
    unit = int(dh[slate, row].abs().argmax())
    pre = n[slate, row] @ w1c[:, unit] + pt[3][unit]
    pt[3][unit] -= pre  # now within rounding of 0
    flip = torch.zeros(3, l, d_ff, dtype=torch.bool)
    flip[slate, row, unit] = True
    other = ffn_sublayer_bwd_plain(xt, *pt, dyt, flip=flip)
    plain = ffn_sublayer_bwd_plain(xt, *pt, dyt)
    scale = plain[0].float().abs().max()
    assert (other[0].float() - plain[0].float()).abs().max() > 2 ** -5 * scale
    found = gate_flips(other[0], xt, *pt, dyt, rtol=2 ** -5)
    assert torch.equal(found, flip)
    replayed = ffn_sublayer_bwd_plain(xt, *pt, dyt, flip=found)
    assert all(torch.equal(a, b) for a, b in zip(replayed, other))


def test_the_library_yardstick_computes_b2s_function():
    """The yardstick ``tools/time_sublayers.py`` times beside B2 (std-LN,
    matmul, relu) is the sublayer's function: at dropout 0 in fp32 it
    agrees with the plain version."""
    from allrank_tpu_torch.ops.ffn_block import ffn_sublayer_fwd_plain
    from allrank_tpu_torch.tools.time_sublayers import b2_library

    x, _, params = _inputs(24, 40, 7, seed=1)
    xt, pt = torch.tensor(x), list(map(torch.tensor, params))
    torch.testing.assert_close(b2_library(xt, *pt),
                               ffn_sublayer_fwd_plain(xt, *pt),
                               rtol=1e-4, atol=1e-5)
