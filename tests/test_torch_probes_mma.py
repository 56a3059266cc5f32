"""The probe kernels' tensor-core routes (X2, X3) and the fp32 one-key
backward of B5's plain version (ROADMAP Queue C6), on the CPU.

X3's route is B1's: every (d, h) picks the tensor cores (``"mma"``) at
d_k <= 128 and the SIMT units above, and raises where B1's envelope does,
before anything launches. The plain versions, which the CUDA kernels are
held to on the card, are held here against the JAX tools' Pallas kernels in
interpret mode at the head classes the tensor-core instantiations take
(d_k 48 pads to 64, d_k 100 to 128) and, for X2, at d and d3 off the 16- and
64-column steps that the kernels pad to. Tolerance: phase 2's bf16 kernel
tolerance, rtol = atol = 2^-6 (``tests/test_torch_probes.py``). The library
yardsticks of ``allrank_tpu_torch/tools/time_sublayers.py`` are held to the
same functions, in bf16 with their own rounding points: 2^-5 of the
output's largest value.
"""

import functools
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import chip_smoke
from allrank_tpu_torch.ops import _build, attention_block
from allrank_tpu_torch.ops import attention_variants as x3
from allrank_tpu_torch.ops.attention_tiled import (
    tiled_attention_bwd_plain,
    tiled_attention_fwd_plain,
)
from allrank_tpu_torch.ops.boundary_shift import (
    boundary_plain,
    boundary_plain_plain,
    boundary_shift,
    boundary_shift_plain,
)
from allrank_tpu_torch.tools import time_sublayers
from allrank_tpu_torch.tools.time_sublayers import b1_library

BF16_TOL = dict(rtol=2 ** -6, atol=2 ** -6)


@pytest.fixture
def interpret(monkeypatch):
    """``pl.pallas_call`` in interpret mode for the test."""
    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(real, interpret=True))


def _bf16(a):
    """A float array rounded to bf16, as (jax array, torch tensor)."""
    t = torch.from_numpy(np.asarray(a, dtype=np.float32)).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# -- X3's route ----------------------------------------------------------------

@pytest.mark.parametrize("d", [8, 32, 96, 100, 128, 144, 256])
@pytest.mark.parametrize("h", [1, 2, 4])
def test_variant_route_is_b1s(d, h):
    """B1's bf16 route over a grid of (d, h): the tensor cores to d_k = 128,
    the SIMT units above."""
    if d % h:
        with pytest.raises(NotImplementedError, match="multiple of h"):
            x3.route(d, h)
        with pytest.raises(NotImplementedError, match="multiple of h"):
            attention_block.route(torch.bfloat16, d, h)
        return
    want = attention_block.route(torch.bfloat16, d, h)
    assert x3.route(d, h) == want
    assert want == ("mma" if d // h <= 128 else "simt")


@pytest.mark.parametrize("d,h", [(300, 1), (0, 1), (96, 5)])
def test_variant_route_raises_where_b1_does(d, h):
    """Outside B1's envelope the route raises, and so does a call on the
    CPU, before any launch is counted."""
    with pytest.raises(NotImplementedError):
        attention_block.route(torch.bfloat16, d, h)
    with pytest.raises(NotImplementedError):
        x3.route(d, h)
    if d:
        x = torch.zeros(2, 8, d, dtype=torch.bfloat16)
        mask = torch.zeros(2, 8, dtype=torch.bool)
        params = (torch.ones(d), torch.zeros(d), torch.zeros(d, 3 * d),
                  torch.zeros(3 * d), torch.zeros(d, d), torch.zeros(d))
        before = (dict(x3.attention_variant_fwd.launches),
                  dict(x3.attention_variant_fwd.route_launches))
        with pytest.raises(NotImplementedError):
            x3.attention_variant_fwd(x, mask, *params, h)
        assert (x3.attention_variant_fwd.launches,
                x3.attention_variant_fwd.route_launches) == before


def test_variant_libraries_cover_every_mode():
    """Each mode has a tensor-core source in the build; exp2 runs full's."""
    assert set(x3.MMA_LIBRARIES) == set(x3.MODES)
    assert x3.MMA_LIBRARIES["exp2"] == x3.MMA_LIBRARIES["full"]
    for name in set(x3.MMA_LIBRARIES.values()):
        assert os.path.exists(_build.source_path(name)), name


def test_variant_launch_by_name_needs_the_card():
    """``launch_fwd`` runs the kernels of a named route; on the CPU it
    refuses (there is no kernel to run), and it refuses an unknown route."""
    d, h = 64, 2
    x = torch.zeros(2, 8, d, dtype=torch.bfloat16)
    mask = torch.zeros(2, 8, dtype=torch.bool)
    params = (torch.ones(d), torch.zeros(d), torch.zeros(d, 3 * d),
              torch.zeros(3 * d), torch.zeros(d, d), torch.zeros(d))
    with pytest.raises(ValueError, match="route must be one of"):
        x3.launch_fwd("tf32x3", x, mask, *params, h)
    with pytest.raises(ValueError, match="CUDA tensor"):
        x3.launch_fwd("mma", x, mask, *params, h)


# -- X3's plain versions at the tensor-core head classes ----------------------

def _variant_case(b, l, d, padded, seed):
    rs = np.random.RandomState(seed)
    jx, tx = _bf16(rs.randn(b, l, d))
    lengths = rs.randint(1, l + 1, size=b) if padded else np.full(b, l)
    if padded:
        lengths[0], lengths[-1] = l, 0  # one full, one empty slate
    mask = np.arange(l)[None, :] >= lengths[:, None]
    g = (1 + 0.1 * rs.randn(d)).astype(np.float32)
    bias = (0.1 * rs.randn(d)).astype(np.float32)
    (jwqkv, twqkv), (jwout, twout) = (_bf16(rs.randn(d, n) * d ** -0.5)
                                      for n in (3 * d, d))
    bqkv = (0.1 * rs.randn(3 * d)).astype(np.float32)
    bout = (0.1 * rs.randn(d)).astype(np.float32)
    jparams = (jnp.asarray(g), jnp.asarray(bias), jwqkv, jnp.asarray(bqkv),
               jwout, jnp.asarray(bout))
    tparams = (torch.from_numpy(g), torch.from_numpy(bias), twqkv.float(),
               torch.from_numpy(bqkv), twout.float(), torch.from_numpy(bout))
    return jx, jnp.asarray(mask), jparams, tx, torch.from_numpy(mask), tparams


@pytest.mark.parametrize("mode", x3.MODES)
@pytest.mark.parametrize("d,h,l", [(96, 2, 56), (100, 1, 104)])
def test_variants_match_the_pallas_kernel_at_the_padded_classes(
        interpret, mode, d, h, l):
    """Every mode of ``tools/exp_attn_decompose.make_variant`` at d_k 48
    (padded to 64) and d_k 100 (padded to 128, rows off a 16-byte
    boundary), L >= d_k, one full and one empty slate."""
    from tools import exp_attn_decompose as jax_x3

    b = 3
    jx, jmask, jparams, tx, tmask, tparams = _variant_case(
        b, l, d, True, seed=x3.MODES.index(mode) + d)
    ref = _np(jax_x3.make_variant(b, l, d, h, mode)(jx, jmask, jparams))
    got = x3.attention_variant_fwd(tx, tmask, *tparams, h, mode=mode)
    assert got.dtype == torch.bfloat16 and got.shape == (b, l, d)
    assert torch.isfinite(got.float()).all()
    if mode == "no_softmax":
        # padded keys weigh -1e9 x 0.001: held to the output's scale, as
        # on the card
        scale = np.abs(ref).max()
        assert np.abs(got.float().numpy() - ref).max() <= 2 ** -6 * scale
    else:
        np.testing.assert_allclose(got.float().numpy(), ref, **BF16_TOL)


@pytest.mark.parametrize("mode", x3.MODES)
def test_variant_plain_replays_a_given_qkv(mode):
    """The plain version from its own LN + QKV result, passed as ``qkv``,
    is the plain version (the card's no_pv and frame checks pass the
    kernel's qkv this way); another qkv changes the result."""
    _, _, _, tx, tmask, tparams = _variant_case(2, 40, 64, True, seed=9)
    qkv = x3.qkv_plain(tx, *tparams[:4])
    assert qkv.shape == (2, 40, 192) and qkv.dtype == torch.bfloat16
    want = x3.attention_variant_fwd_plain(tx, tmask, *tparams, 2, mode=mode)
    got = x3.attention_variant_fwd_plain(tx, tmask, *tparams, 2, mode=mode,
                                         qkv=qkv)
    assert torch.equal(got, want)
    other = x3.attention_variant_fwd_plain(tx, tmask, *tparams, 2, mode=mode,
                                           qkv=(qkv.float() * 1.5).to(
                                               torch.bfloat16))
    assert not torch.equal(other, want)


# -- X2's plain versions off the tensor cores' steps --------------------------

@pytest.mark.parametrize("d,d3", [(100, 200), (24, 70)])
def test_boundary_plain_versions_off_the_padded_steps(interpret, d, d3):
    """Both kernels of ``tools/exp_boundary_shift.make_calls`` at d and d3
    that are not whole 16- and 64-column steps (the kernels pad the weights
    with zeros there)."""
    from tools import exp_boundary_shift as jax_x2

    b, l = 2, 24
    rs = np.random.RandomState(d + d3)
    (jx, tx), (jw1, tw1), (jw2, tw2), (jw1n, tw1n), (jpre, tpre) = (
        _bf16(rs.randn(*shape) * sc) for shape, sc in (
            ((b, l, d), 0.5), ((d, d3), 0.05), ((d3, d), 0.05),
            ((d, d3), 0.05), ((b, l, d3), 0.5)))
    plain, shifted = jax_x2.make_calls(b, l, d, d3, 1)
    got = boundary_plain(tx, tw1, tw2)
    np.testing.assert_allclose(got.float().numpy(),
                               _np(plain(jx, jw1, jw2)), **BF16_TOL)
    assert torch.equal(got, boundary_plain_plain(tx, tw1, tw2))
    ref_out, ref_pre = shifted(jx, jpre, jw2, jw1n)
    out, pre_out = boundary_shift(tx, tpre, tw2, tw1n)
    np.testing.assert_allclose(out.float().numpy(), _np(ref_out), **BF16_TOL)
    np.testing.assert_allclose(pre_out.float().numpy(), _np(ref_pre),
                               **BF16_TOL)
    want = boundary_shift_plain(tx, tpre, tw2, tw1n)
    assert all(torch.equal(a, w) for a, w in zip((out, pre_out), want))


# -- the library yardsticks ----------------------------------------------------

def _close_to_scale(got, ref, frac=2 ** -5):
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= frac * ref.float().abs().max().item(), err


@pytest.mark.parametrize("shifted", [False, True])
def test_x2_library_computes_the_boundary_kernels(shifted):
    gen = torch.Generator().manual_seed(3)
    x, pre, w1, w2, w1n = time_sublayers.x2_inputs(gen, 2, 16, "cpu", d=64,
                                                   d3=128)
    if shifted:
        got = time_sublayers.x2_library(x, pre, w1n, w2, True)
        want = boundary_shift_plain(x, pre, w2, w1n)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == torch.bfloat16
            _close_to_scale(g, w)
    else:
        got = time_sublayers.x2_library(x, pre, w1, w2, False)
        assert got.dtype == torch.bfloat16
        _close_to_scale(got, boundary_plain_plain(x, w1, w2))
    assert time_sublayers.x2_library is chip_smoke.x2_library


def test_x3_library_computes_full():
    """``b1_library`` on ``library_args`` is X3's ``full``, B1's forward,
    with a fully padded slate among ragged ones."""
    gen = torch.Generator().manual_seed(4)
    args = time_sublayers.x3_inputs(gen, 3, 20, 32, "cpu")
    got = b1_library(*time_sublayers.library_args(args, 2))
    want = x3.attention_variant_fwd_plain(*args, 2, mode="full")
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _close_to_scale(got, want)


# -- no_softmax's check on the card ---------------------------------------------

def _no_softmax_case(kind):
    """(y, ref, key_mask): slate 0 with no padded key and values near 1,
    slate 1 with a padded key and rows near 1e6 and 1e3; y is ref with one
    change of ``kind``."""
    gen = torch.Generator().manual_seed(5)
    ref = torch.randn(2, 3, 8, generator=gen)
    ref[1, 0] *= 1e6
    ref[1, 1:] *= 1e3
    mask = torch.zeros(2, 3, dtype=torch.bool)
    mask[1, 2] = True
    y = ref.clone()
    if kind == "unpadded_off":       # past 2^-6 of an element near 1
        y[0, 1, 3] += 0.5
    elif kind == "unpadded_within":
        y[0, 1, 3] += 2 ** -8
    elif kind == "small_row_off":    # past 2^-6 of its row, not the tensor's
        y[1, 2, 0] += 2 ** -6 * ref[1, 2].abs().max() * 4
    elif kind == "large_row_within":  # past 2^-6 of the element, not its row
        y[1, 0, 0] += 2 ** -7 * ref[1, 0].abs().max()
    return y.to(torch.bfloat16), ref.to(torch.bfloat16), mask


@pytest.mark.parametrize("kind,ok", [
    ("equal", True), ("unpadded_within", True), ("large_row_within", True),
    ("unpadded_off", False), ("small_row_off", False)])
def test_no_softmax_close_holds_each_row_to_its_own_scale(kind, ok):
    """``chip_smoke.no_softmax_close``: element by element in a slate with
    no padded key, each row of a padded slate to 2^-6 of its own largest
    value; an error that only the tensor's largest value would cover
    fails."""
    y, ref, mask = _no_softmax_case(kind)
    if ok:
        err_full, worst = chip_smoke.no_softmax_close(y, ref, mask, BF16_TOL)
        assert worst is not None and worst[1] > 0
        assert err_full <= BF16_TOL["atol"] + BF16_TOL["rtol"] * 4
    else:
        with pytest.raises(AssertionError):
            chip_smoke.no_softmax_close(y, ref, mask, BF16_TOL)


# -- the build list ------------------------------------------------------------

def test_every_source_is_in_the_build_list():
    """chip_smoke.py builds every csrc/*.cu (phase 1), the new tensor-core
    sources of X2 and X3 among them, and the SIMT X2 source is gone."""
    have = {os.path.basename(p)[:-3] for p in glob.glob(
        os.path.join(_build.CSRC_DIR, "*.cu"))}
    assert set(chip_smoke.SOURCES) == have
    assert len(chip_smoke.SOURCES) == len(set(chip_smoke.SOURCES))
    assert "boundary_shift_mma" in have and "boundary_shift" not in have
    assert set(x3.MMA_LIBRARIES.values()) <= have


# -- C6: B5's plain fp32 backward at one key -----------------------------------

@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("dk", [8, 36, 128])
def test_plain_b5_backward_one_key_is_exactly_zero(dk, p):
    """At L = 1, P is 1 and dPd - D is 0 in exact arithmetic; in fp32 the
    plain backward takes D in dP's own order, so dq and dk are exactly 0
    (ROADMAP Queue C6), as the fp32 kernels' are; with a padded key too,
    and with an lse a few ulps off this version's own (as the kernel's,
    from its own rounding of the scores, is on the card)."""
    rs = np.random.RandomState(dk + int(10 * p))
    q, k, v, do = (torch.tensor(rs.randn(3, 2, 1, dk).astype(np.float32))
                   for _ in range(4))
    for mask in (torch.zeros(3, 1, dtype=torch.bool),
                 torch.tensor([[False], [True], [False]])):
        out, lse = tiled_attention_fwd_plain(q, k, v, mask, p, 21)
        up = torch.nextafter(lse, torch.full_like(lse, float("inf")))
        down = torch.nextafter(torch.nextafter(lse, -up), -up)
        for saved_lse in (lse, up, down):
            dq, dkk, dv = tiled_attention_bwd_plain(q, k, v, mask, out,
                                                    saved_lse, do, p, 21)
            assert not dq.any() and not dkk.any(), (dk, p)
            assert dv.abs().max() > 0
