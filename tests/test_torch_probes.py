"""The probe kernels of the port (X2, X3, X4) against the JAX package's probe
tools, on the same inputs made from a numpy seed, on the CPU.

The JAX tools' kernels run in Pallas interpret mode: ``pl.pallas_call`` is
patched with ``interpret=True`` for the test, as
``tests/test_torch_quant.py`` runs X1 (the tools build their calls at call
time, or behind an ``lru_cache`` that the test clears). The port's wrappers
take their plain versions on CPU tensors; the CLIs run with ``--device
cpu``.

Tolerances: bf16 results (X2, X3) are held to phase 2's kernel tolerance,
rtol = atol = 2^-6: both sides round at the same points, but an fp32 sum
taken in another order can land on the other side of a bf16 rounding edge
and move a value by an ulp (2^-7 relative), twice through two products.
X4 computes B8's function, and is held to B8's own CPU tolerances
(``tests/test_torch_softsort.py``): out to atol 2e-5, ds to atol 5e-5 with
rtol 1e-4; its records, whose gauge the loss does not contract, to rtol
1e-3 (``chip_smoke.py`` phase 11's).
"""

import contextlib
import functools
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from allrank_tpu_torch.ops import neuralsort_layout
from allrank_tpu_torch.ops.attention_block import attention_sublayer_fwd_plain
from allrank_tpu_torch.ops.attention_variants import (
    MODES,
    attention_variant_fwd,
    attention_variant_fwd_plain,
)
from allrank_tpu_torch.ops.boundary_shift import (
    boundary_plain,
    boundary_plain_plain,
    boundary_shift,
    boundary_shift_plain,
)
from allrank_tpu_torch.ops.neuralsort import soft_sort_fwd_plain
from allrank_tpu_torch.tools import (
    exp_attn_decompose,
    exp_boundary_shift,
    exp_sinkhorn_layout,
)

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


# -- X2: the boundary-shift kernels ------------------------------------------

@pytest.mark.parametrize("b,l", [(4, 48), (3, 37)])
def test_boundary_plain_versions_match_the_pallas_kernels(interpret, b, l):
    """Both kernels of ``tools/exp_boundary_shift.make_calls``; B = 3 runs
    the JAX grid one slate per program and gives the port a ragged last
    64-row tile (M = 111)."""
    from tools import exp_boundary_shift as x2

    d, d3 = 128, 384
    rs = np.random.RandomState(b * 100 + l)
    (jx, tx), (jw1, tw1), (jw2, tw2), (jw1n, tw1n), (jpre, tpre) = (
        _bf16(rs.randn(*shape) * sc) for shape, sc in (
            ((b, l, d), 0.5), ((d, d3), 0.05), ((d3, d), 0.05),
            ((d, d3), 0.05), ((b, l, d3), 0.5)))
    plain, shifted = x2.make_calls(b, l, d, d3, 1 if b % 4 else 4)
    ref = _np(plain(jx, jw1, jw2))
    got = boundary_plain(tx, tw1, tw2)
    assert got.dtype == torch.bfloat16 and got.shape == (b, l, d)
    np.testing.assert_allclose(got.float().numpy(), ref, **BF16_TOL)
    np.testing.assert_array_equal(got.float().numpy(),
                                  boundary_plain_plain(tx, tw1, tw2).float()
                                  .numpy())
    ref_out, ref_pre = shifted(jx, jpre, jw2, jw1n)
    out, pre_out = boundary_shift(tx, tpre, tw2, tw1n)
    assert pre_out.shape == (b, l, d3) and pre_out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), _np(ref_out), **BF16_TOL)
    np.testing.assert_allclose(pre_out.float().numpy(), _np(ref_pre),
                               **BF16_TOL)
    want = boundary_shift_plain(tx, tpre, tw2, tw1n)
    assert all(torch.equal(a, w) for a, w in zip((out, pre_out), want))


def test_boundary_kernels_refuse_what_they_do_not_cover():
    x = torch.zeros(2, 3, 300, dtype=torch.bfloat16)
    w1 = torch.zeros(300, 8, dtype=torch.bfloat16)
    w2 = torch.zeros(8, 300, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="d <= 256"):
        boundary_plain(x, w1, w2)
    with pytest.raises(TypeError, match="bfloat16"):
        boundary_plain(x[..., :8].float(), w1[:8], w2[:, :8])
    with pytest.raises(ValueError, match="pre must have shape"):
        boundary_shift(x[..., :8].contiguous(),
                       torch.zeros(2, 3, 9, dtype=torch.bfloat16),
                       w2[:, :8].contiguous(), w1[:8])


# -- X3: the attention variants -----------------------------------------------

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


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_attention_variants_match_the_pallas_kernel(interpret, mode, padded):
    """Every mode of ``tools/exp_attn_decompose.make_variant`` at B=4,
    L=48 (>= d_k, which no_pv needs), d=128, h=4; padded keys with one
    full and one empty slate."""
    from tools import exp_attn_decompose as x3

    b, l, d, h = 4, 48, 128, 4
    jx, jmask, jparams, tx, tmask, tparams = _variant_case(
        b, l, d, padded, seed=MODES.index(mode) + 10 * padded)
    ref = _np(x3.make_variant(b, l, d, h, mode)(jx, jmask, jparams))
    got = attention_variant_fwd(tx, tmask, *tparams, h, mode=mode)
    assert got.dtype == torch.bfloat16 and got.shape == (b, l, d)
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().numpy(), ref, **BF16_TOL)


@pytest.mark.parametrize("padded", [False, True])
def test_full_variant_is_the_b1_forward(padded):
    """``full`` is B1's forward at dropout 0: the same torch ops, bit for
    bit, fp32 and bf16."""
    for dtype in (torch.float32, torch.bfloat16):
        _, _, _, tx, tmask, tparams = _variant_case(3, 70, 96, padded, 5)
        x = tx.to(dtype)
        got = attention_variant_fwd_plain(x, tmask, *tparams, 2, mode="full")
        want = attention_sublayer_fwd_plain(x, tmask, *tparams, 2)
        assert torch.equal(got, want)


def test_attention_variants_refuse_what_they_do_not_cover():
    _, _, _, tx, tmask, tparams = _variant_case(2, 16, 128, False, 0)
    with pytest.raises(ValueError, match="L >= d_k"):
        attention_variant_fwd(tx, tmask, *tparams, 4, mode="no_pv")
    with pytest.raises(ValueError, match="mode must be one of"):
        attention_variant_fwd(tx, tmask, *tparams, 4, mode="no_scores")
    with pytest.raises(TypeError, match="bfloat16"):
        attention_variant_fwd(tx.float(), tmask, *tparams, 4)


# -- X4: the soft-sort with its records on chip -------------------------------

def _soft_case(n, l, seed):
    """Scores, ragged pads (slate 0 full, the tool's 40-document tail on
    slate 1, the others random, one fully padded) and gains."""
    rs = np.random.RandomState(seed)
    s = rs.randn(n, l).astype(np.float32)
    lengths = rs.randint(1, l + 1, size=n)
    lengths[0], lengths[1], lengths[-1] = l, max(l - 40, 1), 0
    pad = (np.arange(l)[None, :] >= lengths[:, None]).astype(np.float32)
    vec = rs.rand(n, l).astype(np.float32)
    dout = rs.randn(n, l).astype(np.float32)
    return s, pad, vec, dout


@pytest.mark.parametrize("transpose", [False, True])
def test_layout_soft_sort_matches_the_pallas_kernel(interpret, transpose):
    """``tools/exp_sinkhorn_layout.make_fused_C`` at N=8, L=48: out and
    both records from its forward rule, ds from its backward rule, against
    the port's X4 on the CPU (B8's plain version)."""
    from tools import exp_sinkhorn_layout as x4

    x4.make_fused_C.cache_clear()
    try:
        n, l = 8, 48
        s, pad, vec, dout = _soft_case(n, l, seed=3 + transpose)
        fused = x4.make_fused_C(1.0, 50, transpose, l)
        ref_out, res = fused.fwd(jnp.asarray(s), jnp.asarray(pad),
                                 jnp.asarray(vec))
        ref_ds = fused.bwd(res, jnp.asarray(dout))[0]
    finally:
        x4.make_fused_C.cache_clear()
    ts, tpad, tvec, tdout = (torch.from_numpy(a) for a in (s, pad, vec, dout))
    out, a_hist, b_hist = neuralsort_layout.layout_soft_sort_fwd(
        ts, tpad, tvec, 1.0, 50, transpose)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=2e-5)
    for got, ref in ((a_hist, res[3]), (b_hist, res[4])):
        assert got.shape == (n, 51, l)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3,
                                   atol=1e-6)
    ds = neuralsort_layout.layout_soft_sort_bwd(ts, tpad, tvec, a_hist,
                                                b_hist, tdout, 1.0, 50,
                                                transpose)
    assert not ds[tpad > 0.5].any()
    np.testing.assert_allclose(ds.numpy(), np.asarray(ref_ds), atol=5e-5,
                               rtol=1e-4)
    # autograd: the Function's gradient is the backward's
    leaf = ts.clone().requires_grad_()
    got = neuralsort_layout.layout_soft_sort_contract(
        leaf, tpad, tvec, tau=1.0, transpose=transpose)
    (got * tdout).sum().backward()
    assert torch.equal(got.detach(), out)
    assert torch.equal(leaf.grad, ds)


def test_layout_soft_sort_states_its_cap():
    """At T = 50 the backward's stacks, (2 T + 1) (round8(R) +
    round128(L)) floats in the room of its rows of M0 beside B8's vectors,
    fit 232,448 bytes up to L = 384 (B8's cluster of 8 blocks); one more is
    refused, before anything launches."""
    assert neuralsort_layout.max_length(50) == 384
    assert neuralsort_layout.layout_plan(240, 50, True) == (2, 186_720)
    assert neuralsort_layout.smem_floats(240, 2, 50, True) * 4 == 186_720
    neuralsort_layout.check_length(384, 50)
    with pytest.raises(ValueError, match="L <= 384"):
        neuralsort_layout.check_length(385, 50)
    s = torch.zeros(2, 400)
    out, _, _ = neuralsort_layout.layout_soft_sort_fwd(s, s, s, 1.0, 50)
    assert torch.equal(out, soft_sort_fwd_plain(s, s, s, 1.0, 50)[0])


# -- the CLIs -----------------------------------------------------------------

def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = main(argv)
    return res, buf.getvalue()


def test_boundary_shift_cli_prints_its_verdict():
    res, text = _run(exp_boundary_shift.main, ["2", "8", "3", "--device",
                                              "cpu"])
    assert "device: cpu" in text and "no number of the card" in text
    assert text.count("verdict (cpu,") == 2
    assert set(res) == {"graph", "eager"}
    for r in res.values():
        assert r["verdict"] in (exp_boundary_shift.verdict(1.0, 0.0),
                                exp_boundary_shift.verdict(0.0, 1.0))
        assert np.isfinite(r["tax_plain_us"]) and r["iso_plain_ms"] > 0


def test_attn_decompose_cli_prints_its_stages(monkeypatch):
    monkeypatch.setattr(exp_attn_decompose, "ROUNDS", 1)
    res, text = _run(exp_attn_decompose.main, ["2", "40", "--device", "cpu"])
    for line in ("softmax total:", "P@V contraction:", "LN+QKV+out frame:",
                 "production fwd call", "production bwd call"):
        assert line in text
    assert set(res["modes_us"]) == set(MODES)
    assert all(np.isfinite(v) and v > 0 for v in res["modes_us"].values())


def test_sinkhorn_layout_cli_prints_its_verdict():
    res, text = _run(exp_sinkhorn_layout.main, ["4", "48", "--device", "cpu"])
    assert "max |out_B8-out_X4| = 0.0" in text
    assert res["max_abs_grad"] == 0.0 and "records on chip:" in text


@pytest.mark.parametrize("main", [exp_boundary_shift.main,
                                  exp_attn_decompose.main,
                                  exp_sinkhorn_layout.main])
def test_probe_clis_need_a_card_unless_asked_for_the_cpu(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["2", "8"])
