"""The port's CUDA kernels on the card: each against its plain version, and
the flagship scorer's launches. Every test here is marked ``gpu`` and skips
without a CUDA device (the kernels have no CPU mode).

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest
"""

import math

import numpy as np
import pytest
import torch

from allrank_tpu_torch.ops.approx_pos import (
    approx_pos_bwd,
    approx_pos_bwd_plain,
    approx_pos_fwd,
    approx_pos_fwd_plain,
)
from allrank_tpu_torch.ops.attention_block import (
    attention_sublayer,
    attention_sublayer_bwd,
    attention_sublayer_bwd_plain,
    attention_sublayer_fwd,
    attention_sublayer_fwd_plain,
    launch_fwd,
    route,
)
from allrank_tpu_torch.ops.attention_fused import (
    attention_fused_bwd,
    attention_fused_bwd_plain,
    attention_fused_fwd,
    attention_fused_fwd_plain,
    fused_slate_attention,
)
from allrank_tpu_torch.ops.attention_fused import route as attention_route
from allrank_tpu_torch.ops.attention_tiled import (
    tiled_attention_bwd,
    tiled_attention_bwd_plain,
    tiled_attention_fwd,
    tiled_attention_fwd_plain,
    tiled_slate_attention,
)
from allrank_tpu_torch.ops.encoder_block import (
    cooperative_grid,
    encoder_backward_plain,
    encoder_block_bwd,
    encoder_block_fwd,
    encoder_forward_plain,
)
from allrank_tpu_torch.ops.ffn_block import (
    ffn_sublayer,
    ffn_sublayer_bwd,
    ffn_sublayer_bwd_plain,
    ffn_sublayer_fwd,
    ffn_sublayer_fwd_plain,
    gate_flips,
)
from allrank_tpu_torch.ops.ffn_block import launch_bwd as ffn_launch_bwd
from allrank_tpu_torch.ops.ffn_block import launch_fwd as ffn_launch_fwd
from allrank_tpu_torch.ops.ffn_block import route as ffn_route
from allrank_tpu_torch.ops.lambda_pairs import (
    SCHEMES,
    lambda_pairs_bwd,
    lambda_pairs_bwd_plain,
    lambda_pairs_fwd,
    lambda_pairs_fwd_plain,
)
from allrank_tpu_torch.ops.lambda_tiled import (
    lambda_tiled_bwd,
    lambda_tiled_bwd_plain,
    lambda_tiled_fwd,
    lambda_tiled_fwd_plain,
)
from allrank_tpu_torch.ops.q8_dense import q8_dense, q8_dense_plain
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
from allrank_tpu_torch.ops.neuralsort_layout import (
    layout_soft_sort_bwd,
    layout_soft_sort_fwd,
    layout_vectors,
    max_length,
    smem_floats,
)
from allrank_tpu_torch.ops.neuralsort import (
    soft_sort_bwd,
    soft_sort_bwd_plain,
    soft_sort_fwd,
    soft_sort_fwd_plain,
)
from allrank_tpu_torch.ops.sinkhorn import (
    sinkhorn_bwd,
    sinkhorn_bwd_plain,
    sinkhorn_fwd,
    sinkhorn_fwd_plain,
)

pytestmark = pytest.mark.gpu

# fp32: the same FMAs summed in another order; bf16: the same rounding
# points, a rounding flip moves y by one or two bf16 ulps
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2 ** -6, atol=2 ** -6)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _params(gen, shapes, dev):
    out = []
    for shape, center, scale in shapes:
        out.append((center + torch.randn(*shape, generator=gen) * scale)
                   .to(dev))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h,d_ff", [(128, 4, 512), (144, 2, 512),
                                      (96, 1, 384)])
def test_kernels_match_plain(cuda, d, h, d_ff, dtype):
    gen = torch.Generator().manual_seed(d)
    b, l = 8, 240
    x = torch.randn(b, l, d, generator=gen).to(dtype).to(cuda)
    lengths = torch.randint(1, l + 1, (b,), generator=gen)
    lengths[0] = 0
    mask = (torch.arange(l)[None, :] >= lengths[:, None]).to(cuda)
    attn = _params(gen, [((d,), 1, 0.1), ((d,), 0, 0.1),
                         ((d, 3 * d), 0, d ** -0.5), ((3 * d,), 0, 0.1),
                         ((d, d), 0, d ** -0.5), ((d,), 0, 0.1)], cuda)
    ffn = _params(gen, [((d,), 1, 0.1), ((d,), 0, 0.1),
                        ((d, d_ff), 0, d ** -0.5), ((d_ff,), 0, 0.1),
                        ((d_ff, d), 0, d_ff ** -0.5), ((d,), 0, 0.1)], cuda)
    before = (attention_sublayer_fwd.launches, ffn_sublayer_fwd.launches)
    y = attention_sublayer_fwd(x, mask, *attn, h)
    torch.testing.assert_close(
        y.float(), attention_sublayer_fwd_plain(x, mask, *attn, h).float(),
        **TOL[dtype])
    z = ffn_sublayer_fwd(y, *ffn)
    torch.testing.assert_close(z.float(),
                               ffn_sublayer_fwd_plain(y, *ffn).float(),
                               **TOL[dtype])
    assert (attention_sublayer_fwd.launches, ffn_sublayer_fwd.launches) == (
        before[0] + 1, before[1] + 1)


def test_scorer_launches_each_kernel_once_per_block(cuda):
    from allrank_tpu_torch.config import (
        FCConfig,
        ModelConfig,
        PostModelConfig,
        TransformerConfig,
    )
    from allrank_tpu_torch.models.factory import LTRModel, make_model
    from allrank_tpu_torch.serving import make_scorer

    mdef = make_model(ModelConfig(
        fc_model=FCConfig(sizes=[32], input_norm=True, activation="ReLU",
                          dropout=0.0),
        transformer=TransformerConfig(N=3, d_ff=64, h=2, dropout=0.0,
                                      positional_encoding=None),
        post_model=PostModelConfig(d_output=1)), 10)
    model = LTRModel(mdef, torch.Generator().manual_seed(0), device="cpu")
    x = np.random.RandomState(0).randn(4, 20, 10).astype(np.float32)
    lengths = np.array([20, 7, 0, 1])
    ref = make_scorer(model, device="cpu")(x, lengths).numpy()
    scorer = make_scorer(model, device=cuda)
    scorer(x, lengths)
    attention_sublayer_fwd.launches = ffn_sublayer_fwd.launches = 0
    got = scorer(x, lengths).cpu().numpy()
    assert (attention_sublayer_fwd.launches, ffn_sublayer_fwd.launches) == (
        3, 3)
    assert (np.isneginf(got) == np.isneginf(ref)).all()
    assert not np.isnan(got).any()
    valid = ~np.isneginf(ref)
    np.testing.assert_allclose(got[valid], ref[valid], rtol=1e-4, atol=1e-4)


def test_kernels_raise_outside_their_envelope(cuda):
    x = torch.zeros(1, 1025, 128, device=cuda)
    mask = torch.zeros(1, 1025, dtype=torch.bool, device=cuda)
    attn = [torch.zeros(*s, device=cuda)
            for s in ((128,), (128,), (128, 384), (384,), (128, 128), (128,))]
    with pytest.raises(NotImplementedError, match="L <= 1024"):
        attention_sublayer_fwd(x, mask, *attn, 4)
    ffn = [torch.zeros(*s, device=cuda)
           for s in ((128,), (128,), (128, 2048), (2048,), (2048, 128),
                     (128,))]
    with pytest.raises(NotImplementedError, match="d_ff <= 1024"):
        ffn_sublayer_fwd(x[:, :8].contiguous(), *ffn)
    with pytest.raises(ValueError, match="dropout rate"):
        attention_sublayer_fwd(x[:, :8].contiguous(), mask[:, :8].contiguous(),
                               *attn, 4, p_attn=1.0)
    # k = 385: the one-block kernel refuses and names the tiled one, which
    # runs, as the loss does through it
    yp = torch.zeros(2, 385, device=cuda)
    kw = dict(scheme=None, k_eff=385, sigma=1.0, mu=10.0, log_base="binary",
              eps=1e-10)
    with pytest.raises(NotImplementedError, match="tiled_lambda_pairs"):
        lambda_pairs_fwd(yp, yp, yp, yp, **kw)
    before = lambda_tiled_fwd.launches
    loss, cnt = lambda_tiled_fwd(yp, yp, yp, torch.ones_like(yp), **kw)
    assert lambda_tiled_fwd.launches == before + 1
    assert not cnt.any() and not loss.any()  # equal labels select no pair
    from allrank_tpu_torch.losses import lambdaLoss

    y_true = torch.arange(385, device=cuda).remainder(5).float().repeat(2, 1)
    value = lambdaLoss(torch.randn(2, 385, device=cuda), y_true)
    assert lambda_tiled_fwd.launches == before + 2
    assert torch.isfinite(value)
    long = torch.zeros(1, 4097, device=cuda)
    with pytest.raises(NotImplementedError, match="k <= 4096"):
        lambda_tiled_fwd(long, long, long, long, **{**kw, "k_eff": 4097})
    with pytest.raises(NotImplementedError, match="L <= 4096"):
        approx_pos_fwd(long, long, 1.0, 1e-10)
    # the losses let the refusal surface: no torch-op chain on the card
    from allrank_tpu_torch.losses import approxNDCGLoss

    long_true = torch.arange(4097, device=cuda).remainder(5).float()[None]
    with pytest.raises(NotImplementedError, match="k <= 4096"):
        lambdaLoss(torch.randn(1, 4097, device=cuda), long_true)
    with pytest.raises(NotImplementedError, match="L <= 4096"):
        approxNDCGLoss(torch.randn(1, 4097, device=cuda), long_true)


# backward kernel vs its plain version, per gradient tensor: fp32 sums in
# another order (relative to the tensor's largest value); bf16 at the same
# rounding points, where an fp32 sum on the other side of a rounding edge
# moves one bf16 value by an ulp and a weight gradient summed over it a
# little (2^-5 of the largest value)
def _close(got, ref, dtype, what):
    scale = ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    tol = (1e-4 * scale + 1e-6 if dtype == torch.float32
           else 2 ** -5 * scale + 1e-6)
    assert err <= tol, f"{what}: max|err| {err} > {tol} (max|ref| {scale})"


# ReLU gates a B2 backward may take the other way from the plain version
# (a pre-activation within rounding of 0), chip_smoke.py's GATE_FLIPS_MAX:
# a fault upstream moves every pre-activation and flips far more
GATE_FLIPS_MAX = 8
FFN_GRADS = ("dx", "dg", "db", "dw1", "db1", "dw2", "db2")


def _ffn_replayed_close(got, x, ffn, dy, p, seeds, dtype, what):
    """ROADMAP Queue C5: a B2 backward against its plain version with the
    ReLU gates that its dx shows flipped replayed (``gate_flips``): at most
    ``GATE_FLIPS_MAX`` units, every gradient within ``_close``. Returns the
    number of flipped gates."""
    rtol = 1e-4 if dtype == torch.float32 else 2 ** -5
    flip = gate_flips(got[0], x, *ffn, dy, p, p, seeds, rtol=rtol)
    flips = int(flip.sum())
    assert flips <= GATE_FLIPS_MAX, f"{what}: {flips} gates flipped"
    ref = ffn_sublayer_bwd_plain(x, *ffn, dy, p, p, seeds, flip=flip)
    for name, g, r in zip(FFN_GRADS, got, ref):
        assert torch.isfinite(g.float()).all(), name
        _close(g, r, dtype, f"{what} {name}, {flips} gates flipped")
    return flips


@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h,d_ff,l", [(128, 4, 512, 240), (96, 1, 384, 70),
                                        (96, 1, 384, 240),
                                        (144, 2, 512, 240),
                                        (256, 1, 1024, 65)])
def test_backward_kernels_match_plain(cuda, d, h, d_ff, l, dtype, p):
    gen = torch.Generator().manual_seed(d + l)
    b = 4
    x = torch.randn(b, l, d, generator=gen).to(dtype).to(cuda)
    dy = torch.randn(b, l, d, generator=gen).to(dtype).to(cuda)
    lengths = torch.randint(1, l + 1, (b,), generator=gen)
    lengths[0] = 0
    mask = (torch.arange(l)[None, :] >= lengths[:, None]).to(cuda)
    attn = _params(gen, [((d,), 1, 0.1), ((d,), 0, 0.1),
                         ((d, 3 * d), 0, d ** -0.5), ((3 * d,), 0, 0.1),
                         ((d, d), 0, d ** -0.5), ((d,), 0, 0.1)], cuda)
    ffn = _params(gen, [((d,), 1, 0.1), ((d,), 0, 0.1),
                        ((d, d_ff), 0, d ** -0.5), ((d_ff,), 0, 0.1),
                        ((d_ff, d), 0, d_ff ** -0.5), ((d,), 0, 0.1)], cuda)
    seeds = (11, 12)
    y, saved = attention_sublayer_fwd(x, mask, *attn, h, p, p, seeds,
                                      return_saved=True)
    torch.testing.assert_close(
        y.float(), attention_sublayer_fwd_plain(x, mask, *attn, h, p, p,
                                                seeds).float(), **TOL[dtype])
    got = attention_sublayer_bwd(x, mask, *attn, dy, h, p, p, seeds,
                                 saved=saved)
    ref = attention_sublayer_bwd_plain(x, mask, *attn, dy, h, p, p, seeds)
    for name, g, r in zip(("dx", "dg", "db", "dwqkv", "dbqkv", "dwout",
                           "dbout"), got, ref):
        assert torch.isfinite(g.float()).all(), name
        _close(g, r, dtype, f"attention {name}")
    # no atomics: a second backward of the same inputs gives the same bits
    again = attention_sublayer_bwd(x, mask, *attn, dy, h, p, p, seeds,
                                   saved=saved)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    z = ffn_sublayer_fwd(x, *ffn, p, p, seeds)
    torch.testing.assert_close(
        z.float(), ffn_sublayer_fwd_plain(x, *ffn, p, p, seeds).float(),
        **TOL[dtype])
    got = ffn_sublayer_bwd(x, *ffn, dy, p, p, seeds)
    _ffn_replayed_close(got, x, ffn, dy, p, seeds, dtype, "ffn")
    again = ffn_sublayer_bwd(x, *ffn, dy, p, p, seeds)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("d,d_ff,dtype,p,seed", [
    (96, 384, torch.bfloat16, 0.3, 1), (96, 384, torch.bfloat16, 0.3, 5),
    (96, 384, torch.bfloat16, 0.0, 1), (144, 512, torch.float32, 0.3, 3),
    (144, 512, torch.float32, 0.0, 3)])
def test_ffn_backward_differs_from_plain_only_by_gate_flips(cuda, d, d_ff,
                                                            dtype, p, seed):
    """ROADMAP Queue C5: on these inputs (chip_smoke phase 7's draw at B=64,
    L=240 from a generator of ``seed``) a hidden unit's pre-activation lies
    within rounding of 0 and its ReLU gate differs between the SIMT kernel
    (the route that found C5, in bf16 too) and the plain version, which
    moves dx past ``_close``'s tolerance. With the flipped gates replayed
    (``gate_flips``) every gradient is within it."""
    gen = torch.Generator().manual_seed(seed)
    ffn = _params(gen, [((d,), 1, 0.1), ((d,), 0, 0.1),
                        ((d, d_ff), 0, d ** -0.5), ((d_ff,), 0, 0.1),
                        ((d_ff, d), 0, d_ff ** -0.5), ((d,), 0, 0.1)], cuda)
    x = torch.randn(64, 240, d, generator=gen).to(dtype).to(cuda)
    dy = torch.randn(64, 240, d, generator=gen).to(dtype).to(cuda)
    seeds = (101, 202)
    got = ffn_launch_bwd("simt", x, *ffn, dy, p, p, seeds)
    flip = gate_flips(got[0], x, *ffn, dy, p, p, seeds,
                      rtol=1e-4 if dtype == torch.float32 else 2 ** -5)
    # the flips C5 found: a fix of B2's gates, or a new flip rule, shows here
    assert 1 <= int(flip.sum()) <= 8, int(flip.sum())
    ref = ffn_sublayer_bwd_plain(x, *ffn, dy, p, p, seeds, flip=flip)
    for name, g, r in zip(("dx", "dg", "db", "dw1", "db1", "dw2", "db2"),
                          got, ref):
        _close(g, r, dtype, f"ffn {name}, {int(flip.sum())} gates flipped")


@pytest.mark.parametrize("d,d_ff,p,seed", [
    (96, 384, 0.3, 1), (96, 384, 0.3, 5), (96, 384, 0.0, 1)])
def test_ffn_mma_backward_on_c5_inputs_differs_only_by_gate_flips(
        cuda, d, d_ff, p, seed):
    """C5's bf16 inputs through the tensor-core route, which sums in
    another order than the SIMT kernels: its flips (if any) replayed, every
    gradient within ``_close``."""
    gen = torch.Generator().manual_seed(seed)
    ffn = _params(gen, [((d,), 1, 0.1), ((d,), 0, 0.1),
                        ((d, d_ff), 0, d ** -0.5), ((d_ff,), 0, 0.1),
                        ((d_ff, d), 0, d_ff ** -0.5), ((d,), 0, 0.1)], cuda)
    x = torch.randn(64, 240, d, generator=gen).to(torch.bfloat16).to(cuda)
    dy = torch.randn(64, 240, d, generator=gen).to(torch.bfloat16).to(cuda)
    seeds = (101, 202)
    got = ffn_launch_bwd("mma", x, *ffn, dy, p, p, seeds)
    _ffn_replayed_close(got, x, ffn, dy, p, seeds, torch.bfloat16,
                        "ffn (mma)")


# B2's bf16 widths: d within one warp's 128 output columns (32, 96, 128) or
# split over two warps (144, 256), d_ff whole 64-unit chunks;
# test_b2_mma_edge_shapes takes d and d_ff off those steps
B2_MMA_WIDTHS = [(d, d_ff) for d in (32, 96, 128, 144, 256)
                 for d_ff in (384, 512, 1024)]


def _b2_mma_case(cuda, b, l, d, d_ff, p, seed, offset=0):
    """B2 in bf16 through its tensor-core route against the plain version:
    the forward, the backward with the C5 replay, a second backward bit for
    bit; x and dy moved ``offset`` elements off a 16-byte boundary."""
    gen = torch.Generator().manual_seed(seed)
    bf16 = torch.bfloat16
    x = torch.randn(b, l, d, generator=gen).to(bf16).to(cuda)
    dy = torch.randn(b, l, d, generator=gen).to(bf16).to(cuda)
    if offset:
        moved = []
        for t in (x, dy):
            flat = torch.empty(t.numel() + offset, dtype=bf16, device=cuda)
            m = flat[offset:].view(t.shape)
            m.copy_(t)
            assert m.data_ptr() % 16 != 0
            moved.append(m)
        x, dy = moved
    ffn = _params(gen, [((d,), 1, 0.1), ((d,), 0, 0.1),
                        ((d, d_ff), 0, d ** -0.5), ((d_ff,), 0, 0.1),
                        ((d_ff, d), 0, d_ff ** -0.5), ((d,), 0, 0.1)], cuda)
    seeds = (31, 32)
    before = (ffn_sublayer_fwd.route_launches["mma"],
              ffn_sublayer_bwd.route_launches["mma"])
    y = ffn_sublayer_fwd(x, *ffn, p, p, seeds)
    got = ffn_sublayer_bwd(x, *ffn, dy, p, p, seeds)
    again = ffn_sublayer_bwd(x, *ffn, dy, p, p, seeds)
    torch.cuda.synchronize()
    assert (ffn_sublayer_fwd.route_launches["mma"],
            ffn_sublayer_bwd.route_launches["mma"]) == (
        before[0] + 1, before[1] + 2)
    torch.testing.assert_close(
        y.float(), ffn_sublayer_fwd_plain(x, *ffn, p, p, seeds).float(),
        **TOL[bf16])
    _ffn_replayed_close(got, x, ffn, dy, p, seeds, bf16, "ffn (mma)")
    for name, g, g2 in zip(FFN_GRADS, got, again):
        assert torch.equal(g, g2), f"{name} differs between two backwards"


@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("l", [1, 65, 240, 1024])
@pytest.mark.parametrize("d,d_ff", B2_MMA_WIDTHS)
def test_b2_mma_kernels_match_plain(cuda, d, d_ff, l, p):
    """Each of B2's tensor-core instantiations (d <= 128 and above) at
    ragged d and d_ff, L from 1 to 1024, dropout 0 and 0.3."""
    _b2_mma_case(cuda, 2 if l == 1024 else 3, l, d, d_ff, p,
                 seed=7 * d + d_ff + l)


@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("d,d_ff", [(128, 512), (96, 384), (144, 512)])
def test_b2_mma_rows_off_a_16_byte_boundary(cuda, d, d_ff, p):
    """x and dy whose storage starts 2 bytes past a 16-byte boundary: the
    kernels read them element by element."""
    _b2_mma_case(cuda, 3, 65, d, d_ff, p, seed=d + d_ff, offset=1)


@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("b,l,d,d_ff", [(3, 70, 8, 72), (2, 65, 100, 1000),
                                        (1, 1, 256, 1000)])
def test_b2_mma_edge_shapes(cuda, b, l, d, d_ff, p):
    """d < 16 (padded to one 16-column step) and d_ff short of a whole
    64-unit chunk; d not a whole step with d_ff 1000; one row at the widest
    d."""
    _b2_mma_case(cuda, b, l, d, d_ff, p, seed=d + d_ff + l)


def test_b2_routes_count_their_launches(cuda):
    """bf16 takes the tensor cores, fp32 the SIMT kernels: each route counts
    its own launches, the totals count both; the SIMT kernels also take
    bf16 when asked by name (B10's reference chain)."""
    gen = torch.Generator().manual_seed(6)
    d, d_ff = 128, 512
    ffn = _params(gen, [((d,), 1, 0.1), ((d,), 0, 0.1),
                        ((d, d_ff), 0, d ** -0.5), ((d_ff,), 0, 0.1),
                        ((d_ff, d), 0, d_ff ** -0.5), ((d,), 0, 0.1)], cuda)
    for dtype, way in ((torch.bfloat16, "mma"), (torch.float32, "simt")):
        assert ffn_route(dtype, d, d_ff) == way
        x = torch.randn(2, 33, d, generator=gen).to(dtype).to(cuda)
        fwd_before = dict(ffn_sublayer_fwd.route_launches)
        bwd_before = dict(ffn_sublayer_bwd.route_launches)
        totals = (ffn_sublayer_fwd.launches, ffn_sublayer_bwd.launches)
        xx = x.clone().requires_grad_()
        ffn_sublayer(xx, *ffn).float().sum().backward()
        torch.cuda.synchronize()
        for k, before in ((ffn_sublayer_fwd, fwd_before),
                          (ffn_sublayer_bwd, bwd_before)):
            assert k.route_launches == {**before, way: before[way] + 1}
        assert (ffn_sublayer_fwd.launches, ffn_sublayer_bwd.launches) == (
            totals[0] + 1, totals[1] + 1)
    x = torch.randn(2, 33, d, generator=gen).to(torch.bfloat16).to(cuda)
    before = ffn_sublayer_fwd.route_launches["simt"]
    y = ffn_launch_fwd("simt", x, *ffn)
    assert ffn_sublayer_fwd.route_launches["simt"] == before + 1
    torch.testing.assert_close(y.float(), ffn_sublayer_fwd_plain(x, *ffn)
                               .float(), **TOL[torch.bfloat16])
    with pytest.raises(ValueError, match="no 'mma' kernels"):
        ffn_launch_fwd("mma", x.float(), *ffn)


# (d_model, h) of each head width of B1's bf16 tensor-core kernels: d_k 8,
# 20, 32 (padded to 32), 36, 48 (to 64), 72, 100, 128 (to 128); 20, 36 and
# 100 leave rows off a 16-byte boundary
B1_MMA_WIDTHS = [(32, 4), (80, 4), (128, 4), (144, 4), (96, 2), (144, 2),
                 (100, 1), (256, 2)]


def _b1_mma_case(cuda, b, l, d, h, p, seed, offset=0):
    """B1 in bf16 through its tensor-core route against the plain version:
    the forward, the backward on the forward's saved state (qkv moved
    ``offset`` elements off a 16-byte boundary), a second backward bit for
    bit; slate 0 fully padded."""
    gen = torch.Generator().manual_seed(seed)
    bf16 = torch.bfloat16
    x = torch.randn(b, l, d, generator=gen).to(bf16).to(cuda)
    dy = torch.randn(b, l, d, generator=gen).to(bf16).to(cuda)
    lengths = torch.randint(1, l + 1, (b,), generator=gen)
    lengths[0] = 0
    mask = (torch.arange(l)[None, :] >= lengths[:, None]).to(cuda)
    attn = _params(gen, [((d,), 1, 0.1), ((d,), 0, 0.1),
                         ((d, 3 * d), 0, d ** -0.5), ((3 * d,), 0, 0.1),
                         ((d, d), 0, d ** -0.5), ((d,), 0, 0.1)], cuda)
    seeds = (21, 22)
    before = (attention_sublayer_fwd.route_launches["mma"],
              attention_sublayer_bwd.route_launches["mma"])
    y, (qkv, stats) = attention_sublayer_fwd(x, mask, *attn, h, p, p, seeds,
                                             return_saved=True)
    if offset:
        flat = torch.empty(qkv.numel() + offset, dtype=bf16, device=cuda)
        moved = flat[offset:].view(qkv.shape)
        moved.copy_(qkv)
        assert moved.data_ptr() % 16 != 0
        qkv = moved
    got = attention_sublayer_bwd(x, mask, *attn, dy, h, p, p, seeds,
                                 saved=(qkv, stats))
    again = attention_sublayer_bwd(x, mask, *attn, dy, h, p, p, seeds,
                                   saved=(qkv, stats))
    torch.cuda.synchronize()
    assert (attention_sublayer_fwd.route_launches["mma"],
            attention_sublayer_bwd.route_launches["mma"]) == (
        before[0] + 1, before[1] + 2)
    torch.testing.assert_close(
        y.float(), attention_sublayer_fwd_plain(x, mask, *attn, h, p, p,
                                                seeds).float(), **TOL[bf16])
    ref = attention_sublayer_bwd_plain(x, mask, *attn, dy, h, p, p, seeds)
    for name, g, r, g2 in zip(("dx", "dg", "db", "dwqkv", "dbqkv", "dwout",
                               "dbout"), got, ref, again):
        assert torch.isfinite(g.float()).all(), name
        _close(g, r, bf16, f"attention (mma) {name}")
        assert torch.equal(g, g2), f"{name} differs between two backwards"


@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("l", [1, 65, 240, 1024])
@pytest.mark.parametrize("d,h", B1_MMA_WIDTHS)
def test_b1_mma_kernels_match_plain(cuda, d, h, l, p):
    """Each of B1's tensor-core instantiations (padded d_k 32, 64, 128,
    rows aligned or not) at L from 1 to B1's longest, dropout 0 and 0.3."""
    _b1_mma_case(cuda, 2 if l == 1024 else 3, l, d, h, p, seed=7 * d + l)


@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("d,h", [(128, 4), (96, 2), (144, 2)])
def test_b1_mma_rows_off_a_16_byte_boundary(cuda, d, h, p):
    """A saved qkv whose storage starts 2 bytes past a 16-byte boundary
    takes the element-wise staging at head widths 32, 48 and 72, whose rows
    are otherwise aligned."""
    _b1_mma_case(cuda, 3, 65, d, h, p, seed=d + h, offset=1)


def test_b1_routes_count_their_launches(cuda):
    """bf16 with d_k <= 128 takes the tensor cores, fp32 and bf16 with a
    wider head the SIMT kernels: each route counts its own launches, the
    totals count both."""
    gen = torch.Generator().manual_seed(5)
    for d, h, dtype, way in ((128, 4, torch.bfloat16, "mma"),
                             (128, 4, torch.float32, "simt"),
                             (256, 1, torch.bfloat16, "simt")):
        assert route(dtype, d, h) == way
        x = torch.randn(2, 33, d, generator=gen).to(dtype).to(cuda)
        mask = torch.zeros(2, 33, dtype=torch.bool, device=cuda)
        attn = _params(gen, [((d,), 1, 0.1), ((d,), 0, 0.1),
                             ((d, 3 * d), 0, d ** -0.5), ((3 * d,), 0, 0.1),
                             ((d, d), 0, d ** -0.5), ((d,), 0, 0.1)], cuda)
        fwd_before = dict(attention_sublayer_fwd.route_launches)
        bwd_before = dict(attention_sublayer_bwd.route_launches)
        totals = (attention_sublayer_fwd.launches,
                  attention_sublayer_bwd.launches)
        xx = x.clone().requires_grad_()
        attention_sublayer(xx, mask, *attn, h).float().sum().backward()
        torch.cuda.synchronize()
        for k, before in ((attention_sublayer_fwd, fwd_before),
                          (attention_sublayer_bwd, bwd_before)):
            assert k.route_launches == {**before, way: before[way] + 1}
        assert (attention_sublayer_fwd.launches,
                attention_sublayer_bwd.launches) == (totals[0] + 1,
                                                     totals[1] + 1)


@pytest.mark.parametrize("k", [None, 10])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_lambda_pair_kernels_match_plain(cuda, scheme, k):
    gen = torch.Generator().manual_seed(7)
    b, l = 6, 240
    ts = torch.randint(0, 5, (b, l), generator=gen).float()
    valid = (torch.rand(b, l, generator=gen) > 0.2).float()
    valid[-1] = 0.0  # a dummy slate
    yp = torch.randn(b, l, generator=gen) * valid
    g = (2.0 ** ts - 1.0) / 20.0
    args = [t.to(cuda) for t in (yp, ts, g, valid)]
    kw = dict(scheme=scheme, k_eff=l if k is None else k, sigma=1.0, mu=10.0,
              log_base="binary", eps=1e-10)
    loss, cnt = lambda_pairs_fwd(*args, **kw)
    ref_loss, ref_cnt = lambda_pairs_fwd_plain(*args, **kw)
    torch.testing.assert_close(cnt, ref_cnt, rtol=0, atol=0)
    torch.testing.assert_close(loss, ref_loss, rtol=2e-5, atol=1e-5)
    gout = torch.linspace(0.5, 1.5, b, device=cuda)
    ref = lambda_pairs_bwd_plain(*args, gout, **kw)
    # dyp_i = sum_j c_ij - sum_j c_ji: two fp32 sums of up to 240 terms each,
    # taken in another order, whose difference may be far smaller than
    # either; the error scales with the terms, so the absolute part does too
    torch.testing.assert_close(lambda_pairs_bwd(*args, gout, **kw), ref,
                               rtol=1e-4,
                               atol=1e-5 * ref.abs().max().item() + 1e-6)


def test_train_step_launches_every_kernel_and_learns(cuda):
    from allrank_tpu_torch.config import (
        FCConfig,
        ModelConfig,
        PostModelConfig,
        TransformerConfig,
    )
    from allrank_tpu_torch.losses import get_loss
    from allrank_tpu_torch.models.factory import LTRModel, make_model
    from allrank_tpu_torch.training import make_optimizer, make_train_step

    mdef = make_model(ModelConfig(
        fc_model=FCConfig(sizes=[32], input_norm=False, activation=None,
                          dropout=0.1),
        transformer=TransformerConfig(N=2, d_ff=64, h=2, dropout=0.3,
                                      positional_encoding=None),
        post_model=PostModelConfig(d_output=1)), 10)
    model = LTRModel(mdef, torch.Generator().manual_seed(0), device=cuda)
    loss_fn, needs_rng = get_loss("lambdaLoss")
    opt = make_optimizer("Adam", {"lr": 1e-3}, model.parameters())
    step = make_train_step(model, loss_fn,
                           {"weighing_scheme": "ndcgLoss2PP_scheme",
                            "mu": 10.0}, needs_rng, opt, None, "bfloat16")
    rng = np.random.RandomState(0)
    x = rng.randn(8, 20, 10).astype(np.float32)
    y = rng.randint(0, 5, (8, 20)).astype(np.float32)
    y[:, -4:] = -1
    indices = np.tile(np.arange(20), (8, 1))
    kernels = (attention_sublayer_fwd, attention_sublayer_bwd,
               ffn_sublayer_fwd, ffn_sublayer_bwd, lambda_pairs_fwd,
               lambda_pairs_bwd)
    losses = []
    for i in range(12):
        for k in kernels:
            k.launches = 0
        loss, n_real = step(x, y, indices)
        losses.append(loss.item())
        assert [k.launches for k in kernels] == [2, 2, 2, 2, 1, 1]
    assert np.isfinite(losses).all() and n_real.item() == 8
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def _grad_close(got, ref, what):
    """Gradient against the plain version: fp32 sums in another order
    through a 50-iteration recurrence whose gradient cancels heavily, so
    relative to the tensor's largest value."""
    assert torch.isfinite(got).all(), what
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    assert err <= 1e-4 * scale + 1e-6, f"{what}: {err} vs max|ref| {scale}"


def _records_close(a_hist, b_hist, ref_a, ref_b):
    """The scaling records: the iteration does not contract the gauge
    a -> c a, b -> b / c of a scaling pair, so rounding drifts along it
    over 50 iterations (1.2e-4 seen at L=240); P and the contracted output
    are free of the gauge and hold to 1e-4."""
    torch.testing.assert_close(a_hist, ref_a, rtol=1e-3, atol=1e-6)
    torch.testing.assert_close(b_hist, ref_b, rtol=1e-3, atol=1e-6)


def _soft_sort_inputs(n, l, seed, dev):
    gen = torch.Generator().manual_seed(seed)
    s = torch.randn(n, l, generator=gen)
    lengths = torch.randint(1, l + 1, (n,), generator=gen)
    lengths[0] = l
    if n > 1:
        lengths[-1] = 0  # a fully padded slate
    pad = (torch.arange(l)[None, :] >= lengths[:, None]).float()
    labels = torch.randint(0, 5, (n, l), generator=gen).float()
    vec = (2.0 ** labels - 1.0) * (1.0 - pad)
    dout = torch.randn(n, l, generator=gen)
    return [t.to(dev) for t in (s, pad, vec, dout)]


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("n,l", [(3, 1), (5, 70), (64, 240), (4, 512)])
def test_soft_sort_kernels_match_plain(cuda, n, l, transpose):
    s, pad, vec, dout = _soft_sort_inputs(n, l, 100 + l, cuda)
    before = (soft_sort_fwd.launches, soft_sort_bwd.launches)
    out, a_hist, b_hist = soft_sort_fwd(s, pad, vec, 1.0, 50, transpose)
    ref, ref_a, ref_b = soft_sort_fwd_plain(s, pad, vec, 1.0, 50, transpose)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    _records_close(a_hist, b_hist, ref_a, ref_b)
    ds = soft_sort_bwd(s, pad, vec, a_hist, b_hist, dout, 1.0, 50, transpose)
    ref_ds = soft_sort_bwd_plain(s, pad, vec, a_hist, b_hist, dout, 1.0, 50,
                                 transpose)
    _grad_close(ds, ref_ds, "soft-sort ds")
    assert not ds[pad > 0.5].any(), "a padded document took a gradient"
    assert (soft_sort_fwd.launches, soft_sort_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    # fixed reduction order: the same bits on a second run
    again = soft_sort_fwd(s, pad, vec, 1.0, 50, transpose)
    assert all(torch.equal(x, y) for x, y in zip((out, a_hist, b_hist),
                                                 again))
    assert torch.equal(ds, soft_sort_bwd(s, pad, vec, a_hist, b_hist, dout,
                                         1.0, 50, transpose))


def test_soft_sort_kernel_walks_more_slates_than_blocks(cuda):
    """The stochastic fold: N = S * B slates on at most one block per SM."""
    n, l = 300, 40
    s, pad, vec, dout = _soft_sort_inputs(n, l, 5, cuda)
    out, a_hist, b_hist = soft_sort_fwd(s, pad, vec, 0.7, 50, False)
    ref, *_ = soft_sort_fwd_plain(s, pad, vec, 0.7, 50, False)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    ds = soft_sort_bwd(s, pad, vec, a_hist, b_hist, dout, 0.7, 50, False)
    _grad_close(ds, soft_sort_bwd_plain(s, pad, vec, a_hist, b_hist, dout,
                                        0.7, 50, False), "soft-sort ds")


@pytest.mark.parametrize("n,l", [(3, 1), (5, 70), (8, 240), (4, 640),
                                 (2, 768)])
def test_sinkhorn_kernels_match_plain(cuda, n, l):
    gen = torch.Generator().manual_seed(l)
    lengths = torch.randint(1, l + 1, (n,), generator=gen)
    lengths[0] = l
    lengths[-1] = 0 if n > 1 else l
    pad = torch.arange(l)[None, :] >= lengths[:, None]
    m0 = torch.softmax(torch.randn(n, l, l, generator=gen) * 3.0, dim=-1)
    m0 = torch.where(pad[:, :, None] | pad[:, None, :], 0.0, m0)
    m0 = torch.where(pad[:, :, None] & pad[:, None, :], 1.0, m0).to(cuda)
    dp = torch.randn(n, l, l, generator=gen).to(cuda)
    before = (sinkhorn_fwd.launches, sinkhorn_bwd.launches)
    p, a_hist, b_hist = sinkhorn_fwd(m0, 50)
    ref_p, ref_a, ref_b = sinkhorn_fwd_plain(m0, 50)
    assert torch.isfinite(p).all()
    torch.testing.assert_close(p, ref_p, rtol=1e-4, atol=1e-4)
    _records_close(a_hist, b_hist, ref_a, ref_b)
    dm0 = sinkhorn_bwd(m0, a_hist, b_hist, dp, 50)
    _grad_close(dm0, sinkhorn_bwd_plain(m0, a_hist, b_hist, dp, 50),
                "sinkhorn dM0")
    assert (sinkhorn_fwd.launches, sinkhorn_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(p, sinkhorn_fwd(m0, 50)[0])
    assert torch.equal(dm0, sinkhorn_bwd(m0, a_hist, b_hist, dp, 50))


def _neural_step(cuda, l, b=8):
    """A train step of a small NeuralNDCG model on the card, a fresh model
    and generator per call."""
    from allrank_tpu_torch.config import (
        FCConfig,
        ModelConfig,
        PostModelConfig,
        TransformerConfig,
    )
    from allrank_tpu_torch.losses import get_loss
    from allrank_tpu_torch.models.factory import LTRModel, make_model
    from allrank_tpu_torch.training import make_optimizer, make_train_step

    mdef = make_model(ModelConfig(
        fc_model=FCConfig(sizes=[96], input_norm=False, activation=None,
                          dropout=0.0),
        transformer=TransformerConfig(N=2, d_ff=384, h=1, dropout=0.1,
                                      positional_encoding=None),
        post_model=PostModelConfig(d_output=1, output_activation="Tanh")),
        10)
    model = LTRModel(mdef, torch.Generator().manual_seed(0), device=cuda)
    loss_fn, needs_rng = get_loss("neuralNDCG")
    assert needs_rng
    step = make_train_step(
        model, loss_fn, {"temperature": 1.0, "k": None}, needs_rng,
        make_optimizer("Adam", {"lr": 1e-3}, model.parameters()), None,
        "bfloat16", generator=torch.Generator().manual_seed(1))
    rng = np.random.RandomState(0)
    x = rng.randn(b, l, 10).astype(np.float32)
    y = rng.randint(0, 5, (b, l)).astype(np.float32)
    y[:, -l // 4:] = -1
    y[-1] = -1  # a fully padded slate
    indices = np.tile(np.arange(l), (b, 1))
    return model, lambda: step(x, y, indices)


def test_neural_ndcg_step_gives_the_same_bits_twice(cuda):
    """Two runs of the NeuralNDCG train step from the same generator state:
    no atomics anywhere on the path, so the same loss and weights."""
    runs = []
    kernels = (soft_sort_fwd, soft_sort_bwd, sinkhorn_fwd, sinkhorn_bwd)
    for _ in range(2):
        model, step = _neural_step(cuda, 240)
        for k in kernels:
            k.launches = 0
        losses = [step()[0].item() for _ in range(3)]
        assert [k.launches for k in kernels] == [3, 3, 0, 0]
        runs.append((losses, [p.detach().clone()
                              for p in model.parameters()]))
    (l1, w1), (l2, w2) = runs
    assert np.isfinite(l1).all() and l1 == l2
    assert all(torch.equal(a, b) for a, b in zip(w1, w2))


def test_neural_ndcg_long_slates_run_the_sinkhorn_kernel(cuda):
    """512 < L <= 768: the materialised chain through the Sinkhorn kernel."""
    model, step = _neural_step(cuda, 640, b=4)
    kernels = (soft_sort_fwd, soft_sort_bwd, sinkhorn_fwd, sinkhorn_bwd)
    for k in kernels:
        k.launches = 0
    loss, _ = step()
    assert np.isfinite(loss.item())
    assert [k.launches for k in kernels] == [0, 0, 1, 1]
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_neural_ndcg_loss_on_the_card_matches_the_cpu(cuda):
    """The fused kernel's loss and gradient against the CPU's plain chain
    (which freezes at tolerance 1e-6, so beyond fp32 rounding the two differ
    by what the iterations after convergence still move)."""
    from allrank_tpu_torch.losses.neuralndcg import (
        neuralNDCG,
        neuralNDCG_transposed,
    )

    rng = np.random.RandomState(2)
    y_pred = rng.randn(6, 240).astype(np.float32)
    y_true = rng.randint(0, 5, (6, 240)).astype(np.float32)
    y_true[1, 100:] = -1
    y_true[5] = -1
    for fn in (neuralNDCG, neuralNDCG_transposed):
        out = []
        for dev in (cuda, torch.device("cpu")):
            p = torch.tensor(y_pred, device=dev, requires_grad=True)
            loss = fn(p, torch.tensor(y_true, device=dev), k=10)
            loss.backward()
            out.append((loss.item(), p.grad.cpu()))
        (gl, gg), (cl, cg) = out
        assert abs(gl - cl) <= 1e-4, (gl, cl)
        assert (gg - cg).abs().max() <= 1e-3 * cg.abs().max() + 1e-7


def _approx_inputs(n, l, seed, dev, scale=1.0):
    """Scores with ties, ragged 0/1 validity (slate 0 full, the last one
    empty) and a cotangent."""
    gen = torch.Generator().manual_seed(seed)
    s = torch.randn(n, l, generator=gen) * scale
    s[:, 1::7] = s[:, 0::7][:, :s[:, 1::7].shape[1]]  # tied scores
    lengths = torch.randint(1, l + 1, (n,), generator=gen)
    lengths[0] = l
    if n > 1:
        lengths[-1] = 0
    valid = (torch.arange(l)[None, :] < lengths[:, None]).float()
    u = torch.randn(n, l, generator=gen)
    return [t.to(dev) for t in (s, valid, u)]


@pytest.mark.parametrize("alpha", [0.1, 1.0, 10.0])
@pytest.mark.parametrize("n,l,scale", [(3, 1, 1.0), (5, 37, 1.0),
                                       (64, 240, 1.0), (64, 240, 1e4),
                                       (2, 1308, 1.0), (2, 4096, 1.0)])
def test_approx_pos_kernels_match_plain(cuda, n, l, scale, alpha):
    """B9 against its plain version: the forward at the JAX test's own atol
    1e-5 (relative to the sums, which reach L); the gradient relative to its
    largest value (two fp32 sums of up to L terms in another order)."""
    s, valid, u = _approx_inputs(n, l, l, cuda, scale)
    eps = 1e-10
    before = (approx_pos_fwd.launches, approx_pos_bwd.launches)
    pos = approx_pos_fwd(s, valid, alpha, eps)
    ds = approx_pos_bwd(s, valid, u, alpha, eps)
    assert (approx_pos_fwd.launches, approx_pos_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ref = approx_pos_fwd_plain(s, valid, alpha, eps)
    torch.testing.assert_close(pos, ref, rtol=1e-5, atol=1e-5)
    assert not pos[valid < 0.5].any()
    _grad_close(ds, approx_pos_bwd_plain(s, valid, u, alpha, eps),
                "approx-pos ds")
    assert not ds[valid < 0.5].any(), "a padded document took a gradient"
    assert torch.equal(pos, approx_pos_fwd(s, valid, alpha, eps))
    assert torch.equal(ds, approx_pos_bwd(s, valid, u, alpha, eps))


def _pair_inputs(b, k, seed, dev):
    gen = torch.Generator().manual_seed(seed)
    ts = torch.randint(0, 5, (b, k), generator=gen).float()
    valid = (torch.rand(b, k, generator=gen) > 0.2).float()
    valid[-1] = 0.0  # a dummy slate
    yp = torch.randn(b, k, generator=gen) * valid
    g = (2.0 ** ts - 1.0) / 20.0
    return [t.to(dev) for t in (yp, ts, g, valid)]


@pytest.mark.parametrize("b,k,k_eff", [(6, 512, None), (4, 1024, 700),
                                       (3, 1308, None), (2, 4096, None)])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_tiled_lambda_kernels_match_plain(cuda, scheme, b, k, k_eff):
    """B6 against its plain version at the one-block kernel's tolerances:
    loss sums rtol 2e-5, counts exact, gradient rtol 1e-4 with an absolute
    part that scales with the largest gradient."""
    args = _pair_inputs(b, k, k, cuda)
    kw = dict(scheme=scheme, k_eff=k_eff or k, sigma=1.0, mu=10.0,
              log_base="natural" if k == 1024 else "binary", eps=1e-10)
    before = (lambda_tiled_fwd.launches, lambda_tiled_bwd.launches)
    loss, cnt = lambda_tiled_fwd(*args, **kw)
    ref_loss, ref_cnt = lambda_tiled_fwd_plain(*args, **kw)
    torch.testing.assert_close(cnt, ref_cnt, rtol=0, atol=0)
    torch.testing.assert_close(loss, ref_loss, rtol=2e-5, atol=1e-5)
    gout = torch.linspace(0.5, 1.5, b, device=cuda)
    dyp = lambda_tiled_bwd(*args, gout, **kw)
    assert (lambda_tiled_fwd.launches, lambda_tiled_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ref = lambda_tiled_bwd_plain(*args, gout, **kw)
    torch.testing.assert_close(dyp, ref, rtol=1e-4,
                               atol=1e-5 * ref.abs().max().item() + 1e-6)
    assert not dyp[-1].any(), "the dummy slate took a gradient"
    again = lambda_tiled_fwd(*args, **kw)
    assert torch.equal(loss, again[0]) and torch.equal(cnt, again[1])
    assert torch.equal(dyp, lambda_tiled_bwd(*args, gout, **kw))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_tiled_lambda_kernel_agrees_with_the_one_block_kernel(cuda, scheme):
    """At k = 384, which both cover: the same per-pair device function,
    summed in another order."""
    args = _pair_inputs(8, 384, 3, cuda)
    kw = dict(scheme=scheme, k_eff=384, sigma=1.0, mu=10.0,
              log_base="binary", eps=1e-10)
    loss, cnt = lambda_tiled_fwd(*args, **kw)
    ref_loss, ref_cnt = lambda_pairs_fwd(*args, **kw)
    assert torch.equal(cnt, ref_cnt)
    torch.testing.assert_close(loss, ref_loss, rtol=2e-5, atol=1e-5)
    gout = torch.ones(8, device=cuda)
    ref = lambda_pairs_bwd(*args, gout, **kw)
    torch.testing.assert_close(lambda_tiled_bwd(*args, gout, **kw), ref,
                               rtol=1e-4,
                               atol=1e-5 * ref.abs().max().item() + 1e-6)


def test_approx_ndcg_and_long_lambda_loss_match_the_cpu(cuda):
    """The two losses on the card (B9; B6 at L = 400) against the CPU's
    torch-op chains, value and gradient."""
    from allrank_tpu_torch.losses import approxNDCGLoss, lambdaLoss

    rng = np.random.RandomState(4)
    y_pred = rng.randn(4, 400).astype(np.float32)
    y_true = rng.randint(0, 5, (4, 400)).astype(np.float32)
    y_true[1, 150:] = -1
    y_true[3] = -1
    kernels = (approx_pos_fwd, approx_pos_bwd, lambda_tiled_fwd,
               lambda_tiled_bwd)
    for fn, kw, want in (
            (approxNDCGLoss, {"alpha": 1.0}, [1, 1, 0, 0]),
            (lambdaLoss, {"weighing_scheme": "ndcgLoss2PP_scheme"},
             [0, 0, 1, 1])):
        out = []
        for dev in (cuda, torch.device("cpu")):
            for k in kernels:
                k.launches = 0
            p = torch.tensor(y_pred, device=dev, requires_grad=True)
            loss = fn(p, torch.tensor(y_true, device=dev), **kw)
            loss.backward()
            out.append((loss.item(), p.grad.cpu()))
            if dev.type == "cuda":
                assert [k.launches for k in kernels] == want
        (gl, gg), (cl, cg) = out
        assert abs(gl - cl) <= 2e-5 * abs(cl) + 1e-6, (gl, cl)
        assert (gg - cg).abs().max() <= 1e-4 * cg.abs().max() + 1e-7


def _qkv_inputs(b, h, l, dk, dtype, dev, seed):
    """q, k, v, a cotangent and the mask: slate 0 full, the others ragged,
    the last fully padded when there are three or more."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, l, dk, generator=gen).to(dtype).to(dev)
                   for _ in range(4))
    lengths = torch.randint(1, l + 1, (b,), generator=gen)
    lengths[0] = l
    if b > 2:
        lengths[-1] = 0
    mask = (torch.arange(l)[None, :] >= lengths[:, None]).to(dev)
    return q, k, v, mask, do


def _attention_pair(kind, q, k, v, mask, do, p, seed):
    """(kernel forward, kernel grads, plain forward, plain grads)."""
    if kind == "fused":
        out, stats = attention_fused_fwd(q, k, v, mask, p, seed,
                                         return_saved=True)
        grads = attention_fused_bwd(q, k, v, mask, do, p, seed, stats=stats)
        ref = attention_fused_fwd_plain(q, k, v, mask, p, seed)
        ref_grads = attention_fused_bwd_plain(q, k, v, mask, do, p, seed)
        again = attention_fused_bwd(q, k, v, mask, do, p, seed, stats=stats)
    else:
        out, lse = tiled_attention_fwd(q, k, v, mask, p, seed,
                                       return_saved=True)
        grads = tiled_attention_bwd(q, k, v, mask, out, lse, do, p, seed)
        ref, ref_lse = tiled_attention_fwd_plain(q, k, v, mask, p, seed)
        torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
        ref_grads = tiled_attention_bwd_plain(q, k, v, mask, out, lse, do, p,
                                              seed)
        again = tiled_attention_bwd(q, k, v, mask, out, lse, do, p, seed)
    # no atomics: a second backward gives the same bits
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    return out, grads, ref, ref_grads


_ATTENTION_CASES = [
    (kind, shape, dtype, p)
    for kind in ("fused", "tiled")
    for shape in ((3, 2, 1, 16), (3, 2, 240, 72), (3, 2, 1100, 32),
                  (3, 1, 1308, 96), (1, 2, 4096, 32))
    for dtype in (torch.float32, torch.bfloat16) for p in (0.0, 0.3)]
# B5's bf16 tensor-core kernels at the edges of their envelope: one key, a
# tile and one key, past a 64 multiple near the end; d_k in each padded
# width class, rows 16-byte aligned or not: 8 and 20 (not aligned) in the
# 32 class, 36 (not aligned) and 48 in the 64 class, 72, 100 (not aligned)
# and 128 in the 128 class
_ATTENTION_CASES += [("tiled", (3, 2, l, dk), torch.bfloat16, p)
                     for l in (1, 65, 4097)
                     for dk in (8, 20, 36, 48, 72, 100, 128)
                     for p in (0.0, 0.3)]
# B4's bf16 tensor-core kernels likewise: one key, a tile and one key, and
# the split block's longest slate, whose last key tile holds 8 keys
_ATTENTION_CASES += [("fused", (3, 2, l, dk), torch.bfloat16, p)
                     for l in (1, 65, 1224)
                     for dk in (8, 20, 36, 48, 72, 100, 128)
                     for p in (0.0, 0.3)]
# one key in fp32: dQ and dK are 0 in exact arithmetic, and dP - D cancels
# to fp32 noise at most as large as the plain version's (ROADMAP Queue C3)
_ATTENTION_CASES += [(kind, (3, 2, 1, 128), torch.float32, 0.0)
                     for kind in ("fused", "tiled")]
# B4's and B5's fp32 kernels (3xTF32 on the tensor cores) at the bf16
# cases' edges: one key, a tile and one key, the longest slate of each past
# a 64 multiple, d_k in each padded width class (test_f32_rows_off_a_16_
# byte_boundary reaches the element-wise staging)
_ATTENTION_CASES += [(kind, (3, 2, l, dk), torch.float32, p)
                     for kind, lengths in (("tiled", (1, 65, 4097)),
                                           ("fused", (1, 65, 1224)))
                     for l in lengths
                     for dk in (8, 20, 36, 48, 72, 100, 128)
                     for p in (0.0, 0.3)]


@pytest.mark.parametrize("kind,shape,dtype,p", _ATTENTION_CASES)
def test_attention_kernels_match_plain(cuda, kind, shape, dtype, p):
    b, h, l, dk = shape
    q, k, v, mask, do = _qkv_inputs(b, h, l, dk, dtype, cuda, l + dk)
    fwd, bwd = ((attention_fused_fwd, attention_fused_bwd) if kind == "fused"
                else (tiled_attention_fwd, tiled_attention_bwd))
    before = (fwd.launches, bwd.launches)
    out, grads, ref, ref_grads = _attention_pair(kind, q, k, v, mask, do, p,
                                                 77)
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 2)
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        assert torch.isfinite(g.float()).all(), name
        _close(g, r, dtype, f"{kind} {name}")


@pytest.mark.parametrize("p", [0.0, 0.3])
def test_tiled_bf16_fully_padded_slate_and_ragged_tail(cuda, p):
    """B5's tensor-core kernels on a fully padded slate (every key scores
    NEG_INF_FILL, so the output averages v over the slate's L keys and lse
    rounds to NEG_INF_FILL) and a slate whose L = 100 is not a multiple of
    the 64-key tile, with 37 documents: forward, lse and gradients against
    the plain version, and a second backward bit for bit."""
    gen = torch.Generator().manual_seed(9)
    b, h, l, dk = 2, 2, 100, 32
    q, k, v, do = (torch.randn(b, h, l, dk, generator=gen)
                   .to(torch.bfloat16).to(cuda) for _ in range(4))
    mask = (torch.arange(l)[None, :] >= torch.tensor([[0], [37]])).to(cuda)
    out, lse = tiled_attention_fwd(q, k, v, mask, p, 5, return_saved=True)
    grads = tiled_attention_bwd(q, k, v, mask, out, lse, do, p, 5)
    again = tiled_attention_bwd(q, k, v, mask, out, lse, do, p, 5)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
    ref, ref_lse = tiled_attention_fwd_plain(q, k, v, mask, p, 5)
    torch.testing.assert_close(out.float(), ref.float(),
                               **TOL[torch.bfloat16])
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    assert (lse[0] == -1e9).all()
    for name, g, r in zip(("dq", "dk", "dv"), grads,
                          tiled_attention_bwd_plain(q, k, v, mask, out, lse,
                                                    do, p, 5)):
        _close(g, r, torch.bfloat16, f"tiled {name}")


@pytest.mark.parametrize("p", [0.0, 0.3])
def test_tiled_bf16_rows_off_a_16_byte_boundary(cuda, p):
    """Contiguous q, k, v and dO whose storage starts 2 bytes past a 16-byte
    boundary (d_k = 32, a multiple of 8) take B5's element-wise staging and
    match the plain version as the aligned ones do."""
    q, k, v, mask, do = _qkv_inputs(3, 2, 200, 32, torch.bfloat16, cuda, 12)

    def off(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        assert out.is_contiguous() and out.data_ptr() % 16 == 2
        return out

    q, k, v, do = map(off, (q, k, v, do))
    out, grads, ref, ref_grads = _attention_pair("tiled", q, k, v, mask, do,
                                                 p, 13)
    torch.testing.assert_close(out.float(), ref.float(),
                               **TOL[torch.bfloat16])
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        _close(g, r, torch.bfloat16, f"tiled {name}")


@pytest.mark.parametrize("kind", ["fused", "tiled"])
@pytest.mark.parametrize("dk", [20, 32, 36, 100])
@pytest.mark.parametrize("p", [0.0, 0.3])
def test_f32_rows_off_a_16_byte_boundary(cuda, kind, dk, p):
    """Contiguous fp32 q, k, v and dO whose storage starts one element (4
    bytes) past a 16-byte boundary take the element-wise staging of the
    fp32 kernels, in each padded width class (d_k 20 and 32: 32; 36: 64;
    100: 128), and match the plain version as the aligned ones do, a second
    backward bit for bit."""
    q, k, v, mask, do = _qkv_inputs(3, 2, 200, dk, torch.float32, cuda, dk)

    def off(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        assert out.is_contiguous() and out.data_ptr() % 16 == 4
        return out

    q, k, v, do = map(off, (q, k, v, do))
    out, grads, ref, ref_grads = _attention_pair(kind, q, k, v, mask, do,
                                                 p, 16)
    torch.testing.assert_close(out, ref, **TOL[torch.float32])
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        _close(g, r, torch.float32, f"{kind} {name}")


@pytest.mark.parametrize("kind", ["fused", "tiled"])
@pytest.mark.parametrize("p", [0.0, 0.3])
def test_f32_one_key_gradients_are_exactly_zero(cuda, kind, p):
    """Where a row has a single key (L = 1) dQ and dK are 0 in exact
    arithmetic; the fp32 kernels cancel dP - D exactly there (ROADMAP Queue
    C3), with and without dropout, so theirs are 0, at every head width
    class; dV is the plain version's."""
    for dk in (8, 36, 128):
        q, k, v, mask, do = _qkv_inputs(3, 2, 1, dk, torch.float32, cuda,
                                        dk + 7)
        out, (dq, dk_, dv), ref, (_, _, ref_dv) = _attention_pair(
            kind, q, k, v, mask, do, p, 21)
        assert not dq.any() and not dk_.any(), (kind, dk, p)
        _close(dv, ref_dv, torch.float32, f"{kind} dv")


@pytest.mark.parametrize("kind", ["fused", "tiled"])
def test_attention_routes_count_their_launches(cuda, kind):
    """fp32 takes the 3xTF32 kernels and bf16 the bf16 ones, each wrapper
    counting the launch under ``route``'s answer."""
    fwd, bwd = ((attention_fused_fwd, attention_fused_bwd)
                if kind == "fused" else (tiled_attention_fwd,
                                         tiled_attention_bwd))
    for dtype, way in ((torch.float32, "tf32x3"), (torch.bfloat16, "mma")):
        q, k, v, mask, do = _qkv_inputs(2, 2, 100, 32, dtype, cuda, 3)
        assert attention_route(dtype, 32) == way
        before = (dict(fwd.route_launches), dict(bwd.route_launches))
        _attention_pair(kind, q, k, v, mask, do, 0.0, 3)
        assert fwd.route_launches[way] == before[0][way] + 1
        assert bwd.route_launches[way] == before[1][way] + 2
        assert sum(fwd.route_launches.values()) == sum(
            before[0].values()) + 1


def test_tiled_attention_counts_one_launch_each_way(cuda):
    """Through ``TiledAttention`` a bf16 forward is one launch of
    ``tiled_attention_fwd`` and its backward one of ``tiled_attention_bwd``
    (whose wrapper starts both backward kernels)."""
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 2, 300, 32, generator=gen).to(torch.bfloat16)
               .to(cuda).requires_grad_() for _ in range(3))
    mask = (torch.arange(300)[None, :] >= torch.tensor([[300], [150]])).to(
        cuda)
    before = (tiled_attention_fwd.launches, tiled_attention_bwd.launches)
    out = tiled_slate_attention(q, k, v, mask, 0.3, 11)
    assert (tiled_attention_fwd.launches, tiled_attention_bwd.launches) == (
        before[0] + 1, before[1])
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert (tiled_attention_fwd.launches, tiled_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert all(torch.isfinite(t.grad.float()).all() for t in (q, k, v))


@pytest.mark.parametrize("p", [0.0, 0.3])
def test_fused_bf16_fully_padded_slate_and_ragged_tail(cuda, p):
    """B4's tensor-core kernels on a fully padded slate (every key scores
    NEG_INF_FILL: the row max is NEG_INF_FILL, the sum L, so the output
    averages v over the slate's L keys) and a slate whose L = 100 is not a
    multiple of the 64-key tile, with 37 documents: forward and gradients
    against the plain version, and a second backward bit for bit."""
    gen = torch.Generator().manual_seed(19)
    b, h, l, dk = 2, 2, 100, 32
    q, k, v, do = (torch.randn(b, h, l, dk, generator=gen)
                   .to(torch.bfloat16).to(cuda) for _ in range(4))
    mask = (torch.arange(l)[None, :] >= torch.tensor([[0], [37]])).to(cuda)
    out, stats = attention_fused_fwd(q, k, v, mask, p, 5, return_saved=True)
    grads = attention_fused_bwd(q, k, v, mask, do, p, 5, stats=stats)
    again = attention_fused_bwd(q, k, v, mask, do, p, 5, stats=stats)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(grads, again))
    assert (stats[0, ..., 0] == -1e9).all() and (stats[0, ..., 1] == l).all()
    torch.testing.assert_close(
        out.float(), attention_fused_fwd_plain(q, k, v, mask, p, 5).float(),
        **TOL[torch.bfloat16])
    for name, g, r in zip(("dq", "dk", "dv"), grads,
                          attention_fused_bwd_plain(q, k, v, mask, do, p, 5)):
        _close(g, r, torch.bfloat16, f"fused {name}")


@pytest.mark.parametrize("p", [0.0, 0.3])
def test_fused_bf16_rows_off_a_16_byte_boundary(cuda, p):
    """Contiguous q, k, v and dO whose storage starts 2 bytes past a 16-byte
    boundary (d_k = 32, a multiple of 8) take B4's element-wise staging and
    match the plain version as the aligned ones do."""
    q, k, v, mask, do = _qkv_inputs(3, 2, 200, 32, torch.bfloat16, cuda, 14)

    def off(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        assert out.is_contiguous() and out.data_ptr() % 16 == 2
        return out

    q, k, v, do = map(off, (q, k, v, do))
    out, grads, ref, ref_grads = _attention_pair("fused", q, k, v, mask, do,
                                                 p, 15)
    torch.testing.assert_close(out.float(), ref.float(),
                               **TOL[torch.bfloat16])
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        _close(g, r, torch.bfloat16, f"fused {name}")


def test_fused_attention_counts_one_launch_each_way(cuda):
    """Through ``FusedAttention`` a bf16 forward is one launch of
    ``attention_fused_fwd`` and its backward one of ``attention_fused_bwd``
    (whose wrapper starts both backward kernels)."""
    gen = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(2, 2, 300, 32, generator=gen).to(torch.bfloat16)
               .to(cuda).requires_grad_() for _ in range(3))
    mask = (torch.arange(300)[None, :] >= torch.tensor([[300], [150]])).to(
        cuda)
    before = (attention_fused_fwd.launches, attention_fused_bwd.launches)
    out = fused_slate_attention(q, k, v, mask, 0.3, 11)
    assert (attention_fused_fwd.launches, attention_fused_bwd.launches) == (
        before[0] + 1, before[1])
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert (attention_fused_fwd.launches, attention_fused_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert all(torch.isfinite(t.grad.float()).all() for t in (q, k, v))


@pytest.mark.parametrize("form", [
    pytest.param(fused_slate_attention, id="fused"),
    pytest.param(tiled_slate_attention, id="tiled")])
def test_split_block_matches_the_b1_block(cuda, form):
    """At L=512, p=0.3 and the same seeds the split block with B4 or B5
    computes the B1 block's function with its masks: forward and gradients
    (on slates with a valid document each) within the kernels' tolerances."""
    from allrank_tpu_torch.models.transformer import (
        EncoderBlock,
        TransformerDef,
    )

    d, h, l = 128, 4, 512
    block = EncoderBlock(TransformerDef(N=1, d_model=d, d_ff=512, h=h,
                                        dropout=0.3),
                         torch.Generator().manual_seed(0)).to(cuda)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4, l, d, generator=gen).to(cuda)
    lengths = torch.tensor([l, 300, 17, 1])
    mask = (torch.arange(l)[None, :] >= lengths[:, None]).to(cuda)
    w = torch.randn(4, l, d, generator=gen).to(cuda)
    seeds = (5, 6, 7, 8)
    runs = []
    for f in (None, form):
        block.zero_grad()
        xx = x.clone().requires_grad_()
        y = block(xx, mask, 0.3, seeds, f)
        (y * w).sum().backward()
        runs.append([y.detach(), xx.grad]
                    + [p.grad.clone() for p in block.parameters()])
    torch.testing.assert_close(runs[1][0], runs[0][0], **TOL[torch.float32])
    for g, r in zip(runs[1][1:], runs[0][1:]):
        _close(g, r, torch.float32, f"split block {form.__name__}")


def test_long_slate_scorer_launches_the_attention_kernels(cuda):
    from allrank_tpu_torch.config import (
        FCConfig,
        ModelConfig,
        PostModelConfig,
        TransformerConfig,
    )
    from allrank_tpu_torch.models.factory import LTRModel, make_model
    from allrank_tpu_torch.serving import make_scorer

    mdef = make_model(ModelConfig(
        fc_model=FCConfig(sizes=[32], input_norm=True, activation="ReLU",
                          dropout=0.0),
        transformer=TransformerConfig(N=3, d_ff=64, h=2, dropout=0.0,
                                      positional_encoding=None),
        post_model=PostModelConfig(d_output=1)), 10)
    model = LTRModel(mdef, torch.Generator().manual_seed(0), device="cpu")
    kernels = (attention_sublayer_fwd, attention_fused_fwd,
               tiled_attention_fwd, ffn_sublayer_fwd)
    for l, want in ((1100, [0, 3, 0, 3]), (1300, [0, 0, 3, 3])):
        x = np.random.RandomState(l).randn(3, l, 10).astype(np.float32)
        lengths = np.array([l, 400, 0])
        ref = make_scorer(model, device="cpu")(x, lengths).numpy()
        scorer = make_scorer(model, device=cuda)
        for kernel in kernels:
            kernel.launches = 0
        got = scorer(x, lengths).cpu().numpy()
        assert [kernel.launches for kernel in kernels] == want
        valid = ~np.isneginf(ref)
        assert (np.isneginf(got) == ~valid).all() and not np.isnan(got).any()
        np.testing.assert_allclose(got[valid], ref[valid], rtol=1e-4,
                                   atol=1e-4)
    with pytest.raises(NotImplementedError, match="L <= 8192"):
        make_scorer(model, device=cuda)(np.zeros((1, 8193, 10), np.float32),
                                        [5])


@pytest.mark.parametrize("mode", ["static", "static_channels", "dynamic"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(512, 136, 128), (300, 128, 384),
                                   (64, 512, 128), (240, 128, 1), (1, 1, 1),
                                   (17, 33, 7), (65, 64, 65)])
def test_q8_dense_kernel_is_its_plain_version(cuda, m, k, n, dtype, mode):
    """X1 against its plain version bit for bit: int32 sums are exact and
    every rounding of the epilogue happens at the same place."""
    gen = torch.Generator().manual_seed(m * 7 + k * 3 + n)
    x = torch.randn(m, k, generator=gen) * 3
    x[::2] = (torch.randint(-300, 300, x[::2].shape, generator=gen) + 0.5) / 4
    x[m // 2] = 0.0  # an all-zero row
    x = x.to(dtype).to(cuda)
    w_t = torch.randint(-127, 128, (n, k), generator=gen,
                        dtype=torch.int8).to(cuda)
    scale = (torch.rand(n, generator=gen) * 0.01).to(cuda)
    b = torch.randn(n, generator=gen).to(cuda)
    inv = {"static": torch.tensor(4.0),
           "static_channels": torch.rand(k, generator=gen) * 30 + 1,
           "dynamic": None}[mode]
    inv = None if inv is None else inv.to(cuda)
    before = q8_dense.launches
    y = q8_dense(x, w_t, scale, b, inv)
    torch.cuda.synchronize()
    assert q8_dense.launches == before + 1
    ref = q8_dense_plain(x, w_t, scale, b, inv)
    assert y.dtype == ref.dtype == (torch.float32 if mode == "dynamic"
                                    else dtype)
    assert torch.equal(y, ref)


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_quantized_scorer_launches_x1_and_the_attention_kernels(cuda, mode):
    from allrank_tpu_torch.config import (
        FCConfig,
        ModelConfig,
        PostModelConfig,
        TransformerConfig,
    )
    from allrank_tpu_torch.models.factory import LTRModel, make_model
    from allrank_tpu_torch.quant import calibrate_activations
    from allrank_tpu_torch.serving import make_scorer

    mdef = make_model(ModelConfig(
        fc_model=FCConfig(sizes=[32], input_norm=True, activation="ReLU",
                          dropout=0.0),
        transformer=TransformerConfig(N=3, d_ff=64, h=2, dropout=0.0,
                                      positional_encoding=None),
        post_model=PostModelConfig(d_output=1)), 10)
    model = LTRModel(mdef, torch.Generator().manual_seed(0), device="cpu")
    kernels = (q8_dense, attention_fused_fwd, tiled_attention_fwd,
               attention_sublayer_fwd, ffn_sublayer_fwd)
    for l, want in ((20, [14, 3, 0, 0, 0]), (1300, [14, 0, 3, 0, 0])):
        rng = np.random.RandomState(l)
        x = rng.randn(3, l, 10).astype(np.float32)
        lengths = np.array([l, l // 3, 0])
        scales = (calibrate_activations(model, [(x, np.maximum(lengths, 1))])
                  if mode == "int8_static" else None)
        ref = make_scorer(model, "bfloat16", device="cpu", quantize=mode,
                          act_scales=scales)(x, lengths).numpy()
        scorer = make_scorer(model, "bfloat16", device=cuda, quantize=mode,
                             act_scales=scales)
        for kernel in kernels:
            kernel.launches = 0
        got = scorer(x, lengths).cpu().numpy()
        assert [kernel.launches for kernel in kernels] == want
        valid = ~np.isneginf(ref)
        assert (np.isneginf(got) == ~valid).all() and not np.isnan(got).any()
        # the attention core runs in bf16 on the card, fp32 on the CPU
        scale = np.abs(ref[valid]).max()
        assert np.abs(got[valid] - ref[valid]).max() <= 0.05 * scale
        model.to("cpu")
    scorer = make_scorer(model, device=cuda, quantize="int8")
    q8_dense.launches = 0
    with pytest.raises(NotImplementedError, match="L <= 8192"):
        scorer(np.zeros((1, 8193, 10), np.float32), [5])
    assert q8_dense.launches == 0  # refused before any launch


# ---------------------------------------------------------------------------
# B10, the whole-encoder kernel pair


def _encoder_inputs(gen, b, l, d, h, d_ff, n, dtype, dev):
    """x, dy, the key mask (ragged lengths, slate 0 empty), 4N seeds, the
    12 stacked weights and the final LN pair."""
    x = torch.randn(b, l, d, generator=gen).to(dtype).to(dev)
    dy = torch.randn(b, l, d, generator=gen).to(dtype).to(dev)
    lengths = torch.randint(1, l + 1, (b,), generator=gen)
    lengths[0] = 0
    mask = (torch.arange(l)[None, :] >= lengths[:, None]).to(dev)
    shapes = [((d,), 1, 0.1), ((d,), 0, 0.1), ((d, 3 * d), 0, d ** -0.5),
              ((3 * d,), 0, 0.1), ((d, d), 0, d ** -0.5), ((d,), 0, 0.1),
              ((d,), 1, 0.1), ((d,), 0, 0.1), ((d, d_ff), 0, d ** -0.5),
              ((d_ff,), 0, 0.1), ((d_ff, d), 0, d_ff ** -0.5),
              ((d,), 0, 0.1)]
    stacks = _params(gen, [((n,) + shape, c, sc) for shape, c, sc in shapes],
                     dev)
    fs, fb = _params(gen, [((d,), 1, 0.1), ((d,), 0, 0.1)], dev)
    seeds = tuple(range(100, 100 + 4 * n))
    return x, dy, mask, seeds, stacks, fs, fb


def _encoder_chained(x, mask, seeds, stacks, fs, fb, dy, h, p, way="simt"):
    """The same function through the chained B1/B2 kernels of route ``way``:
    by default B10's own tile bodies (both on their SIMT routes, in bf16
    too), ``"mma"`` the tensor cores as the encoder runs them with the
    switch off in bf16; the final LayerNorm in torch ops: (y, (dx, *12
    stacked gradients, dfs, dfb))."""
    from allrank_tpu_torch.models.core import std_layer_norm
    from allrank_tpu_torch.ops.attention_block import launch_bwd, ln_backward

    n_blocks = stacks[0].shape[0]
    inputs, saved = [], []
    for n in range(n_blocks):
        w = [s[n] for s in stacks]
        inputs.append(x)
        x, sv = launch_fwd(way, x, mask, *w[:6], h, p, p,
                           seeds[4 * n:4 * n + 2], return_saved=True)
        saved.append(sv)
        inputs.append(x)
        x = ffn_launch_fwd(way, x, *w[6:], p, p, seeds[4 * n + 2:4 * n + 4])
    y = std_layer_norm(x, fs, fb)
    dz, dfs, dfb = ln_backward(x.float(), fs, dy.float())
    g = dz.to(x.dtype)
    grads = [[None] * n_blocks for _ in range(12)]
    for n in reversed(range(n_blocks)):
        w = [s[n] for s in stacks]
        g, *ffn = ffn_launch_bwd(way, inputs[2 * n + 1], *w[6:], g, p, p,
                                 seeds[4 * n + 2:4 * n + 4])
        g, *attn = launch_bwd(way, inputs[2 * n], mask, *w[:6], g, h, p,
                              p, seeds[4 * n:4 * n + 2], saved=saved[n])
        for i, t in enumerate(attn + ffn):
            grads[i][n] = t
    return y, (g, *(torch.stack(t) for t in grads), dfs, dfb)


def _no_further(got, chained, ref, dtype, what, forward=False):
    """B10 against the plain version through N blocks: at most the chained
    B1/B2 kernels' own distance from it plus the sublayer tolerance. Each
    sublayer kernel is held to its plain version on the same inputs
    (test_kernels_match_plain, test_backward_kernels_match_plain); through
    a chain the two drift apart by more: an fp32 rounding difference
    upstream flips a ReLU gate whose pre-activation lies near 0 (a jump of
    the gradient, some 0.1 in dx at the flagship shape), and in bf16 one-ulp
    rounding flips compound block by block."""
    scale = ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    base = (chained.float() - ref.float()).abs().max().item()
    if forward:
        tol = TOL[dtype]["atol"] + TOL[dtype]["rtol"] * scale
    else:
        tol = (1e-4 * scale + 1e-6 if dtype == torch.float32
               else 2 ** -5 * scale + 1e-6)
    assert err <= base + tol, (
        f"{what}: max|err| {err} > chained's {base} + {tol}")


# ROADMAP Queue C4's case (B, L, d, h, d_ff, N) and its rule: B10 in bf16
# is no fault if it lies no farther from the fp32 plain chain on the same
# bf16 inputs and masks than the tensor-core chain the encoder runs with the
# switch off does (at most 1.5x its distance)
C4_CASE, C4_RATIO = (8, 240, 144, 2, 384, 2), 1.5


def _worst_share(got, ref):
    """The largest max-abs error of ``got`` against ``ref``, tensor by
    tensor, as a share of the reference tensor's largest value."""
    return max((g.float() - r.float()).abs().max().item()
               / (r.float().abs().max().item() + 1e-30)
               for g, r in zip(got, ref))


ENCODER_GRADS = ("dx", "dln1_s", "dln1_b", "dwqkv", "dbqkv", "dwout",
                 "dbout", "dln2_s", "dln2_b", "dw1", "db1", "dw2", "db2",
                 "dfinal_s", "dfinal_b")


@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,d,h,d_ff,n", [(3, 70, 64, 2, 128, 2),
                                            (64, 240, 128, 4, 512, 4),
                                            C4_CASE])
def test_encoder_kernels_match_plain_and_chained(cuda, b, l, d, h, d_ff, n,
                                                 dtype, p):
    gen = torch.Generator().manual_seed(b + l)
    x, dy, mask, seeds, stacks, fs, fb = _encoder_inputs(
        gen, b, l, d, h, d_ff, n, dtype, cuda)
    kw = dict(h=h, p_drop=p)
    before = (encoder_block_fwd.launches, encoder_block_bwd.launches)
    y = encoder_block_fwd(x, mask, seeds, stacks, fs, fb, **kw)
    got = encoder_block_bwd(x, mask, seeds, stacks, fs, fb, dy, **kw)
    torch.cuda.synchronize()
    assert (encoder_block_fwd.launches, encoder_block_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert y.dtype == dtype and torch.isfinite(y.float()).all()
    assert got[0].dtype == dtype
    # against the chained kernels whose tile bodies B10 runs (B1's SIMT
    # route): the sublayer tolerances (only the final LayerNorm is computed
    # another way)
    chained_y, chained = _encoder_chained(x, mask, seeds, stacks, fs, fb, dy,
                                          h, p)
    torch.testing.assert_close(y.float(), chained_y.float(), **TOL[dtype])
    for name, g, c in zip(ENCODER_GRADS, got, chained):
        assert g.shape == c.shape and torch.isfinite(g.float()).all(), name
        _close(g, c, dtype, f"B10 vs chained {name}")
    # against the plain version: no further than the chained kernels are
    ref_y = encoder_forward_plain(x, mask, seeds, stacks, fs, fb, **kw)
    _no_further(y, chained_y, ref_y, dtype, "B10 y", forward=True)
    ref = encoder_backward_plain(x, mask, seeds, stacks, fs, fb, dy, **kw)
    for name, g, c, r in zip(ENCODER_GRADS, got, chained, ref):
        _no_further(g, c, r, dtype, f"B10 {name}")
    # no atomics: a second backward gives the same bits
    again = encoder_block_bwd(x, mask, seeds, stacks, fs, fb, dy, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    if (b, l, d, h, d_ff, n) == C4_CASE and dtype == torch.bfloat16:
        # C4: B10, the tensor-core chain and the SIMT chain against the
        # fp32 plain chain on the same bf16 inputs and masks
        _, mma = _encoder_chained(x, mask, seeds, stacks, fs, fb, dy, h, p,
                                  way="mma")
        ref32 = encoder_backward_plain(x.float(), mask, seeds, stacks, fs,
                                       fb, dy.float(), **kw)
        shares = [_worst_share(t, ref32) for t in (got, mma, chained)]
        assert shares[0] <= C4_RATIO * shares[1], (
            f"C4: B10 {shares[0]:.4f} of the reference's max, the "
            f"tensor-core chain {shares[1]:.4f}, the SIMT chain "
            f"{shares[2]:.4f}")


def test_encoder_cooperative_grid_fits_the_card(cuda):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for backward in (False, True):
        for d in (128, 256):
            g = cooperative_grid(d, torch.float32, backward)
            assert g["sms"] == sms and g["blocks_per_sm"] >= 1
            assert g["grid"] == g["blocks_per_sm"] * sms
            assert g["smem_bytes"] <= 227 * 1024


def test_encoder_switch_launches_b10_alone(cuda, monkeypatch):
    import allrank_tpu_torch.models.transformer as transformer
    from allrank_tpu_torch.config import (
        FCConfig,
        ModelConfig,
        PostModelConfig,
        TransformerConfig,
    )
    from allrank_tpu_torch.losses import get_loss
    from allrank_tpu_torch.models.factory import LTRModel, make_model
    from allrank_tpu_torch.serving import make_scorer
    from allrank_tpu_torch.training import make_optimizer, make_train_step

    mdef = make_model(ModelConfig(
        fc_model=FCConfig(sizes=[32], input_norm=True, activation="ReLU",
                          dropout=0.0),
        transformer=TransformerConfig(N=3, d_ff=64, h=2, dropout=0.3,
                                      positional_encoding=None),
        post_model=PostModelConfig(d_output=1)), 10)
    model = LTRModel(mdef, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(0)
    x = rng.randn(4, 20, 10).astype(np.float32)
    lengths = np.array([20, 7, 0, 1])
    ref = make_scorer(model, device="cpu")(x, lengths).numpy()
    kernels = (encoder_block_fwd, encoder_block_bwd, attention_sublayer_fwd,
               attention_sublayer_bwd, ffn_sublayer_fwd, ffn_sublayer_bwd)
    monkeypatch.setattr(transformer, "MEGA_ENCODER_ENABLED", True)
    scorer = make_scorer(model, device=cuda)
    for k in kernels:
        k.launches = 0
    got = scorer(x, lengths).cpu().numpy()
    assert [k.launches for k in kernels] == [1, 0, 0, 0, 0, 0]
    valid = ~np.isneginf(ref)
    assert (np.isneginf(got) == ~valid).all() and not np.isnan(got).any()
    np.testing.assert_allclose(got[valid], ref[valid], rtol=1e-4, atol=1e-4)
    loss_fn, needs_rng = get_loss("lambdaLoss")
    step = make_train_step(model, loss_fn, {"weighing_scheme":
                                            "ndcgLoss2PP_scheme"}, needs_rng,
                           make_optimizer("Adam", {"lr": 1e-3},
                                          model.parameters()), None,
                           "bfloat16")
    y = rng.randint(0, 5, (4, 20)).astype(np.float32)
    y[:, -4:] = -1
    indices = np.tile(np.arange(20), (4, 1))
    for _ in range(3):
        for k in kernels:
            k.launches = 0
        loss, _ = step(x, y, indices)
        assert math.isfinite(loss.item())
        assert [k.launches for k in kernels] == [1, 1, 0, 0, 0, 0]
    # outside the envelope the encoder takes its chained forms
    for k in kernels:
        k.launches = 0
    make_scorer(model, device=cuda)(rng.randn(1, 1100, 10).astype(np.float32),
                                    [900])
    assert [k.launches for k in kernels] == [0, 0, 0, 0, 3, 0]


def test_encoder_kernel_refuses_outside_its_envelope(cuda):
    gen = torch.Generator().manual_seed(3)
    x, dy, mask, seeds, stacks, fs, fb = _encoder_inputs(
        gen, 1, 1025, 64, 2, 128, 1, torch.float32, cuda)
    before = (encoder_block_fwd.launches, encoder_block_bwd.launches)
    with pytest.raises(NotImplementedError, match="L <= 1024"):
        encoder_block_fwd(x, mask, seeds, stacks, fs, fb, h=2)
    with pytest.raises(NotImplementedError, match="L <= 1024"):
        encoder_block_bwd(x, mask, seeds, stacks, fs, fb, dy, h=2)
    assert (encoder_block_fwd.launches, encoder_block_bwd.launches) == before


# -- the probe kernels X2, X3, X4 ------------------------------------------------

@pytest.mark.parametrize("b,l", [(64, 240), (3, 37), (1, 1)])
def test_boundary_kernels_match_plain(cuda, b, l):
    gen = torch.Generator().manual_seed(b + l)

    def r(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to(
            torch.bfloat16).to(cuda)

    x, pre = r(b, l, 128, scale=0.5), r(b, l, 384, scale=0.5)
    w1, w2, w1n = r(128, 384, scale=0.05), r(384, 128, scale=0.05), r(
        128, 384, scale=0.05)
    before = (boundary_plain.launches, boundary_shift.launches)
    y = boundary_plain(x, w1, w2)
    out, pre_out = boundary_shift(x, pre, w2, w1n)
    torch.cuda.synchronize()
    assert (boundary_plain.launches, boundary_shift.launches) == (
        before[0] + 1, before[1] + 1)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(y.float(),
                               boundary_plain_plain(x, w1, w2).float(), **tol)
    ref_out, ref_pre = boundary_shift_plain(x, pre, w2, w1n)
    torch.testing.assert_close(out.float(), ref_out.float(), **tol)
    torch.testing.assert_close(pre_out.float(), ref_pre.float(), **tol)


@pytest.mark.parametrize("mode", MODES)
def test_attention_variants_match_plain(cuda, mode):
    gen = torch.Generator().manual_seed(MODES.index(mode))
    b, l, d, h = 8, 240, 128, 4
    x = torch.randn(b, l, d, generator=gen).to(torch.bfloat16).to(cuda)
    lengths = torch.randint(1, l + 1, (b,), generator=gen)
    lengths[0], lengths[-1] = l, 0
    mask = (torch.arange(l)[None, :] >= lengths[:, None]).to(cuda)
    params = _params(gen, [((d,), 1, 0.1), ((d,), 0, 0.1),
                           ((d, 3 * d), 0, d ** -0.5), ((3 * d,), 0, 0.1),
                           ((d, d), 0, d ** -0.5), ((d,), 0, 0.1)], cuda)
    params = [p.to(torch.bfloat16).float() for p in params]
    before = attention_variant_fwd.launches[mode]
    y = attention_variant_fwd(x, mask, *params, h, mode=mode)
    torch.cuda.synchronize()
    assert attention_variant_fwd.launches[mode] == before + 1
    torch.testing.assert_close(
        y.float(), attention_variant_fwd_plain(x, mask, *params, h,
                                               mode=mode).float(),
        **TOL[torch.bfloat16])
    if mode == "full":  # B1's SIMT body; B1's tensor-core forward
        assert torch.equal(y, launch_fwd("simt", x, mask, *params, h))
        torch.testing.assert_close(
            y.float(), attention_sublayer_fwd(x, mask, *params, h).float(),
            **TOL[torch.bfloat16])


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("n,l", [(64, 240), (5, 259), (3, 1)])
def test_layout_soft_sort_is_b8_bit_for_bit(cuda, n, l, transpose):
    gen = torch.Generator().manual_seed(n + l)
    s = torch.randn(n, l, generator=gen).to(cuda)
    lengths = torch.randint(1, l + 1, (n,), generator=gen)
    lengths[0], lengths[-1] = l, 0
    pad = (torch.arange(l)[None, :] >= lengths[:, None]).float().to(cuda)
    vec = torch.rand(n, l, generator=gen).to(cuda)
    dout = torch.randn(n, l, generator=gen).to(cuda)
    before = (layout_soft_sort_fwd.launches, layout_soft_sort_bwd.launches)
    got = layout_soft_sort_fwd(s, pad, vec, 1.0, 50, transpose)
    ds = layout_soft_sort_bwd(s, pad, vec, *got[1:], dout, 1.0, 50,
                              transpose)
    torch.cuda.synchronize()
    assert (layout_soft_sort_fwd.launches, layout_soft_sort_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want = soft_sort_fwd(s, pad, vec, 1.0, 50, transpose)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert torch.equal(ds, soft_sort_bwd(s, pad, vec, *want[1:], dout, 1.0,
                                         50, transpose))
    torch.testing.assert_close(
        got[0], soft_sort_fwd_plain(s, pad, vec, 1.0, 50, transpose)[0],
        rtol=1e-4, atol=1e-4)


def test_layout_soft_sort_states_its_cap_on_the_card(cuda):
    for backward in (False, True):
        assert layout_vectors(50, backward) == smem_floats(1, 50, backward)
    l = max_length(50) + 1
    s = torch.zeros(2, l, device=cuda)
    before = layout_soft_sort_fwd.launches
    with pytest.raises(ValueError, match="L <= 259"):
        layout_soft_sort_fwd(s, s, s, 1.0, 50)
    assert layout_soft_sort_fwd.launches == before
