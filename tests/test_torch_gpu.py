"""The port's CUDA kernels on the card: each against its plain version, and
the flagship scorer's launches. Every test here is marked ``gpu`` and skips
without a CUDA device (the kernels have no CPU mode).

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from allrank_tpu_torch.ops.attention_block import (
    attention_sublayer_bwd,
    attention_sublayer_bwd_plain,
    attention_sublayer_fwd,
    attention_sublayer_fwd_plain,
)
from allrank_tpu_torch.ops.ffn_block import (
    ffn_sublayer_bwd,
    ffn_sublayer_bwd_plain,
    ffn_sublayer_fwd,
    ffn_sublayer_fwd_plain,
)
from allrank_tpu_torch.ops.lambda_pairs import (
    SCHEMES,
    lambda_pairs_bwd,
    lambda_pairs_bwd_plain,
    lambda_pairs_fwd,
    lambda_pairs_fwd_plain,
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
    yp = torch.zeros(2, 385, device=cuda)
    with pytest.raises(NotImplementedError, match="B6"):
        lambda_pairs_fwd(yp, yp, yp, yp, scheme=None, k_eff=385, sigma=1.0,
                         mu=10.0, log_base="binary", eps=1e-10)


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


@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h,d_ff,l", [(128, 4, 512, 240), (96, 1, 384, 70),
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
    ref = ffn_sublayer_bwd_plain(x, *ffn, dy, p, p, seeds)
    for name, g, r in zip(("dx", "dg", "db", "dw1", "db1", "dw2", "db2"),
                          got, ref):
        assert torch.isfinite(g.float()).all(), name
        _close(g, r, dtype, f"ffn {name}")
    again = ffn_sublayer_bwd(x, *ffn, dy, p, p, seeds)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


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
