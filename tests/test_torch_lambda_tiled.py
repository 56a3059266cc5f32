"""The port's pair-tiled lambdaLoss chain (allrank_tpu_torch/ops/
lambda_tiled.py, the plain version of the kernel B6 and its autograd
Function) against the JAX package's ``tiled_lambda_pairs`` in Pallas
interpret mode, with tiles forced small so the JAX grid really spans
several row and column tiles; and the port's ``lambdaLoss`` at L = 400,
where the top-k block is longer than the one-block kernel's 384, against
the JAX loss. Tolerances are the JAX package's own
(tests/ops/test_lambda_tiled.py: atol 2e-5 / rtol 1e-4); counts are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import allrank_tpu.ops.lambda_tiled as LT
from allrank_tpu.losses.lambdaloss import lambdaLoss as jax_lambdaLoss
from allrank_tpu_torch.losses import lambdaLoss
from allrank_tpu_torch.losses import lambdaloss as port_lambdaloss
from allrank_tpu_torch.ops import lambda_tiled as port_tiled
from allrank_tpu_torch.ops.lambda_pairs import SCHEMES, fused_lambda_pairs
from allrank_tpu_torch.ops.lambda_tiled import (
    MAX_TILED_LENGTH,
    lambda_tiled_bwd,
    lambda_tiled_fwd,
    tiled_lambda_pairs,
)

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=1e-4)
EPS = 1e-10


def _pair_inputs(b=2, k=200, seed=0):
    """Sorted-block inputs as lambdaLoss hands them to the kernel; slate 1
    has a padded tail."""
    rng = np.random.RandomState(seed)
    ts = rng.randint(0, 5, size=(b, k)).astype(np.float32)
    valid = (rng.rand(b, k) > 0.15).astype(np.float32)
    valid[1, k - k // 4:] = 0.0
    yp = (rng.randn(b, k) * valid).astype(np.float32)
    g = ((2.0 ** ts - 1.0) / 23.0).astype(np.float32)
    return yp, ts, g, valid


@pytest.fixture
def small_tiles(monkeypatch):
    """128-wide tiles over the padded length (256): a 2 x 2 grid of pair
    tiles per slate block."""
    monkeypatch.setattr(LT, "_pick_tiles", lambda b, l, **kw: (b, 128, 128))
    LT._make_tiled.cache_clear()
    yield
    LT._make_tiled.cache_clear()


def _jax_tiled(yp, ts, g, valid, gout, **kw):
    def f(p):
        return LT.tiled_lambda_pairs(p, *map(jnp.asarray, (ts, g, valid)),
                                     **kw)

    with pltpu.force_tpu_interpret_mode():
        (loss, cnt), vjp = jax.vjp(f, jnp.asarray(yp))
        (grad,) = vjp((jnp.asarray(gout), jnp.zeros_like(cnt)))
    return np.asarray(loss), np.asarray(cnt), np.asarray(grad)


@pytest.mark.parametrize("k,k_eff,log_base", [(200, 200, "binary"),
                                              (256, 150, "natural")])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_tiled_chain_matches_tpu_kernel(scheme, k, k_eff, log_base,
                                        small_tiles):
    yp, ts, g, valid = _pair_inputs(k=k, seed=k)
    gout = np.array([0.5, 1.5], dtype=np.float32)
    kw = dict(scheme=scheme, k_eff=k_eff, sigma=1.0, mu=10.0,
              log_base=log_base, eps=EPS)
    ref_loss, ref_cnt, ref_grad = _jax_tiled(yp, ts, g, valid, gout, **kw)
    ypt = torch.tensor(yp, requires_grad=True)
    loss, cnt = tiled_lambda_pairs(ypt, *map(torch.tensor, (ts, g, valid)),
                                   **kw)
    loss.backward(torch.tensor(gout))
    np.testing.assert_array_equal(cnt.numpy(), ref_cnt)
    np.testing.assert_allclose(loss.detach().numpy(), ref_loss, **TOL)
    # sum_j c_ij - sum_j c_ji over up to 2k terms: the absolute part scales
    # with the largest gradient
    np.testing.assert_allclose(
        ypt.grad.numpy(), ref_grad, rtol=TOL["rtol"],
        atol=TOL["atol"] * max(1.0, float(np.abs(ref_grad).max())))
    assert not ypt.grad.numpy()[valid < 0.5].any()


def test_tiled_chain_is_the_one_block_chain_on_the_cpu():
    """One definition of the pair arithmetic: the two wrappers' plain
    versions give the same bits, and the direct forward and backward are
    what the autograd Function runs."""
    yp, ts, g, valid = map(torch.tensor, _pair_inputs(k=60))
    kw = dict(scheme="ndcgLoss2PP_scheme", k_eff=60, sigma=1.0, mu=10.0,
              log_base="binary", eps=EPS)
    a, b = tiled_lambda_pairs(yp, ts, g, valid, **kw), fused_lambda_pairs(
        yp, ts, g, valid, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    loss, cnt = lambda_tiled_fwd(yp, ts, g, valid, **kw)
    assert torch.equal(loss, a[0]) and torch.equal(cnt, a[1])
    leaf = yp.clone().requires_grad_()
    tiled_lambda_pairs(leaf, ts, g, valid, **kw)[0].sum().backward()
    assert torch.equal(leaf.grad, lambda_tiled_bwd(
        yp, ts, g, valid, torch.ones(2), **kw))
    assert MAX_TILED_LENGTH == LT.MAX_TILED_LENGTH == 4096
    with pytest.raises(ValueError, match="weighing scheme"):
        lambda_tiled_fwd(yp, ts, g, valid, **{**kw, "scheme": "nope"})
    with pytest.raises(ValueError, match="logarithm"):
        lambda_tiled_fwd(yp, ts, g, valid, **{**kw, "log_base": "ten"})


def _long_batch(b=3, n=400, seed=0):
    rng = np.random.RandomState(seed)
    y_pred = rng.randn(b, n).astype(np.float32)
    y_true = rng.randint(0, 5, size=(b, n)).astype(np.float32)
    y_true[1, n - 10:] = -1.0  # a padded tail
    y_true[2, :] = -1.0  # an all-padded slate
    return y_pred, y_true


@pytest.mark.parametrize("kw,route", [
    (dict(weighing_scheme="ndcgLoss2PP_scheme"), "tiled"),
    (dict(weighing_scheme="lambdaRank_scheme", k=390, reduction="mean"),
     "tiled"),
    (dict(weighing_scheme="ndcgLoss2_scheme", k=384), "one-block"),
    (dict(weighing_scheme="ndcgLoss2PP_scheme", k=399), "refused"),
], ids=lambda v: v if isinstance(v, str) else "-".join(
    f"{k}={x}" for k, x in v.items()))
def test_long_slate_lambda_loss_matches_jax(kw, route, monkeypatch):
    """The kernel route of the port's lambdaLoss (prep + dispatch, on the
    plain versions here) against the JAX loss: k_eff <= 384 goes to the
    one-block chain, every longer one to the tiled one. Past its length
    (4096) the tiled kernel's wrapper refuses a CUDA tensor; the last case
    has it refuse here, and the loss lets that surface and takes no
    torch-op chain instead."""
    y_pred, y_true = _long_batch()
    ref_v, ref_g = jax.value_and_grad(
        lambda p: jax_lambdaLoss(p, jnp.asarray(y_true), **kw))(
            jnp.asarray(y_pred))
    calls = []

    def spy(name):
        real = getattr(port_lambdaloss, name)

        def wrapped(*a, **k):
            calls.append(name)
            return real(*a, **k)

        monkeypatch.setattr(port_lambdaloss, name, wrapped)

    spy("fused_lambda_pairs")
    spy("tiled_lambda_pairs")
    if route == "refused":
        def refuse(*a, **k):
            raise NotImplementedError("k <= 4096")

        monkeypatch.setattr(port_lambdaloss, "tiled_lambda_pairs", refuse)
    plain = port_lambdaloss._plain_chain

    def kernel_route(*a):  # what a CUDA tensor takes
        monkeypatch.setattr(port_lambdaloss, "_plain_chain", plain)
        spy("_plain_chain")
        return port_lambdaloss._fused_chain(*a)

    monkeypatch.setattr(port_lambdaloss, "_plain_chain", kernel_route)
    p = torch.tensor(y_pred, requires_grad=True)
    if route == "refused":
        with pytest.raises(NotImplementedError, match="k <= 4096"):
            lambdaLoss(p, torch.tensor(y_true), **kw)
        assert calls == []
        return
    loss = lambdaLoss(p, torch.tensor(y_true), **kw)
    loss.backward()
    assert calls == [{"tiled": "tiled_lambda_pairs",
                      "one-block": "fused_lambda_pairs"}[route]]
    np.testing.assert_allclose(loss.item(), float(ref_v), rtol=2e-5)
    np.testing.assert_allclose(
        p.grad.numpy(), np.asarray(ref_g), rtol=TOL["rtol"],
        atol=TOL["atol"] * max(1.0, float(np.abs(ref_g).max())))
    assert not p.grad[-1].any()  # the all-padded slate
    assert port_tiled.lambda_tiled_fwd.launches == 0  # no card here


def test_scratch_tiles_are_the_kernels_rows_per_block():
    """The wrapper sizes the forward's [2, blocks + 1, B] buffer and the
    backward's [B, stripes + tiles, k] scratch from its own constants; the
    kernel's grid comes from the source's."""
    import os
    import re

    src = os.path.join(os.path.dirname(port_tiled.__file__), os.pardir, "csrc",
                       "lambda_tiled.cu")
    with open(src) as f:
        text = f.read()
    for name, value in (("kTileRows", port_tiled.TILE_ROWS),
                        ("kShortTileRows", port_tiled.SHORT_TILE_ROWS),
                        ("kShortK", port_tiled.SHORT_LENGTH),
                        ("kMaxStripe", port_tiled.MAX_STRIPE)):
        found = re.search(rf"constexpr int {name} = (\d+);", text)
        assert int(found.group(1)) == value, name


@pytest.mark.parametrize("k,plan", [
    (1, (1, 1, 32, 16)), (33, (3, 1, 64, 16)), (240, (15, 1, 256, 16)),
    (385, (25, 1, 416, 16)), (1024, (64, 2, 512, 16)),
    (1025, (33, 3, 352, 32)), (1200, (38, 3, 416, 32)),
    (1308, (41, 3, 448, 32)), (4096, (128, 8, 512, 32))])
def test_tile_plan_covers_every_row_and_column_once(k, plan):
    """The kernels' grid at top-k length k: tiles of 16 rows to 1024, 32
    beyond; stripes of equal width (whole warps) no wider than 512 that
    cover the k columns, none of them empty."""
    tiles, stripes, width, rows = port_tiled.tile_plan(k)
    assert (tiles, stripes, width, rows) == plan
    assert (tiles - 1) * rows < k <= tiles * rows
    assert width % 32 == 0 and width <= port_tiled.MAX_STRIPE
    assert (stripes - 1) * width < k <= stripes * width


@pytest.mark.parametrize("k", [0, MAX_TILED_LENGTH + 1])
def test_tile_plan_refuses_lengths_past_the_envelope(k):
    with pytest.raises(ValueError, match="no tile plan"):
        port_tiled.tile_plan(k)
