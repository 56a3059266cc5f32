"""The port's approxNDCG rank sum (allrank_tpu_torch/ops/approx_pos.py, the
plain version of the kernel B9 and its autograd Function) against the JAX
package: the TPU kernel ``fused_approx_pos`` in Pallas interpret mode and
the XLA chain, at the JAX tests' own tolerances (tests/ops/
test_approx_pallas.py: atol 1e-5, gradient atol 1e-5 / rtol 1e-5); and
``approxNDCGLoss`` through both of the port's rank-sum paths against the
JAX loss."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from allrank_tpu.losses.approxndcg import approxNDCGLoss as jax_loss
from allrank_tpu.ops.approx_pallas import fused_approx_pos as jax_fused
from allrank_tpu_torch.losses import approxndcg as port_approx
from allrank_tpu_torch.losses import approxNDCGLoss
from allrank_tpu_torch.ops.approx_pos import (
    MAX_LENGTH,
    approx_pos_bwd_plain,
    approx_pos_fwd_plain,
    fused_approx_pos,
)

torch.set_num_threads(2)

EPS = 1e-10
VALUE = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _xla_pos_sum(s, valid, alpha, eps):
    n = s.shape[1]
    pv = (valid[:, :, None] & valid[:, None, :]) & (
        ~jnp.eye(n, dtype=bool))[None, :, :]
    d = jnp.where(pv, s[:, :, None] - s[:, None, :], 0.0)
    return jnp.sum(pv.astype(jnp.float32) * jnp.maximum(
        jax.nn.sigmoid(-alpha * d), eps), axis=-1)


def _case(b=4, n=40, seed=0, scale=1.0, ties=False, scattered=False):
    """Sorted-slate inputs as the loss hands them to the kernel: scores,
    0/1 validity with ragged lengths and one empty slate, a cotangent.
    ``scattered``: validity at random places instead of a prefix (slate 0
    some 70 % valid, slate 1 one document, slate 2 full, slate 3 empty),
    which the loss never hands over but the JAX function takes."""
    rng = np.random.RandomState(seed)
    s = (rng.randn(b, n) * scale).astype(np.float32)
    if ties:
        s = np.round(s)
    lengths = np.array([n, max(n - 3, 0), n // 2, 0][:b])
    valid = np.arange(n)[None, :] < lengths[:, None]
    u = rng.randn(b, n).astype(np.float32)
    if scattered:
        valid = rng.rand(b, n) < 0.7
        valid[1:] = False
        valid[1, n // 2] = True
        valid[2] = True
    return s, valid, u


CASES = [dict(alpha=1.0), dict(alpha=4.0), dict(alpha=0.1, ties=True),
         dict(alpha=10.0, scale=1e4), dict(alpha=1.0, n=1),
         dict(alpha=2.0, n=7, seed=3), dict(alpha=1.5, scattered=True),
         dict(alpha=10.0, scale=1e4, ties=True, scattered=True)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_rank_sum_matches_tpu_kernel_and_xla_chain(case):
    """Forward and backward; ±1e4 scores at alpha 10 put t below eps, where
    the clamp's branch carries no gradient."""
    case = dict(case)
    alpha = case.pop("alpha")
    s, valid, u = _case(**case)
    vf = valid.astype(np.float32)

    def pallas(p):
        return jax_fused(p, jnp.asarray(vf), alpha=alpha, eps=EPS)

    with pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(pallas, jnp.asarray(s))
        (ref_grad,) = vjp(jnp.asarray(u))
    xla, vjp = jax.vjp(lambda p: _xla_pos_sum(p, jnp.asarray(valid), alpha,
                                              EPS), jnp.asarray(s))
    (xla_grad,) = vjp(jnp.asarray(u))

    st = torch.tensor(s, requires_grad=True)
    out = fused_approx_pos(st, torch.tensor(vf), alpha=alpha, eps=EPS)
    out.backward(torch.tensor(u))
    for want, want_grad in ((ref, ref_grad), (xla, xla_grad)):
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   atol=1e-5)
        np.testing.assert_allclose(st.grad.numpy(), np.asarray(want_grad),
                                   atol=1e-5, rtol=1e-5)
    assert not out.detach().numpy()[~valid].any()
    assert not st.grad.numpy()[~valid].any()
    # the Function's backward is the plain backward
    np.testing.assert_array_equal(
        st.grad.numpy(), approx_pos_bwd_plain(
            torch.tensor(s), torch.tensor(vf), torch.tensor(u), alpha,
            EPS).numpy())


def test_plain_backward_is_autograd_of_the_plain_forward():
    s, valid, u = _case(seed=5, ties=True)
    st = torch.tensor(s, dtype=torch.float64, requires_grad=True)
    v64 = torch.tensor(valid.astype(np.float64))

    def fwd(p):  # the forward's formula in fp64, under autograd
        pv = (v64[:, :, None] > 0.5) & (v64[:, None, :] > 0.5)
        pv = pv & ~torch.eye(p.shape[1], dtype=torch.bool)
        d = torch.where(pv, p[:, :, None] - p[:, None, :], 0.0)
        return (pv.double() * torch.clamp(torch.sigmoid(-2.0 * d),
                                          min=EPS)).sum(dim=2)

    fwd(st).backward(torch.tensor(u, dtype=torch.float64))
    got = approx_pos_bwd_plain(torch.tensor(s),
                               torch.tensor(valid.astype(np.float32)),
                               torch.tensor(u), 2.0, EPS)
    np.testing.assert_allclose(got.numpy(), st.grad.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_rank_sum_rejects_bad_arguments():
    s = torch.zeros(2, 3)
    with pytest.raises(ValueError, match=r"\[B, L\]"):
        approx_pos_fwd_plain(torch.zeros(3), torch.zeros(3), 1.0, EPS)
    with pytest.raises(ValueError, match="shape"):
        approx_pos_fwd_plain(s, torch.zeros(2, 4), 1.0, EPS)
    with pytest.raises(TypeError, match="float32"):
        approx_pos_fwd_plain(s, s.double(), 1.0, EPS)
    assert MAX_LENGTH == 8192


def _lane_sums(terms):
    """Row sums of ``terms`` [n, n] as a warp takes them: lane l adds
    columns l, l + 32, ... in order, then the xor butterfly over the 32
    lanes."""
    n = terms.shape[1]
    cols = -(-n // 32) * 32
    lanes = torch.nn.functional.pad(terms, (0, cols - n)).view(
        terms.shape[0], cols // 32, 32)
    acc = torch.zeros(terms.shape[0], 32)
    for it in range(cols // 32):
        acc = acc + lanes[:, it]
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, torch.arange(32) ^ o]
    return acc[:, 0]


def _kernel_way(s, valid, u, alpha, eps):
    """pos and ds as the kernel B9 computes them (csrc/approx_pos.cu), in
    torch ops: each slate's valid documents compacted in index order; the
    sign-folded sigmoid (e = exp(-|x|), r = 1 / (1 + e); t_kj is r for x >=
    0, else e r, and t_jk the other); g = -alpha (e r) r; the row-local
    backward ds_k = sum_j g_kj (u_k [t_kj > eps] - u_j [t_jk > eps]); lane
    sums, then the butterfly."""
    pos, ds = torch.zeros_like(s), torch.zeros_like(s)
    for b in range(s.shape[0]):
        idx = torch.nonzero(valid[b] > 0.5).flatten()
        cs, cu = s[b, idx], u[b, idx]
        x = (-alpha) * (cs[:, None] - cs[None, :])
        e = torch.exp(-x.abs())
        r = 1.0 / (1.0 + e)
        er = e * r
        t_kj = torch.where(x >= 0, r, er)
        t_jk = torch.where(x >= 0, er, r)
        off_diag = ~torch.eye(idx.numel(), dtype=torch.bool)
        pos[b, idx] = _lane_sums(torch.where(
            off_diag, torch.clamp(t_kj, min=eps), 0.0))
        g = (-alpha) * er * r
        ds[b, idx] = _lane_sums(g * (torch.where(t_kj > eps, cu[:, None], 0.0)
                                     - torch.where(t_jk > eps, cu[None, :],
                                                   0.0)))
    return pos, ds


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_kernel_formulation_matches_the_plain_versions(case):
    """The algebra the kernel relies on, before any card run: the folded
    sigmoid (no exponential of a positive argument, so nothing overflows at
    scores of +-1e4), one exponential a pair for t_kj, t_jk and the
    backward's g, the diagonal's zero term, any mask."""
    case = dict(case)
    alpha = case.pop("alpha")
    s, valid, u = (torch.tensor(a) for a in _case(**case))
    vf = valid.float()
    pos, ds = _kernel_way(s, vf, u, alpha, EPS)
    assert torch.isfinite(pos).all() and torch.isfinite(ds).all()
    np.testing.assert_allclose(
        pos.numpy(), approx_pos_fwd_plain(s, vf, alpha, EPS).numpy(), **VALUE)
    np.testing.assert_allclose(
        ds.numpy(), approx_pos_bwd_plain(s, vf, u, alpha, EPS).numpy(),
        **GRAD)
    assert not pos[~valid].any() and not ds[~valid].any()


def test_max_length_is_the_kernels_envelope():
    """The wrapper's cap is the kernel's and the encoder's; the kernel's
    block scan takes a ballot word a thread up to its cap, and a block's
    rows are its warps' rows."""
    from allrank_tpu_torch.models.transformer import TILED_ATTENTION_MAX_LEN
    from allrank_tpu_torch.ops import _build

    with open(_build.source_path("approx_pos")) as f:
        src = f.read()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert constant("kMaxApproxL") == MAX_LENGTH == TILED_ATTENTION_MAX_LEN
    assert constant("kMaxApproxL") // 32 <= constant("kApproxThreads")
    assert re.search(r"kApproxRowsPerBlock = kApproxWarps \* "
                     r"kApproxRowsPerWarp;", src)


def test_time_sublayers_losses_measures_nothing_without_a_card(monkeypatch):
    """``time_sublayers --losses`` (B9 among its kernels) times on the card
    only: without one it exits 2 before building anything."""
    from allrank_tpu_torch.tools import time_sublayers

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert time_sublayers.main(["--losses"]) == 2


def _batch(b=5, n=32, seed=3):
    rng = np.random.RandomState(seed)
    y_pred = rng.randn(b, n).astype(np.float32)
    y_pred[0, 3:7] = y_pred[0, min(2, n - 1)]  # ties in the scores
    y_true = rng.randint(0, 5, size=(b, n)).astype(np.float32)
    y_true[0, -4:] = -1.0
    y_true[2, 5:] = -1.0
    y_true[3] = -1.0  # an all-padded slate
    return y_pred, y_true


@pytest.mark.parametrize("chain", ["plain", "fused"])
@pytest.mark.parametrize("kw", [
    dict(alpha=1.0), dict(alpha=1.5, n=7), dict(alpha=0.5, n=1),
    dict(alpha=2.0, slate_mask=[True, False, True, True, True])],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()
                            if k != "slate_mask")
    + ("-slate_mask" if "slate_mask" in kw else ""))
def test_approx_ndcg_loss_matches_jax(kw, chain, monkeypatch):
    """Both rank-sum paths of the port (the torch-op chain the CPU runs,
    and the kernel's prep + B9 that CUDA runs, here on its plain version)
    against the JAX package's loss."""
    kw = dict(kw)
    y_pred, y_true = _batch(n=kw.pop("n", 32))
    jkw = dict(kw)
    if "slate_mask" in kw:
        jkw["slate_mask"] = jnp.asarray(kw["slate_mask"])
        kw["slate_mask"] = torch.tensor(kw["slate_mask"])
    ref_v, ref_g = jax.value_and_grad(
        lambda p: jax_loss(p, jnp.asarray(y_true), **jkw))(
            jnp.asarray(y_pred))
    if chain == "fused":
        monkeypatch.setattr(port_approx, "_plain_pos", port_approx._fused_pos)
    p = torch.tensor(y_pred, requires_grad=True)
    loss = approxNDCGLoss(p, torch.tensor(y_true), **kw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_v), **VALUE)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_g), **GRAD)
    assert not p.grad[3].any()  # the all-padded slate
