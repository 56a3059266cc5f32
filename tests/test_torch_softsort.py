"""The soft-sort primitives of the port against the JAX package's, on the
same inputs made from a numpy seed, fp32 on the CPU.

The Pallas kernels run in interpret mode, as the JAX package's own tests
run them (tests/ops/test_sinkhorn_pallas.py, test_neuralsort_pallas.py),
and the tolerances are theirs: the Sinkhorn kernel's P to atol 1e-6 and its
gradient to atol 1e-7 (with a relative part on ragged input, stated there);
the fused soft-sort's output to atol 2e-5 and its
gradient to atol 5e-5 with rtol 1e-4. The plain chains hold tighter where
stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import allrank_tpu.ops.soft_sort as jss
from allrank_tpu.ops.neuralsort_pallas import (
    fused_soft_sort_contract as jax_fused,
)
from allrank_tpu.ops.sinkhorn_pallas import sinkhorn_core_fused as jax_core
from allrank_tpu_torch.ops import neuralsort, sinkhorn, soft_sort

torch.backends.cuda.matmul.allow_tf32 = False


def _mats(n, l, seed=0):
    rng = np.random.RandomState(seed)
    return (np.abs(rng.randn(n, l, l)) + 0.1).astype(np.float32)


def _ragged_mask(n, l, seed=0, full_pad=False):
    rng = np.random.RandomState(seed + 100)
    lengths = rng.randint(1, l + 1, size=n)
    lengths[0] = l
    if full_pad:
        lengths[-1] = 0
    return np.arange(l)[None, :] >= lengths[:, None]


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# -- sinkhorn_scaling: the plain chain with the tolerance freeze ---------------

@pytest.mark.parametrize("tol", [1e-6, 1e-2, 0.0])
@pytest.mark.parametrize("masked", [False, True])
def test_sinkhorn_scaling_plain_matches_xla(masked, tol):
    m = _mats(5, 24, 1)
    mask = _ragged_mask(5, 24, 1, full_pad=True) if masked else None
    ref = jss.sinkhorn_scaling(jnp.asarray(m),
                               None if mask is None else jnp.asarray(mask),
                               tol=tol, backend="xla")
    got = soft_sort.sinkhorn_scaling(_t(m), None if mask is None else _t(mask),
                                     tol=tol, backend="plain")
    # the same fp32 recurrence; sums in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_sinkhorn_scaling_freeze_is_batch_global():
    """One slow slate keeps every slate iterating: the freeze is decided by
    the batch's worst residual. Alone, the quick slate stops at the
    tolerance; beside the slow one it goes on and ends closer to doubly
    stochastic."""
    rng = np.random.RandomState(3)
    quick = _mats(1, 8, 5)
    slow = np.exp(rng.randn(1, 8, 8) * 4).astype(np.float32)
    both = np.concatenate([quick, slow])
    results = {}
    for name, m in (("alone", quick), ("beside", both)):
        ref = jss.sinkhorn_scaling(jnp.asarray(m), tol=1e-2, max_iter=12,
                                   backend="xla")
        got = soft_sort.sinkhorn_scaling(_t(m), tol=1e-2, max_iter=12,
                                         backend="plain")
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
        results[name] = got[0]

    def off(p):
        return (p.sum(dim=0) - 1).abs().max().item()

    assert off(results["alone"]) > 1e-4 > 10 * off(results["beside"])


def test_sinkhorn_scaling_gradient_matches_xla_autodiff():
    m = _mats(3, 16, 2)
    mask = _ragged_mask(3, 16, 2)
    g_ref = jax.grad(lambda x: jnp.sum(jnp.cos(jss.sinkhorn_scaling(
        x, jnp.asarray(mask), backend="xla"))))(jnp.asarray(m))
    x = _t(m, grad=True)
    torch.cos(soft_sort.sinkhorn_scaling(x, _t(mask), backend="plain")
              ).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_ref), atol=1e-6)


def test_sinkhorn_scaling_zero_column_and_cap_stay_finite():
    m = _mats(2, 6, 4)
    m[0, :, 2] = 0.0            # an exactly zero column freezes its scaling
    m[1] = np.eye(6)[::-1] * 1e-30 + np.eye(6)   # degenerate support
    for backend, jb in (("plain", "xla"), ("kernel", "pallas")):
        with pltpu.force_tpu_interpret_mode():
            ref = jss.sinkhorn_scaling(jnp.asarray(m), tol=0.0, backend=jb)
        got = soft_sort.sinkhorn_scaling(_t(m), tol=0.0, backend=backend)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    with pytest.raises(ValueError, match="backend"):
        soft_sort.sinkhorn_scaling(_t(m), backend="xla")


# -- B7's plain version against the Pallas kernel ---------------------------------

@pytest.mark.parametrize("n,l,iters", [(4, 40, 50), (3, 8, 50), (1, 17, 20)])
def test_sinkhorn_core_plain_matches_pallas_forward(n, l, iters):
    m = _mats(n, l, n)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_core(jnp.asarray(m), iters)
    got = sinkhorn.sinkhorn_core_fused(_t(m), iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    p, a_hist, b_hist = sinkhorn.sinkhorn_fwd(_t(m), iters)
    assert a_hist.shape == b_hist.shape == (n, iters + 1, l)
    assert torch.equal(p, got) and (a_hist[:, 0] == 1).all()


@pytest.mark.parametrize("n,l,masked", [(4, 64, False), (4, 48, True),
                                        (3, 24, True)])
def test_sinkhorn_core_plain_matches_pallas_gradient(n, l, masked):
    m = _mats(n, l, 1)
    # the ragged lengths of the JAX package's own masked gradient test
    mask = (np.arange(l)[None, :] >= np.array(
        [l, l * 5 // 6, l * 5 // 12, 5])[:n, None]) if masked else None

    def jax_loss(x):
        return jnp.sum(jnp.sin(jss.sinkhorn_scaling(
            x, None if mask is None else jnp.asarray(mask),
            backend="pallas")))

    with pltpu.force_tpu_interpret_mode():
        g_ref = jax.grad(jax_loss)(jnp.asarray(m))
    x = _t(m, grad=True)
    torch.sin(soft_sort.sinkhorn_scaling(
        x, None if mask is None else _t(mask), backend="kernel")
    ).sum().backward()
    # atol is the JAX package's own; the relative part covers the short
    # slates of the masked cases, whose entries (about 1 / length) and
    # gradients are ten times a full slate's, with torch's matvecs summing
    # in another order than either JAX path (2.8e-7 seen on 1.2e-2)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_ref), atol=1e-7,
                               rtol=5e-5 if masked else 0)


def test_sinkhorn_core_plain_matches_pallas_past_b8s_length():
    """B7's own range, 512 < L <= 768, where no fused soft-sort runs: N=2,
    L=520 with a padding tail of 60 documents on the second slate, P from
    the kernel's forward on pre-masked M0 and the gradient through
    ``sinkhorn_scaling``'s kernel path, at the tolerances above."""
    n, l = 2, 520
    m = _mats(n, l, 5)
    mask = np.arange(l)[None, :] >= np.array([l, l - 60])[:, None]
    pair = mask[:, :, None] | mask[:, None, :]
    m0 = np.where(mask[:, :, None] & mask[:, None, :], 1.0,
                  np.where(pair, 0.0, m)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_core(jnp.asarray(m0), 50)
        g_ref = jax.grad(lambda x: jnp.sum(jnp.sin(jss.sinkhorn_scaling(
            x, jnp.asarray(mask), backend="pallas"))))(jnp.asarray(m))
    got = sinkhorn.sinkhorn_core_fused(_t(m0), 50)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    x = _t(m, grad=True)
    torch.sin(soft_sort.sinkhorn_scaling(x, _t(mask), backend="kernel")
              ).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_ref), atol=1e-7,
                               rtol=5e-5)


def test_sinkhorn_wrappers_check_their_arguments():
    with pytest.raises(ValueError, match=r"\[N, L, L\]"):
        sinkhorn.sinkhorn_fwd(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError, match="max_iter"):
        sinkhorn.sinkhorn_fwd(torch.zeros(2, 3, 3), 0)
    assert sinkhorn.MAX_FUSED_LENGTH == 768
    assert neuralsort.MAX_FUSED_LENGTH == 512
    before = sinkhorn.sinkhorn_fwd.launches
    sinkhorn.sinkhorn_fwd(torch.ones(1, 2, 2))
    assert sinkhorn.sinkhorn_fwd.launches == before  # the CPU launches none


# -- B8's plain version against the Pallas kernel and the XLA chain ---------------

def _case(n, l, seed, ragged=True, full_pad=False):
    rng = np.random.RandomState(seed)
    scores = rng.randn(n, l).astype(np.float32)
    mask = (_ragged_mask(n, l, seed, full_pad) if ragged
            else np.zeros((n, l), bool))
    vec = np.where(mask, 0.0, np.abs(rng.randn(n, l))).astype(np.float32)
    return scores, mask, vec


def _xla_chain(scores, mask, vec, tau, max_iter=50, transpose=False):
    p_hat = jss.deterministic_neural_sort(scores, tau, mask)
    p = jss.sinkhorn_scaling(p_hat, mask, tol=0.0, max_iter=max_iter,
                             backend="xla")
    p = jnp.where(mask[:, :, None] | mask[:, None, :], 0.0, p)
    return jnp.einsum("nij,ni->nj" if transpose else "nij,nj->ni", p, vec)


CASES = [(4, 40, True, False), (3, 8, True, True), (2, 33, False, False)]


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("n,l,ragged,full_pad", CASES)
def test_soft_sort_plain_matches_pallas_and_xla(n, l, ragged, full_pad,
                                                transpose):
    """Forward and gradient, against the Pallas kernel in interpret mode and
    against the XLA chain at tol=0."""
    scores, mask, vec = _case(n, l, n + l, ragged, full_pad)
    js, jm, jv = (jnp.asarray(a) for a in (scores, mask, vec))

    def fused_loss(s):
        out = jax_fused(s, jm, jv, tau=1.0, transpose=transpose)
        return jnp.sum(jnp.sin(out)), out

    def xla_loss(s):
        out = _xla_chain(s, jm, jv, 1.0, transpose=transpose)
        return jnp.sum(jnp.sin(out)), out

    with pltpu.force_tpu_interpret_mode():
        (_, out_fused), g_fused = jax.value_and_grad(
            fused_loss, has_aux=True)(js)
    (_, out_xla), g_xla = jax.value_and_grad(xla_loss, has_aux=True)(js)
    s = _t(scores, grad=True)
    out = neuralsort.fused_soft_sort_contract(
        s, _t(mask), _t(vec), tau=1.0, transpose=transpose)
    torch.sin(out).sum().backward()
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_fused),
                               atol=2e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_xla),
                               atol=2e-5)
    got = s.grad.numpy()
    assert np.isfinite(got).all() and not got[mask].any()
    np.testing.assert_allclose(got, np.asarray(g_fused), atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(got, np.asarray(g_xla), atol=5e-5, rtol=1e-4)


def test_soft_sort_temperature_and_max_iter_propagate():
    scores, mask, vec = _case(3, 20, 9, ragged=False)
    js, jm, jv = (jnp.asarray(a) for a in (scores, mask, vec))
    with pltpu.force_tpu_interpret_mode():
        ref = jax_fused(js, jm, jv, tau=0.25, max_iter=20)
    got = neuralsort.fused_soft_sort_contract(
        _t(scores), _t(mask), _t(vec), tau=0.25, max_iter=20)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    with pytest.raises(ValueError, match="tau"):
        neuralsort.fused_soft_sort_contract(_t(scores), _t(mask), _t(vec),
                                            tau=0.0)
    with pytest.raises(ValueError, match="one shape"):
        neuralsort.fused_soft_sort_contract(_t(scores), _t(mask[:, :5]),
                                            _t(vec), tau=1.0)


# -- the relaxations ---------------------------------------------------------------

# the logits scale as 1 / tau and reach several hundred at tau = 0.1, where
# one fp32 ulp of a logit (3e-5) moves its softmax weight by that share
SORT_TOL = {1.0: dict(atol=1e-6), 0.7: dict(rtol=1e-4, atol=1e-6),
            0.1: dict(rtol=2e-4, atol=1e-6)}


@pytest.mark.parametrize("tau", [1.0, 0.1])
def test_deterministic_neural_sort_matches_jax(tau):
    scores, mask, _ = _case(4, 12, 2, full_pad=True)
    ref = jss.deterministic_neural_sort(jnp.asarray(scores), tau,
                                        jnp.asarray(mask))
    got = soft_sort.deterministic_neural_sort(_t(scores), tau, _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **SORT_TOL[tau])


def test_stochastic_neural_sort_matches_jax_on_the_same_noise(monkeypatch):
    scores, mask, _ = _case(3, 10, 4)
    key = jax.random.PRNGKey(0)
    noise = np.asarray(jss.sample_gumbel(key, (5, 3, 10)))
    monkeypatch.setattr(soft_sort, "sample_gumbel",
                        lambda gen, shape, eps=1e-10, device=None:
                        torch.tensor(noise))
    for log_scores in (True, False):
        ref = jss.stochastic_neural_sort(
            jnp.asarray(scores), 5, 0.7, jnp.asarray(mask), key, beta=0.3,
            log_scores=log_scores)
        got = soft_sort.stochastic_neural_sort(
            _t(scores), 5, 0.7, _t(mask), torch.Generator(), beta=0.3,
            log_scores=log_scores)
        assert got.shape == (5, 3, 10, 10)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   **SORT_TOL[0.7])


def test_sample_gumbel_depends_only_on_the_generator_state():
    gen = torch.Generator().manual_seed(11)
    state = gen.get_state()
    a = soft_sort.sample_gumbel(gen, (4, 3, 6))
    b = soft_sort.sample_gumbel(gen, (4, 3, 6))
    gen.set_state(state)
    c = soft_sort.sample_gumbel(gen, (4, 3, 6))
    assert torch.equal(a, c) and not torch.equal(a, b)
    assert torch.isfinite(a).all() and a.dtype == torch.float32
    # Gumbel(0, 1): mean is Euler's constant
    big = soft_sort.sample_gumbel(gen, (200000,))
    assert abs(big.mean().item() - 0.5772) < 0.02
