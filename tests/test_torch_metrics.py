"""The port's ranking metrics against the JAX package's on the same inputs
(made from a numpy seed): ragged slates with ties, an all-zero-label slate
and a fully padded one. fp32 on the CPU, atol 1e-6 for the metrics in [0, 1]
and rtol 1e-6 beside it for DCG (values up to some 40, where one fp32 ulp is
3.8e-6): the same sort, gains and cumulative sums, where only the order of
fp32 additions may differ."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import allrank_tpu.metrics as jm
import allrank_tpu_torch.metrics as tm

TOL = dict(rtol=1e-6, atol=1e-6)


def _slates(seed=0, b=7, l=12):
    rng = np.random.RandomState(seed)
    y_true = rng.randint(0, 5, (b, l)).astype(np.float32)
    # ties in the predictions: quantised scores
    y_pred = np.round(rng.randn(b, l) * 2).astype(np.float32) / 2
    lengths = [12, 9, 5, 1, 12, 12, 0]
    for i, n in enumerate(lengths):
        y_true[i, n:] = -1
    y_true[4, :] = 0.0          # no relevant document
    return y_pred, y_true


@pytest.mark.parametrize("ats", [None, [1, 5, 10], [3, 50]])
@pytest.mark.parametrize("name", ["ndcg", "dcg", "mrr", "map", "err"])
def test_metric_matches_jax(name, ats):
    y_pred, y_true = _slates()
    got = tm.get_metric(name)(torch.tensor(y_pred), torch.tensor(y_true),
                              ats=ats)
    ref = jm.get_metric(name)(jnp.asarray(y_pred), jnp.asarray(y_true),
                              ats=ats)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("gain", ["pow2_gain", "identity_gain"])
def test_dcg_and_ndcg_gain_functions_match_jax(gain):
    y_pred, y_true = _slates(1)
    for name in ("dcg", "ndcg"):
        got = getattr(tm, name)(torch.tensor(y_pred), torch.tensor(y_true),
                                ats=[5], gain_function=getattr(tm, gain))
        ref = getattr(jm, name)(jnp.asarray(y_pred), jnp.asarray(y_true),
                                ats=[5], gain_function=getattr(jm, gain))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("all_irrelevant", [False, True])
def test_mrr_batch_global_quirk_and_strict_match_jax(strict, all_irrelevant):
    """Without ``strict`` the zeroing is decided by the whole batch: a slate
    without a relevant document still scores 1/1 unless every slate has
    none."""
    y_pred, y_true = _slates(2)
    if all_irrelevant:
        y_true = np.where(y_true > 0, 0.0, y_true).astype(np.float32)
    got = tm.mrr(torch.tensor(y_pred), torch.tensor(y_true), ats=[1, 3, 12],
                 strict=strict).numpy()
    ref = np.asarray(jm.mrr(jnp.asarray(y_pred), jnp.asarray(y_true),
                            ats=[1, 3, 12], strict=strict))
    np.testing.assert_allclose(got, ref, **TOL)
    if not strict and not all_irrelevant:
        assert got[4, 2] == 1.0  # the quirk: slate 4 has no relevant document
    if strict or all_irrelevant:
        assert not got[4].any()


def test_ndcg_fills_blank_slates_and_ignores_padding():
    y_pred, y_true = _slates(3)
    got = tm.ndcg(torch.tensor(y_pred), torch.tensor(y_true), ats=[5],
                  filler_value=0.25).numpy()
    assert got[4, 0] == 0.25 and got[6, 0] == 0.25
    # more padding changes nothing
    wide_p = np.concatenate([y_pred, np.zeros((7, 4), np.float32)], axis=1)
    wide_t = np.concatenate([y_true, -np.ones((7, 4), np.float32)], axis=1)
    wide = tm.ndcg(torch.tensor(wide_p), torch.tensor(wide_t), ats=[5],
                   filler_value=0.25).numpy()
    np.testing.assert_allclose(wide, got, **TOL)


def test_position_discounts_and_gains_match_jax():
    np.testing.assert_array_equal(tm.position_discounts(240),
                                  jm.position_discounts(240))
    x = np.arange(5, dtype=np.float32)
    np.testing.assert_array_equal(tm.pow2_gain(torch.tensor(x)).numpy(),
                                  np.asarray(jm.pow2_gain(jnp.asarray(x))))
    assert tm.identity_gain(x) is x
    with pytest.raises(ValueError, match="Unknown metric"):
        tm.get_metric("nope")
