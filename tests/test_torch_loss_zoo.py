"""The ten losses of the port that run in PyTorch ops or around the
approxNDCG kernel (allrank_tpu_torch/losses: listNet, binary_listNet,
listMLE, the three rankNets, ordinal, pointwise_rmse, bce, approxNDCGLoss)
against the JAX package's functions on the same numpy inputs from a seed.

Value rtol 1e-5 / atol 1e-6, gradient rtol 1e-4 / atol 1e-6: the same fp32
elementwise chains and row sums, summed in another order by the two
libraries. NaNs must fall in the same places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allrank_tpu.losses import LOSSES as JAX_LOSSES
from allrank_tpu.losses.common import bce_elementwise as jax_bce_elementwise
from allrank_tpu.losses.common import bce_with_logits as jax_bce_with_logits
from allrank_tpu.losses.common import clamped_log as jax_clamped_log
from allrank_tpu.losses.common import (
    masked_mean_over_slates as jax_masked_mean,
)
from allrank_tpu.losses.ordinal import with_ordinals as jax_with_ordinals
from allrank_tpu_torch.losses import LOSSES, with_ordinals
from allrank_tpu_torch.losses.common import (
    bce_elementwise,
    bce_with_logits,
    clamped_log,
    masked_mean_over_slates,
)

torch.set_num_threads(2)

VALUE = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
ZOO = ["listNet", "binary_listNet", "listMLE", "rankNet",
       "rankNet_weightByGTDiff", "rankNet_weightByGTDiff_pow", "ordinal",
       "pointwise_rmse", "bce", "approxNDCGLoss"]
KWARGS = {"ordinal": {"n": 4}, "pointwise_rmse": {"no_of_levels": 4.0},
          "approxNDCGLoss": {"alpha": 1.5}}
PROBABILITY_LOSSES = ("ordinal", "bce")
BINARY_LABEL_LOSSES = ("bce", "binary_listNet")
B = 5


def make_case(name, l, padding, seed=0, ties=False):
    """(y_pred, y_true) for loss ``name``: [B, l] scores (probabilities for
    the losses that take a sigmoid head's output; [B, l, 4] for ordinal) and
    labels 0-4 (0/1 for the binary losses) with -1 at padded documents."""
    rng = np.random.RandomState(seed + 31 * l)
    y_true = rng.randint(0, 2 if name in BINARY_LABEL_LOSSES else 5,
                         size=(B, l)).astype(np.float32)
    shape = (B, l, 4) if name == "ordinal" else (B, l)
    if name in PROBABILITY_LOSSES:
        y_pred = rng.uniform(0.02, 0.98, size=shape).astype(np.float32)
    else:
        y_pred = (rng.randn(*shape) * 2.0).astype(np.float32)
    if ties:
        y_pred = np.round(y_pred * (4 if name in PROBABILITY_LOSSES else 1)
                          ) / (4 if name in PROBABILITY_LOSSES else 1)
        y_true[:, : l // 2] = 1.0
    if padding == "tail":
        for b, n in enumerate(rng.randint(1, l + 1, size=B)):
            y_true[b, n:] = -1.0
    elif padding in ("random", "all_padded"):
        y_true[rng.rand(B, l) < 0.3] = -1.0
    if padding == "all_padded":
        y_true[2] = -1.0
    return y_pred, y_true


def jax_value_and_grad(name, y_pred, y_true, **kw):
    if kw.get("slate_mask") is not None:
        kw["slate_mask"] = jnp.asarray(kw["slate_mask"])
    fn = JAX_LOSSES[name][0]
    v, g = jax.value_and_grad(lambda p: fn(p, jnp.asarray(y_true), **kw))(
        jnp.asarray(y_pred))
    return np.asarray(v), np.asarray(g)


def port_value_and_grad(name, y_pred, y_true, **kw):
    if kw.get("slate_mask") is not None:
        kw["slate_mask"] = torch.tensor(kw["slate_mask"])
    p = torch.tensor(y_pred, requires_grad=True)
    loss = LOSSES[name][0](p, torch.tensor(y_true), **kw)
    loss.backward()
    return loss.detach().numpy(), p.grad.numpy()


def assert_same(got, ref):
    (gv, gg), (rv, rg) = got, ref
    np.testing.assert_allclose(gv, rv, equal_nan=True, **VALUE)
    np.testing.assert_allclose(gg, rg, equal_nan=True, **GRAD)


@pytest.mark.parametrize("slate_mask", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("padding", ["none", "tail", "random", "all_padded"])
@pytest.mark.parametrize("l", [1, 2, 7, 40])
@pytest.mark.parametrize("name", ZOO)
def test_loss_matches_jax(name, l, padding, slate_mask):
    """Value and gradient, whatever the JAX function gives for an all-padded
    slate included, with and without a slate mask."""
    y_pred, y_true = make_case(name, l, padding)
    kw = dict(KWARGS.get(name, {}))
    if slate_mask:
        kw["slate_mask"] = np.array([True, True, False, True, False])
    ref = jax_value_and_grad(name, y_pred, y_true, **kw)
    got = port_value_and_grad(name, y_pred, y_true, **kw)
    assert_same(got, ref)
    if padding == "all_padded":
        assert not got[1][2].any()  # the all-padded slate takes no gradient
    if slate_mask:
        assert not got[1][2].any() and not got[1][4].any()


@pytest.mark.parametrize("name", ZOO)
def test_loss_matches_jax_with_tied_labels_and_scores(name):
    """Both sides sort stably: heavy ties in the scores and in the labels
    leave value and gradient equal."""
    y_pred, y_true = make_case(name, 12, "tail", seed=3, ties=True)
    kw = KWARGS.get(name, {})
    assert_same(port_value_and_grad(name, y_pred, y_true, **kw),
                jax_value_and_grad(name, y_pred, y_true, **kw))


@pytest.mark.parametrize("name", PROBABILITY_LOSSES)
def test_saturated_probabilities_match_jax(name):
    """A sigmoid head that saturates to exactly 0 or 1: the -100 clamp of
    the log and its bounded backward, finite on both sides."""
    y_pred, y_true = make_case(name, 7, "tail", seed=5)
    flat = y_pred.reshape(-1)
    flat[0::3] = 0.0
    flat[1::3] = 1.0
    kw = KWARGS.get(name, {})
    got = port_value_and_grad(name, y_pred, y_true, **kw)
    assert np.isfinite(got[0]) and np.isfinite(got[1]).all()
    assert np.abs(got[1]).max() > 1e6  # the 1e-12 floor, not a zero
    assert_same(got, jax_value_and_grad(name, y_pred, y_true, **kw))


def test_clamped_log_has_the_jax_value_and_backward():
    p = np.array([0.0, 1e-30, 1e-13, 1e-12, 1e-5, 0.3, 1.0, -0.5, 2.0],
                 dtype=np.float32)
    ref_v, ref_g = jax.vmap(jax.value_and_grad(jax_clamped_log))(
        jnp.asarray(p))
    pt = torch.tensor(p, requires_grad=True)
    out = clamped_log(pt)
    out.backward(torch.ones_like(out))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_v),
                               **VALUE)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(ref_g), rtol=1e-6)
    assert out[0].item() == -100.0 and pt.grad[0].item() == np.float32(1e12)


def test_loss_helpers_match_jax():
    rng = np.random.RandomState(1)
    p = rng.uniform(0, 1, size=(3, 4)).astype(np.float32)
    t = rng.randint(0, 2, size=(3, 4)).astype(np.float32)
    x = (rng.randn(3, 4) * 30).astype(np.float32)
    np.testing.assert_allclose(
        bce_elementwise(torch.tensor(p), torch.tensor(t)).numpy(),
        np.asarray(jax_bce_elementwise(jnp.asarray(p), jnp.asarray(t))),
        **VALUE)
    np.testing.assert_allclose(
        bce_with_logits(torch.tensor(x), torch.tensor(t)).numpy(),
        np.asarray(jax_bce_with_logits(jnp.asarray(x), jnp.asarray(t))),
        **VALUE)
    for sw in (np.array([1.0, 0.0, 1.0]), np.zeros(3)):
        sw = sw.astype(np.float32)
        np.testing.assert_allclose(
            masked_mean_over_slates(torch.tensor(p[:, 0]),
                                    torch.tensor(sw)).numpy(),
            np.asarray(jax_masked_mean(jnp.asarray(p[:, 0]),
                                       jnp.asarray(sw))), **VALUE)
    y = np.array([[0, 1, 4, -1], [2, 3, -1, -1]], dtype=np.float32)
    np.testing.assert_array_equal(
        with_ordinals(torch.tensor(y), 4).numpy(),
        np.asarray(jax_with_ordinals(jnp.asarray(y), 4)))


def _unique_labels(l, seed):
    rng = np.random.RandomState(seed)
    return np.stack([rng.permutation(l) for _ in range(B)]).astype(np.float32)


def test_list_mle_shuffle_leaves_tie_free_labels_alone():
    """With labels free of ties the label-descending order is one order,
    whatever the permutation before the sort: the port with a generator
    equals the JAX function without a key, to the summation order of the
    padded tail."""
    y_pred, _ = make_case("listMLE", 9, "none", seed=7)
    y_true = _unique_labels(9, 7)
    y_true[1, 6:] = -1.0
    ref = jax_value_and_grad("listMLE", y_pred, y_true)
    for seed in (0, 1):
        got = port_value_and_grad(
            "listMLE", y_pred, y_true,
            generator=torch.Generator().manual_seed(seed))
        assert_same(got, ref)


def test_list_mle_shuffle_with_ties_is_the_jax_loss_on_permuted_inputs():
    """With tied labels the result depends on the permutation, and
    ``jax.random.permutation``'s bits are not ``torch.randperm``'s: the port
    with a generator equals the JAX function at ``rng=None`` on inputs
    permuted beforehand with the port's own permutation."""
    y_pred, y_true = make_case("listMLE", 12, "tail", seed=9)
    assert len(np.unique(y_true[0])) < 12  # ties
    gen = torch.Generator().manual_seed(11)
    perm = torch.randperm(12, generator=torch.Generator().manual_seed(11)
                          ).numpy()
    got_v, got_g = port_value_and_grad("listMLE", y_pred, y_true,
                                       generator=gen)
    ref_v, ref_g = jax_value_and_grad("listMLE", y_pred[:, perm],
                                      y_true[:, perm])
    np.testing.assert_allclose(got_v, ref_v, **VALUE)
    np.testing.assert_allclose(got_g[:, perm], ref_g, **GRAD)
    # and the permutation matters here: the unshuffled loss differs
    plain_v, _ = port_value_and_grad("listMLE", y_pred, y_true)
    assert abs(plain_v - got_v) > 1e-4
    # the generator advanced: a second call draws another permutation
    again_v, _ = port_value_and_grad("listMLE", y_pred, y_true,
                                     generator=gen)
    assert again_v != got_v


def test_rank_net_normaliser_is_the_batch_pair_count():
    y_pred = np.array([[2.0, 1.0, 0.0], [0.0, 0.0, 0.0]], dtype=np.float32)
    y_true = np.array([[2.0, 1.0, 0.0], [1.0, 0.0, -1.0]], dtype=np.float32)
    got, _ = port_value_and_grad("rankNet", y_pred, y_true)
    # 3 + 1 selected pairs: softplus(-1), softplus(-2), softplus(-1), ln 2
    want = (2 * np.log1p(np.exp(-1.0)) + np.log1p(np.exp(-2.0))
            + np.log(2.0)) / 4
    np.testing.assert_allclose(got, want, rtol=1e-6)
