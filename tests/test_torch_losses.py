"""The port's lambdaLoss (allrank_tpu_torch/losses) and its pair-chain
kernel B3 (allrank_tpu_torch/ops/lambda_pairs.py) against the JAX package:
the TPU kernel ``fused_lambda_pairs`` in Pallas interpret mode, and the
XLA-path ``lambdaLoss``. Tolerances are the JAX package's own tests'
(tests/ops/test_lambda_pallas.py): value rtol 2e-5, gradient rtol 1e-4 and
atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from allrank_tpu.losses import accumulation_weighting as jax_accum
from allrank_tpu.losses.lambdaloss import _ndcgLoss2_deltas
from allrank_tpu.losses.lambdaloss import lambdaLoss as jax_lambdaLoss
from allrank_tpu.ops.lambda_pallas import fused_lambda_pairs as jax_fused
from allrank_tpu_torch.losses import (
    accumulation_weighting,
    get_loss,
    lambdaLoss,
)
from allrank_tpu_torch.losses import lambdaloss as port_lambdaloss
from allrank_tpu_torch.ops.lambda_pairs import (
    SCHEMES,
    fused_lambda_pairs,
    ndcg2_deltas,
)

torch.set_num_threads(2)

VALUE = dict(rtol=2e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
EPS = 1e-10


def _pair_inputs(b=4, k=16, seed=0):
    """Sorted-block inputs as lambdaLoss hands them to the kernel: scores,
    clamped labels, gains and 0/1 validity, one slate a dummy."""
    rng = np.random.RandomState(seed)
    ts = rng.randint(0, 5, size=(b, k)).astype(np.float32)
    valid = (rng.rand(b, k) > 0.2).astype(np.float32)
    valid[-1] = 0.0
    yp = (rng.randn(b, k) * valid).astype(np.float32)
    g = ((2.0 ** ts - 1.0) / 17.0).astype(np.float32)
    return yp, ts, g, valid


def _jax_pairs(yp, ts, g, valid, gout, **kw):
    def f(p):
        return jax_fused(p, *map(jnp.asarray, (ts, g, valid)), **kw)

    with pltpu.force_tpu_interpret_mode():
        (loss, cnt), vjp = jax.vjp(f, jnp.asarray(yp))
        (grad,) = vjp((jnp.asarray(gout), jnp.zeros_like(cnt)))
    return np.asarray(loss), np.asarray(cnt), np.asarray(grad)


@pytest.mark.parametrize("k_eff", [16, 10])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_pair_chain_matches_tpu_kernel(scheme, k_eff):
    yp, ts, g, valid = _pair_inputs()
    gout = np.linspace(0.5, 1.5, yp.shape[0]).astype(np.float32)
    kw = dict(scheme=scheme, k_eff=k_eff, sigma=1.0, mu=10.0,
              log_base="binary", eps=EPS)
    ref_loss, ref_cnt, ref_grad = _jax_pairs(yp, ts, g, valid, gout, **kw)
    ypt = torch.tensor(yp, requires_grad=True)
    loss, cnt = fused_lambda_pairs(ypt, *map(torch.tensor, (ts, g, valid)),
                                   **kw)
    loss.backward(torch.tensor(gout))
    np.testing.assert_array_equal(cnt.numpy(), ref_cnt)
    np.testing.assert_allclose(loss.detach().numpy(), ref_loss, **VALUE)
    np.testing.assert_allclose(ypt.grad.numpy(), ref_grad, **GRAD)
    assert not ypt.grad[-1].any()  # the dummy slate takes no gradient


def test_pair_chain_natural_log_and_sigma():
    yp, ts, g, valid = _pair_inputs(seed=2)
    gout = np.ones(yp.shape[0], dtype=np.float32)
    kw = dict(scheme="ndcgLoss2PP_scheme", k_eff=16, sigma=2.5, mu=3.0,
              log_base="natural", eps=EPS)
    ref_loss, _, ref_grad = _jax_pairs(yp, ts, g, valid, gout, **kw)
    ypt = torch.tensor(yp, requires_grad=True)
    loss, _ = fused_lambda_pairs(ypt, *map(torch.tensor, (ts, g, valid)),
                                 **kw)
    loss.sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), ref_loss, **VALUE)
    np.testing.assert_allclose(ypt.grad.numpy(), ref_grad, **GRAD)


def test_delta_table_is_the_jax_table():
    for n in (1, 2, 16, 240):
        np.testing.assert_array_equal(ndcg2_deltas(n), _ndcgLoss2_deltas(n))


def _batch(b=5, l=14, seed=0):
    rng = np.random.RandomState(seed)
    y_pred = rng.randn(b, l).astype(np.float32)
    y_pred[0, 3:7] = y_pred[0, 2]  # ties in the scores
    y_true = rng.randint(0, 5, size=(b, l)).astype(np.float32)
    y_true[1, l // 2:] = -1.0  # a padded tail
    y_true[2, :] = -1.0  # an all-padded slate
    return y_pred, y_true


def _value_and_grad(chain, y_pred, y_true, **kw):
    yt = torch.tensor(y_pred, requires_grad=True)
    if chain is None:
        loss = lambdaLoss(yt, torch.tensor(y_true), **kw)
    else:  # the same loss through the named pair-chain path
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(port_lambdaloss, "_plain_chain", chain)
            loss = lambdaLoss(yt, torch.tensor(y_true), **kw)
    loss.backward()
    return loss.item(), yt.grad.numpy()


def _jax_value_and_grad(y_pred, y_true, **kw):
    if "slate_mask" in kw:
        kw["slate_mask"] = jnp.asarray(kw["slate_mask"])
    v, g = jax.value_and_grad(
        lambda p: jax_lambdaLoss(p, jnp.asarray(y_true), **kw))(
            jnp.asarray(y_pred))
    return float(v), np.asarray(g)


CASES = [dict(weighing_scheme=s) for s in SCHEMES] + [
    dict(weighing_scheme="ndcgLoss2PP_scheme", k=5),
    dict(weighing_scheme="lambdaRank_scheme", reduction="mean"),
    dict(weighing_scheme="ndcgLoss2PP_scheme", reduction_log="natural",
         sigma=2.0, mu=3.0),
    dict(weighing_scheme="ndcgLoss1_scheme", k=4, reduction="mean"),
    dict(weighing_scheme="ndcgLoss2_scheme",
         slate_mask=[True, True, True, False, True]),
]


@pytest.mark.parametrize("chain", ["plain", "fused"])
@pytest.mark.parametrize("kw", CASES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items() if k != "slate_mask")
    + ("-slate_mask" if "slate_mask" in kw else ""))
def test_lambda_loss_matches_jax(kw, chain):
    """Both pair-chain paths of the port (the XLA-path formulation the CPU
    runs, and the kernel's prep + B3 that CUDA runs, here on its plain
    version) against the JAX package's XLA-path lambdaLoss."""
    y_pred, y_true = _batch(seed=len(kw))
    ref_v, ref_g = _jax_value_and_grad(y_pred, y_true, **dict(kw))
    path = None if chain == "plain" else port_lambdaloss._fused_chain
    got_v, got_g = _value_and_grad(path, y_pred, y_true, **dict(kw))
    np.testing.assert_allclose(got_v, ref_v, **VALUE)
    np.testing.assert_allclose(got_g, ref_g, **GRAD)
    assert not got_g[2].any()  # the all-padded slate


def test_lambda_loss_rejects_bad_arguments():
    y = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="logarithm"):
        lambdaLoss(y, y, reduction_log="ten")
    with pytest.raises(ValueError, match="Reduction method"):
        lambdaLoss(y, y, reduction="max")
    with pytest.raises(ValueError, match="weighing scheme"):
        lambdaLoss(y, y, weighing_scheme="nope")


def test_registry_has_lambda_loss_and_names_the_rest():
    fn, needs_rng = get_loss("lambdaLoss")
    assert fn is lambdaLoss and needs_rng is False
    with pytest.raises(NotImplementedError, match="not yet ported"):
        get_loss("neuralNDCG")
    with pytest.raises(ValueError, match="Unknown loss"):
        get_loss("nope")


def test_loss_helpers_match_jax():
    from allrank_tpu.losses.common import resolve_slate_mask as jax_resolve
    from allrank_tpu_torch.losses.common import (
        as_f32,
        padding_mask,
        resolve_slate_mask,
    )

    y = np.array([[1, -1], [-1, -1], [0, 2]], dtype=np.float32)
    yt, lst = as_f32(torch.tensor(y).double(), [1, 2])
    assert yt.dtype == lst.dtype == torch.float32
    np.testing.assert_array_equal(padding_mask(yt).numpy(), y == -1)
    for sm in (None, np.array([True, False, True])):
        got = resolve_slate_mask(yt, None if sm is None else torch.tensor(sm))
        ref = jax_resolve(jnp.asarray(y), None if sm is None else
                          jnp.asarray(sm))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name,args", [
    ("lambdaLoss", None), ("lambdaLoss", {"reduction": "mean"}),
    ("ordinal", None), ("bce", None), ("listNet", None)])
def test_accumulation_weighting_matches_jax(name, args):
    y = np.array([[1, 0, -1], [2, -1, -1], [-1, -1, -1]], dtype=np.float32)
    sm = np.array([True, True, False])
    fn, normalize = accumulation_weighting(name, args)
    ref_fn, ref_normalize = jax_accum(name, args)
    assert normalize == ref_normalize
    got = fn(torch.tensor(y), torch.tensor(sm)).item()
    assert got == float(ref_fn(jnp.asarray(y), jnp.asarray(sm)))
