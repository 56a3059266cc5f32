"""The port's click models (allrank_tpu_torch/click_models/) against the JAX
package's: the host models bit for bit under the same ``np.random`` seed,
the batch functions element for element given JAX's own uniforms, the
port's hashed draws against the host models' click rates, and the
dispatch of ``as_device_click_fn``.

Tolerances: every click is compared exactly; the diverse model's pairwise
distances and margins at rtol 1e-6 (their sums run in another order than
XLA's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import allrank_tpu.click_models as jcm
import allrank_tpu_torch.click_models as tcm
from allrank_tpu.click_models import jax_models as jm
from allrank_tpu.config import NameArgsConfig as JaxNameArgs
from allrank_tpu.utils.python_utils import (
    instantiate_from_recursive_name_args as jax_instantiate,
)
from allrank_tpu_torch.click_models import device_models as dm
from allrank_tpu_torch.config import NameArgsConfig
from allrank_tpu_torch.constants import PADDED_Y_VALUE
from allrank_tpu_torch.utils.python_utils import (
    instantiate_class,
    instantiate_from_recursive_name_args,
)

L, F = 10, 5

# each host model, built from either package's classes; real slates hold
# at least 5 documents, so every fixed position and draw count fits
HOST_MODELS = {
    "random": lambda m: m.RandomClickModel(3),
    "fixed": lambda m: m.FixedClickModel([0, 2, 4]),
    "multiple": lambda m: m.MultipleClickModel(
        [m.RandomClickModel(2), m.OnlyRelevantClickModel(2)], [0.3, 0.7]),
    "conditioned_all": lambda m: m.ConditionedClickModel(
        [m.BaseCascadeModel(1, 1), m.OnlyRelevantClickModel(2)], "all"),
    "conditioned_any": lambda m: m.ConditionedClickModel(
        [m.BaseCascadeModel(1, 3), m.RandomClickModel(1)], np.any),
    "max_clicks": lambda m: m.MaxClicksModel(m.BaseCascadeModel(0.5, 1), 2),
    "only_relevant": lambda m: m.OnlyRelevantClickModel(2),
    "base_cascade": lambda m: m.BaseCascadeModel(1.0, 2),
    "diverse": lambda m: m.DiverseClicksModel(m.BaseCascadeModel(0, 1),
                                              0.5),
    "duplicates": lambda m: m.EverythingButDuplicatesClickModel(0.5),
}


def _slates(n, seed, pad=True, length=L):
    """n slates of ``length`` positions, ragged (5 to ``length`` real
    documents, the rest padded) or full; each slate repeats a document, so
    the duplicate-aware model has something to drop."""
    rng = np.random.RandomState(seed)
    xs, ys = [], []
    for _ in range(n):
        real = rng.randint(5, length + 1) if pad else length
        x = np.zeros((length, F), np.float32)
        y = np.full(length, PADDED_Y_VALUE, np.float32)
        x[:real] = rng.randn(real, F)
        x[3] = x[1]
        y[:real] = rng.randint(0, 5, real)
        xs.append(x)
        ys.append(y)
    return xs, ys


def _batch(b, seed, length=L):
    xs, ys = _slates(b, seed, length=length)
    return np.stack(xs), np.stack(ys)


# -- the host models ----------------------------------------------------------

@pytest.mark.parametrize("include_empty", [True, False])
@pytest.mark.parametrize("pad", [True, False], ids=["padded", "full"])
@pytest.mark.parametrize("name", sorted(HOST_MODELS))
def test_host_models_click_as_jax_does(name, pad, include_empty):
    slates = _slates(24, 1, pad=pad)
    outs = []
    for pkg in (tcm, jcm):
        np.random.seed(7)
        outs.append(pkg.click_on_slates(slates, HOST_MODELS[name](pkg),
                                        include_empty))
    (gx, gc), (rx, rc) = outs
    assert len(gx) == len(rx) == len(gc) == len(rc)
    if include_empty:
        assert len(gc) == 24
    for a, b in zip(gx, rx):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(gc, rc):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(HOST_MODELS))
def test_host_click_on_an_unpadded_slate_is_jax_s(name):
    xs, ys = _slates(6, 2, pad=False)
    for x, y in zip(xs, ys):
        np.random.seed(11)
        got = HOST_MODELS[name](tcm).click((x, y))
        np.random.seed(11)
        ref = HOST_MODELS[name](jcm).click((x, y))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_click_on_slates_without_clicks_returns_empty_lists():
    slates = _slates(5, 3)
    for pkg in (tcm, jcm):
        assert pkg.click_on_slates(slates, pkg.OnlyRelevantClickModel(9),
                                   include_empty=False) == ([], [])


def test_masked_remain_masked_restores_padding():
    xs, ys = _slates(4, 4)
    for x, y in zip(xs, ys):
        got = tcm.MaskedRemainMasked(tcm.OnlyRelevantClickModel(2)).click(
            (x, y))
        ref = jcm.MaskedRemainMasked(jcm.OnlyRelevantClickModel(2)).click(
            (x, y))
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
        assert (got[y == PADDED_Y_VALUE] == PADDED_Y_VALUE).all()


# -- the batch functions, given JAX's uniforms --------------------------------

def _t(a):
    return torch.from_numpy(np.array(a))


def _uniform(key, shape):
    return np.array(jax.random.uniform(key, shape))


@pytest.mark.parametrize("thr", [0, 2, 4.5])
def test_only_relevant_is_jax_s(thr):
    x, y = _batch(16, 5)
    ref = jm.only_relevant_clicks(None, jnp.asarray(y), thr)
    got = dm.only_relevant_clicks(None, _t(y), thr)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("positions", [[0, 2], [0, 2, -1, 50], [-13, 9]])
def test_fixed_is_jax_s(positions):
    x, y = _batch(16, 6)
    ref = jm.fixed_clicks(None, jnp.asarray(y), positions)
    got = dm.fixed_clicks(None, _t(y), positions)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("eta,thr", [(0, 1), (1, 2), (2, 1), (0.5, 2),
                                     (1.5, 3)])
def test_base_cascade_is_jax_s_given_its_uniforms(eta, thr):
    x, y = _batch(64, 7)
    key = jax.random.PRNGKey(3)
    ref = jm.base_cascade_clicks(key, jnp.asarray(y), eta, thr)
    u = _uniform(key, y.shape)
    got = dm.base_cascade_from_uniforms(_t(u), _t(y), eta, thr)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n", [1, 3, 5])
def test_random_is_jax_s_given_its_uniforms(n):
    x, y = _batch(64, 8)
    key = jax.random.PRNGKey(4)
    ref = jm.random_clicks(key, jnp.asarray(y), n)
    got = dm.random_from_uniforms(_t(_uniform(key, y.shape)), _t(y), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_max_clicks_is_jax_s():
    x, y = _batch(64, 9)
    key = jax.random.PRNGKey(5)
    jfn = jm.max_clicks(lambda r, yy, **kw: jm.base_cascade_clicks(
        r, yy, 0.5, 1), 2)
    u = _t(_uniform(key, y.shape))
    tfn = dm.max_clicks(lambda k, yy, x=None: dm.base_cascade_from_uniforms(
        u, yy, 0.5, 1), 2)
    np.testing.assert_array_equal(tfn(None, _t(y)).numpy(),
                                  np.asarray(jfn(key, jnp.asarray(y))))
    # through the dispatch, on a deterministic inner model
    jfn = jm.as_device_click_fn(jcm.MaxClicksModel(
        jcm.OnlyRelevantClickModel(1), 2))
    tfn = dm.as_device_click_fn(tcm.MaxClicksModel(
        tcm.OnlyRelevantClickModel(1), 2))
    np.testing.assert_array_equal(tfn(None, _t(y)).numpy(),
                                  np.asarray(jfn(key, jnp.asarray(y))))


def _jax_inner_fns():
    return [lambda r, yy, xx=None: jm.base_cascade_clicks(r, yy, 1.0, 1),
            lambda r, yy, xx=None: jm.random_clicks(r, yy, 2),
            lambda r, yy, xx=None: jm.only_relevant_clicks(r, yy, 3)]


def test_multiple_is_jax_s_given_its_uniforms():
    x, y = _batch(64, 10)
    key = jax.random.PRNGKey(6)
    inner = _jax_inner_fns()
    cum = np.float32([0.2, 0.5, 1.0])
    ref = jm.multiple_clicks(key, jnp.asarray(y), inner, cum)
    sel_key, *keys = jax.random.split(key, len(inner) + 1)
    outs = np.stack([np.asarray(fn(k, jnp.asarray(y)))
                     for fn, k in zip(inner, keys)])
    got = dm.multiple_from_uniforms(_t(_uniform(sel_key, (y.shape[0],))),
                                    _t(outs), cum, _t(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("combiner", ["all", "any"])
def test_conditioned_is_jax_s_given_its_inner_clicks(combiner):
    x, y = _batch(64, 11)
    key = jax.random.PRNGKey(7)
    inner = _jax_inner_fns()
    ref = jm.conditioned_clicks(key, jnp.asarray(y), inner,
                                {"all": jnp.all, "any": jnp.any}[combiner])
    keys = jax.random.split(key, len(inner))
    outs = np.stack([np.asarray(fn(k, jnp.asarray(y)))
                     for fn, k in zip(inner, keys)])
    got = dm.conditioned_from_clicks(_t(outs), combiner, _t(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.9, 1.0])
def test_diverse_is_jax_s_given_its_inner_clicks(q):
    x, y = _batch(64, 12, length=16)
    y[5, 1:] = PADDED_Y_VALUE  # one real document: margin 0
    x[5, 1:] = 0.0
    key = jax.random.PRNGKey(8)

    def inner(r, yy, xx=None):
        return jm.base_cascade_clicks(r, yy, 0.5, 1)

    ref = jm.diverse_clicks(key, jnp.asarray(y), jnp.asarray(x), inner, q)
    clicks = np.asarray(inner(key, jnp.asarray(y)))
    got = dm.diverse_from_clicks(_t(clicks), _t(y), _t(x), q)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_diverse_distances_and_margins_are_jax_s():
    x, y = _batch(32, 13, length=16)
    diff = jnp.asarray(x)[:, :, None, :] - jnp.asarray(x)[:, None, :, :]
    ref = np.asarray(jnp.sqrt(jnp.maximum(jnp.sum(diff * diff, axis=-1),
                                          0.0)))
    dist = dm.pairwise_distances(_t(x))
    np.testing.assert_allclose(dist.numpy(), ref, rtol=1e-6)
    assert torch.equal(dist, dist.transpose(1, 2))
    margin = dm.diverse_margin(dist, _t(y), 0.5).numpy()
    for b in range(len(y)):
        real = y[b] != PADDED_Y_VALUE
        d = ref[b][np.ix_(real, real)]
        want = np.quantile(d[np.triu_indices(int(real.sum()), k=1)], 0.5)
        np.testing.assert_allclose(margin[b], want, rtol=1e-6)


# -- the hashed draws against the host models' rates --------------------------

RATE_MODELS = ["random", "multiple", "conditioned_all", "conditioned_any",
               "max_clicks", "base_cascade", "diverse"]


@pytest.mark.parametrize("name", RATE_MODELS)
def test_hashed_draws_click_at_the_host_model_s_rate(name):
    """Per position over 4,096 slates, the device function's click rate
    (the port's hashed uniforms) within 5 binomial standard deviations of
    the host model's (np.random)."""
    x, y = _batch(4096, 14)
    np.random.seed(0)
    _, host = tcm.click_on_slates((list(x), list(y)), HOST_MODELS[name](tcm),
                                  include_empty=True)
    host = np.stack(host)
    fn = dm.as_device_click_fn(HOST_MODELS[name](tcm))
    dev = fn(dm.ClickKey(42, 0), _t(y), _t(x)).numpy()
    np.testing.assert_array_equal(dev == PADDED_Y_VALUE,
                                  y == PADDED_Y_VALUE)
    real = y != PADDED_Y_VALUE
    n = real.sum(axis=0)
    p_host = ((host == 1) & real).sum(axis=0) / n
    p_dev = ((dev == 1) & real).sum(axis=0) / n
    pooled = (p_host + p_dev) / 2
    sd = np.sqrt(pooled * (1 - pooled) * 2 / n)
    assert (np.abs(p_dev - p_host) <= 5 * sd + 1e-12).all(), (p_host, p_dev)


def test_click_keys_are_pure_functions_of_seed_batch_stream_and_index():
    key = dm.ClickKey(42, 3)
    u = key.uniform((8, 16))
    assert u.dtype == torch.float32 and (u >= 0).all() and (u < 1).all()
    assert torch.equal(u, dm.ClickKey(42, 3).uniform((8, 16)))
    # a slice of a draw is the draw of the slice's indices
    assert torch.equal(u.reshape(-1)[:40], key.uniform((40,)))
    others = [dm.ClickKey(43, 3), dm.ClickKey(42, 4), *key.split(2)]
    for other in others:
        assert not torch.equal(u, other.uniform((8, 16)))
    a, b = key.split(2)
    assert a != b and key.split(2) == [a, b]


# -- the dispatch ----------------------------------------------------------------

DISPATCH = {
    **HOST_MODELS,
    "diverse_over_duplicates": lambda m: m.DiverseClicksModel(
        m.EverythingButDuplicatesClickModel()),
    "multiple_with_duplicates": lambda m: m.MultipleClickModel(
        [m.OnlyRelevantClickModel(1), m.EverythingButDuplicatesClickModel()],
        [0.5, 0.5]),
    "conditioned_with_duplicates": lambda m: m.ConditionedClickModel(
        [m.OnlyRelevantClickModel(1), m.EverythingButDuplicatesClickModel()],
        "any"),
    "conditioned_by_a_host_callable": lambda m: m.ConditionedClickModel(
        [m.OnlyRelevantClickModel(1), m.BaseCascadeModel(1, 1)], np.max),
    "max_of_duplicates": lambda m: m.MaxClicksModel(
        m.EverythingButDuplicatesClickModel(), 3),
    "max_without_a_cap": lambda m: m.MaxClicksModel(
        m.BaseCascadeModel(1, 1), None),
    "multiple_with_diverse": lambda m: m.MultipleClickModel(
        [m.DiverseClicksModel(m.RandomClickModel(2)),
         m.OnlyRelevantClickModel(1)], [0.5, 0.5]),
    "max_of_diverse": lambda m: m.MaxClicksModel(
        m.DiverseClicksModel(m.BaseCascadeModel(1, 1)), 1),
}
ON_THE_HOST = {"duplicates", "diverse_over_duplicates",
               "multiple_with_duplicates", "conditioned_with_duplicates",
               "conditioned_by_a_host_callable", "max_of_duplicates"}


@pytest.mark.parametrize("name", sorted(DISPATCH))
def test_dispatch_is_jax_s(name):
    ref = jm.as_device_click_fn(DISPATCH[name](jcm))
    got = dm.as_device_click_fn(DISPATCH[name](tcm))
    assert (got is None) == (ref is None) == (name in ON_THE_HOST)
    if got is not None:
        assert (getattr(got, "needs_x", False)
                == getattr(ref, "needs_x", False))


def test_diverse_without_features_raises():
    fn = dm.as_device_click_fn(HOST_MODELS["diverse"](tcm))
    with pytest.raises(ValueError, match="ranked features"):
        fn(dm.ClickKey(0, 0), torch.zeros(2, 3))


def test_configs_of_either_package_instantiate_the_port_s_classes():
    cfg = {"name": "allrank.click_models.cascade_models.DiverseClicksModel",
           "args": {"inner_click_model": {
               "name": "allrank.click_models.cascade_models.BaseCascadeModel",
               "args": {"eta": 0.0, "threshold": 2}},
               "q_percentile": 0.5}}
    model = instantiate_from_recursive_name_args(NameArgsConfig(**cfg))
    ref = jax_instantiate(JaxNameArgs(**cfg))
    assert isinstance(model, tcm.DiverseClicksModel)
    assert isinstance(model.inner_click_model, tcm.BaseCascadeModel)
    assert type(ref).__module__.startswith("allrank_tpu.")
    assert (model.q_percentile, model.inner_click_model.eta,
            model.inner_click_model.threshold) == (0.5, 0.0, 2)
    fixed = instantiate_class("allrank_tpu.click_models.base.FixedClickModel",
                              click_positions=[0, 2])
    assert isinstance(fixed, tcm.FixedClickModel)
    same = instantiate_class(
        "allrank_tpu_torch.click_models.base.OnlyRelevantClickModel",
        relevancy_threshold=1)
    assert isinstance(same, tcm.OnlyRelevantClickModel)
