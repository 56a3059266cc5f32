"""The NeuralNDCG losses of the port against the JAX package's, value and
gradient, on the same inputs made from a numpy seed; fp32 on the CPU, where
both packages take their plain chain with the tolerance freeze.

Tolerances: the loss is a mean of NDCG values in [0, 1], held to atol 2e-6
(fp32 sums in another order through the 50-iteration scaling); its gradient
to rtol 1e-4 with atol 2e-6, the Sinkhorn recurrence's cancellation
amplifying the same rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import allrank_tpu.losses.neuralndcg as jn
import allrank_tpu.ops.soft_sort as jss
import allrank_tpu_torch.losses.neuralndcg as tn
import allrank_tpu_torch.ops.soft_sort as tss

VALUE = dict(rtol=0, atol=2e-6)
GRAD = dict(rtol=1e-4, atol=2e-6)
LOSSES = {"neuralNDCG": (jn.neuralNDCG, tn.neuralNDCG),
          "neuralNDCG_transposed": (jn.neuralNDCG_transposed,
                                    tn.neuralNDCG_transposed)}


def _batch(seed=0, b=6, l=10):
    rng = np.random.RandomState(seed)
    y_pred = rng.randn(b, l).astype(np.float32)
    y_true = rng.randint(0, 5, (b, l)).astype(np.float32)
    for i, n in enumerate([10, 7, 4, 10, 1, 0][:b]):
        y_true[i, n:] = -1
    y_true[3, :] = 0.0       # IDCG == 0: left out of the mean
    return y_pred, y_true


def _both(name, y_pred, y_true, jax_kw=None, torch_kw=None, **kw):
    """((value, gradient) of the port, (value, gradient) of the JAX loss);
    ``kw`` goes to both, ``jax_kw`` and ``torch_kw`` to one."""
    jax_fn, torch_fn = LOSSES[name]
    jax_kw = dict(kw, **(jax_kw or {}))
    kw = dict(kw, **(torch_kw or {}))
    ref_v, ref_g = jax.value_and_grad(
        lambda p: jax_fn(p, jnp.asarray(y_true), **jax_kw))(
            jnp.asarray(y_pred))
    p = torch.tensor(y_pred, requires_grad=True)
    got = torch_fn(p, torch.tensor(y_true), **kw)
    got.backward()
    return (got.item(), p.grad.numpy()), (float(ref_v), np.asarray(ref_g))


@pytest.mark.parametrize("kw", [
    {}, {"k": 3}, {"k": 50}, {"powered_relevancies": False},
    {"temperature": 0.5, "k": 5}])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name, kw):
    y_pred, y_true = _batch()
    (got_v, got_g), (ref_v, ref_g) = _both(name, y_pred, y_true, **kw)
    np.testing.assert_allclose(got_v, ref_v, **VALUE)
    np.testing.assert_allclose(got_g, ref_g, **GRAD)
    assert got_v < 0 and not got_g[y_true == -1].any()
    assert not got_g[3].any()  # the IDCG == 0 slate


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_with_slate_mask_matches_jax(name):
    y_pred, y_true = _batch(1)
    sm = np.array([True, False, True, True, True, False])
    (got_v, got_g), (ref_v, ref_g) = _both(
        name, y_pred, y_true, jax_kw={"slate_mask": jnp.asarray(sm)},
        torch_kw={"slate_mask": torch.tensor(sm)})
    np.testing.assert_allclose(got_v, ref_v, **VALUE)
    np.testing.assert_allclose(got_g, ref_g, **GRAD)
    assert not got_g[~sm].any()
    # no valid slate at all: the loss is 0, not NaN
    none = tn.neuralNDCG(torch.tensor(y_pred), torch.tensor(y_true),
                         slate_mask=torch.zeros(6, dtype=torch.bool))
    assert none.item() == 0.0


def test_transposed_variant_keeps_the_powered_idcg_quirk():
    """With identity gains the transposed loss still divides by the
    powered-gain IDCG, as the reference does."""
    y_pred, y_true = _batch(2)
    (got_v, _), (ref_v, _) = _both("neuralNDCG_transposed", y_pred, y_true,
                                   powered_relevancies=False)
    np.testing.assert_allclose(got_v, ref_v, **VALUE)
    (plain_v, _), _ = _both("neuralNDCG", y_pred, y_true,
                            powered_relevancies=False)
    assert abs(got_v) < abs(plain_v)


@pytest.mark.parametrize("log_scores", [True, False])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_stochastic_loss_matches_jax_on_the_same_noise(name, log_scores,
                                                       monkeypatch):
    y_pred, y_true = _batch(3)
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jss.sample_gumbel(key, (4, 6, 10)))
    monkeypatch.setattr(tss, "sample_gumbel",
                        lambda gen, shape, eps=1e-10, device=None:
                        torch.tensor(noise))
    kw = dict(stochastic=True, n_samples=4, beta=0.1, log_scores=log_scores)
    (got_v, got_g), (ref_v, ref_g) = _both(
        name, y_pred, y_true, jax_kw={"rng": key},
        torch_kw={"generator": torch.Generator()}, **kw)
    np.testing.assert_allclose(got_v, ref_v, **VALUE)
    np.testing.assert_allclose(got_g, ref_g, **GRAD)


def test_stochastic_loss_depends_only_on_the_generator_state():
    y_pred, y_true = _batch(4)
    gen = torch.Generator().manual_seed(9)
    state = gen.get_state()
    args = (torch.tensor(y_pred), torch.tensor(y_true))
    kw = dict(stochastic=True, n_samples=3)
    a = tn.neuralNDCG(*args, generator=gen, **kw)
    b = tn.neuralNDCG(*args, generator=gen, **kw)
    gen.set_state(state)
    c = tn.neuralNDCG(*args, generator=gen, **kw)
    assert a.item() == c.item() and a.item() != b.item()
    with pytest.raises(ValueError, match="generator"):
        tn.neuralNDCG(*args, stochastic=True)
    with pytest.raises(ValueError, match="generator"):
        tn.neuralNDCG_transposed(*args, stochastic=True)


def test_dispatch_envelope_is_the_jax_kernels_caps():
    """The fused kernel is taken only for CUDA tensors up to L = 512; a CPU
    tensor takes the plain chain at every length."""
    cpu = torch.zeros(1, 4)
    assert not tn.soft_sort_available(cpu, 4)
    assert not tn.soft_sort_available(cpu, 513)

    class OnCard:
        device = torch.device("cuda", 0)

    assert tn.soft_sort_available(OnCard, 512)
    assert not tn.soft_sort_available(OnCard, 513)


def test_long_slates_take_the_plain_chain_on_the_cpu():
    """L = 520, beyond the fused kernel's length: the same value as the JAX
    package's chain (one slate, so that the test stays small)."""
    rng = np.random.RandomState(6)
    y_pred = rng.randn(1, 520).astype(np.float32)
    y_true = rng.randint(0, 5, (1, 520)).astype(np.float32)
    y_true[0, 400:] = -1
    ref = jn.neuralNDCG(jnp.asarray(y_pred), jnp.asarray(y_true), k=10)
    got = tn.neuralNDCG(torch.tensor(y_pred), torch.tensor(y_true), k=10)
    np.testing.assert_allclose(got.item(), float(ref), rtol=0, atol=1e-5)
