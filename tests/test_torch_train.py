"""The port's train step (allrank_tpu_torch/training) against the JAX
package's ``make_train_step`` at dropout 0 in fp32, with the weights
carried in by ``load_jax_params`` and out by ``export_params``; the
optimizer registry, the config sections a train step reads, and a step
with dropout on the plain versions of the kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import allrank_tpu.config as jconfig
from allrank_tpu.data.batching import SlateBatch
from allrank_tpu.losses import accumulation_weighting as jax_accum
from allrank_tpu.losses.lambdaloss import lambdaLoss as jax_lambdaLoss
from allrank_tpu.models import factory as jfactory
from allrank_tpu.training import make_optimizer as jax_make_optimizer
from allrank_tpu.training.train_utils import (
    make_train_step as jax_make_train_step,
)
from allrank_tpu_torch import config as tconfig
from allrank_tpu_torch.interop import (
    export_params,
    flatten_params,
    load_jax_params,
)
from allrank_tpu_torch.losses import accumulation_weighting, lambdaLoss
from allrank_tpu_torch.models.factory import LTRModel, make_model
from allrank_tpu_torch.training import (
    get_learning_rate,
    make_optimizer,
    make_train_step,
    set_learning_rate,
)

torch.set_num_threads(2)

B, L, F = 4, 12, 7
LOSS_KW = {"weighing_scheme": "ndcgLoss2PP_scheme", "mu": 10.0}
# fp32 through two blocks, the loss and the backward, in another order of
# summation (JAX's XLA path on the CPU against the port's plain kernels)
GRAD_RTOL = 1e-4


def _grad_atol(grads) -> float:
    """A gradient that is zero in exact arithmetic (the output bias under a
    shift-invariant loss) is fp32 noise from sums of much larger terms: the
    absolute tolerance scales with the largest gradient."""
    return 1e-5 * max(float(np.abs(g).max()) for g in grads)


def _model_config(cfg, dropout=0.0):
    return cfg.ModelConfig(
        fc_model=cfg.FCConfig(sizes=[16], input_norm=True,
                              activation="ReLU", dropout=dropout),
        transformer=cfg.TransformerConfig(
            N=2, d_ff=32, h=2, dropout=dropout,
            positional_encoding=cfg.PositionalEncodingConfig(
                strategy="fixed", max_indices=20)),
        post_model=cfg.PostModelConfig(d_output=1))


def _pair(seed=0):
    jdef = jfactory.make_model(_model_config(jconfig), F)
    params = jax.tree.map(np.asarray, jfactory.init_params(
        jax.random.PRNGKey(seed), jdef))
    model = load_jax_params(
        LTRModel(make_model(_model_config(tconfig), F), device="cpu"),
        params)
    return jdef, params, model


def _batch(seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, L, F).astype(np.float32)
    y = rng.randint(0, 5, size=(B, L)).astype(np.float32)
    y[1, 8:] = -1.0  # a padding tail
    y[3, :] = -1.0  # a dummy slate, also masked out below
    indices = np.tile(np.arange(L, dtype=np.int32), (B, 1))
    indices[y == -1.0] = -1
    slate_mask = np.array([True, True, True, False])
    return x, y, indices, slate_mask


def _jax_run(jdef, params, opt, steps, clip=None, accum=1):
    step = jax_make_train_step(
        jdef, jax_lambdaLoss, LOSS_KW, False, opt, clip, "float32",
        accumulation_steps=accum,
        accum_weighting=jax_accum("lambdaLoss", LOSS_KW))
    params = jax.tree.map(jnp.asarray, params)
    state = opt.init(params)
    rng = jax.random.PRNGKey(0)
    losses = []
    for _ in range(steps):
        params, state, rng, loss, _ = step(params, state, rng,
                                           SlateBatch(*_batch()))
        losses.append(float(loss))
    return jax.tree.map(np.asarray, params), state, losses


def _port_run(model, opt, steps, clip=None, accum=1):
    step = make_train_step(model, lambdaLoss, LOSS_KW, False, opt, clip,
                           "float32", accumulation_steps=accum,
                           accum_weighting=accumulation_weighting(
                               "lambdaLoss", LOSS_KW))
    losses = []
    for _ in range(steps):
        loss, n_real = step(*_batch())
        assert n_real.item() == 3.0
        losses.append(loss.item())
    return losses


def _trainable(flat):
    return {k: v for k, v in flat.items() if not k.endswith("pe|table")}


def test_step_one_loss_and_gradients_match_jax():
    jdef, params, model = _pair()
    x, y, indices, slate_mask = _batch()

    def loss_of(p):
        preds = jfactory.forward(p, jdef, jnp.asarray(x), jnp.asarray(y == -1),
                                 jnp.asarray(indices), train=True,
                                 rng=jax.random.PRNGKey(0))
        return jax_lambdaLoss(preds, jnp.asarray(y),
                              slate_mask=jnp.asarray(slate_mask), **LOSS_KW)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_of))(
        jax.tree.map(jnp.asarray, params))
    opt = make_optimizer("SGD", {"lr": 0.0}, model.parameters())
    (loss,) = _port_run(model, opt, 1)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=2e-5)
    ref = _trainable(flatten_params(jax.tree.map(np.asarray, ref_grads)))
    got = {name.replace(".", "|"): p.grad.numpy()
           for name, p in model.named_parameters()}
    assert set(got) == set(ref)
    atol = _grad_atol(ref.values())
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], err_msg=key,
                                   rtol=GRAD_RTOL, atol=atol)


@pytest.mark.parametrize("accum,clip", [(1, None), (2, None), (1, 0.05),
                                        (2, 0.05)])
def test_params_after_three_sgd_steps_match_jax(accum, clip):
    """SGD keeps each parameter's change proportional to its gradient, so
    the comparison is as tight as the gradients': they agree to about 1e-5
    of the largest, so three steps at lr 0.1 leave the parameters within
    1e-5. The clip norm 0.05 binds (the global norm is above 1 here)."""
    jdef, params, model = _pair(seed=3)
    ref_params, _, ref_losses = _jax_run(
        jdef, params, jax_make_optimizer("SGD", {"lr": 0.1}), 3, clip, accum)
    losses = _port_run(model, make_optimizer("SGD", {"lr": 0.1},
                                             model.parameters()), 3, clip,
                       accum)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    ref = flatten_params(ref_params)
    got = export_params(model)
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)


def test_adam_state_matches_jax():
    """Adam's first update is +-lr wherever |g| >> eps and flips sign on
    near-zero gradients, so Adam is held on its moments m and v, and the
    parameters only to an update-sized tolerance."""
    jdef, params, model = _pair(seed=5)
    lr = 1e-3
    ref_params, state, _ = _jax_run(
        jdef, params, jax_make_optimizer("Adam", {"lr": lr}), 2)
    opt = make_optimizer("Adam", {"lr": lr}, model.parameters())
    _port_run(model, opt, 2)
    adam = state.inner_state[1]
    ref_m = flatten_params(jax.tree.map(np.asarray, adam.mu))
    ref_v = flatten_params(jax.tree.map(np.asarray, adam.nu))
    atol = _grad_atol(ref_m.values())
    for name, p in model.named_parameters():
        key = name.replace(".", "|")
        st = opt.state[p]
        np.testing.assert_allclose(st["exp_avg"].numpy(), ref_m[key],
                                   rtol=GRAD_RTOL, atol=atol, err_msg=key)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), ref_v[key],
                                   rtol=2e-4, atol=1e-10, err_msg=key)
    got, ref = export_params(model), flatten_params(ref_params)
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=0,
                                   atol=2 * 2 * lr, err_msg=key)


def test_step_with_dropout_is_reproducible_from_the_generator_seed():
    def run(seed):
        model = LTRModel(make_model(_model_config(tconfig, dropout=0.3), F),
                         torch.Generator().manual_seed(0), device="cpu")
        opt = make_optimizer("Adam", {"lr": 1e-3}, model.parameters())
        step = make_train_step(model, lambdaLoss, LOSS_KW, False, opt, None,
                               generator=torch.Generator().manual_seed(seed))
        losses = [step(*_batch())[0].item() for _ in range(3)]
        return losses, export_params(model)

    (l1, p1), (l2, p2), (l3, _) = run(7), run(7), run(8)
    assert l1 == l2 and np.isfinite(l1).all()
    for key in p1:
        np.testing.assert_array_equal(p1[key], p2[key])
    assert l1 != l3  # another seed, other masks
    # train=False (scoring) applies no dropout: the output is deterministic
    model = LTRModel(make_model(_model_config(tconfig, dropout=0.3), F),
                     torch.Generator().manual_seed(0), device="cpu")
    x, y, indices, _ = _batch()
    args = (torch.tensor(x), torch.tensor(y == -1), torch.tensor(indices))
    with torch.no_grad():
        assert torch.equal(model(*args), model(*args))
        g = torch.Generator().manual_seed(1)
        assert not torch.equal(model(*args), model(*args, train=True,
                                                   generator=g))


def test_export_params_inverts_load_jax_params():
    _, params, model = _pair()
    flat = export_params(model)
    ref = flatten_params(params)
    assert set(flat) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(flat[key], ref[key])


@pytest.mark.parametrize("name,args", [
    ("Adam", {"lr": 1e-2, "betas": [0.8, 0.95], "eps": 1e-7,
              "weight_decay": 1e-2, "amsgrad": True}),
    ("AdamW", {"lr": 1e-2, "weight_decay": 0.05}),
    ("SGD", {"lr": 0.1, "momentum": 0.9, "nesterov": True}),
    ("RMSprop", {"lr": 1e-2, "alpha": 0.95, "centered": True}),
    ("Adagrad", {"lr": 1e-2}), ("Adadelta", {"rho": 0.8}),
    ("NAdam", {"lr": 2e-3}), ("RAdam", {"lr": 1e-3})])
def test_optimizer_trajectory_matches_jax(name, args):
    """Ten steps on one parameter vector with a varied gradient stream:
    the port's torch.optim against the JAX package's optax chain (the
    optimizers of tests/training/test_optimizer_parity.py), in fp64."""
    import optax

    w0 = np.array([1.0, -2.0, 0.5, 3.0])
    grads = [np.array([0.1 * (t + 1), -0.2, 0.3 * np.sin(t + 1.0),
                       0.05 * (-1.0) ** t]) for t in range(10)]
    p = torch.nn.Parameter(torch.tensor(w0))
    opt = make_optimizer(name, args, [p])
    with jax.enable_x64():
        tx = jax_make_optimizer(name, dict(args))
        params = {"w": jnp.asarray(w0)}
        state = tx.init(params)
        for g in grads:
            opt.zero_grad()
            p.grad = torch.tensor(g)
            opt.step()
            updates, state = tx.update({"w": jnp.asarray(g)}, state, params)
            params = optax.apply_updates(params, updates)
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params["w"]), rtol=0,
                                       atol=1e-6)


def test_optimizer_defaults_and_learning_rate():
    p = torch.nn.Parameter(torch.zeros(2))
    opt = make_optimizer("SGD", {}, [p])
    assert get_learning_rate(opt) == 1e-2  # the JAX package's default
    set_learning_rate(opt, 0.5)
    assert get_learning_rate(opt) == 0.5
    with pytest.raises(ValueError, match="Unknown optimizer"):
        make_optimizer("Lion", {}, [p])


def test_config_parses_every_reproducibility_config():
    import glob
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = sorted(glob.glob(os.path.join(repo, "reproducibility", "configs",
                                          "*", "*.json")))
    assert len(paths) == 7
    for path in paths:
        cfg, ref = tconfig.Config.from_json(path), jconfig.Config.from_json(
            path)
        assert vars(cfg.data) == vars(ref.data), path
        assert vars(cfg.training) == vars(ref.training), path
        for section in ("optimizer", "loss", "lr_scheduler"):
            assert vars(getattr(cfg, section)) == vars(getattr(ref, section))
