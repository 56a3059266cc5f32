"""The encoder beyond the sublayer kernel's 1024 documents: the port's split
block (LayerNorm and projections in PyTorch ops around the bare attention
kernel B4 or B5, their plain versions on the CPU) against the JAX package's
model, which takes its XLA attention path on the CPU; the split block
against the B1 block at p > 0; and the dispatch by slate length."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import allrank_tpu.config as jconfig
from allrank_tpu.losses.lambdaloss import lambdaLoss as jax_lambdaLoss
from allrank_tpu.models import factory as jfactory
from allrank_tpu_torch import config as tconfig
from allrank_tpu_torch.interop import flatten_params, load_jax_params
from allrank_tpu_torch.losses import lambdaLoss
from allrank_tpu_torch.models.factory import LTRModel, make_model
from allrank_tpu_torch.models.transformer import (
    EncoderBlock,
    TransformerDef,
    encoder_form,
)
from allrank_tpu_torch.ops.attention_fused import fused_slate_attention
from allrank_tpu_torch.ops.attention_tiled import tiled_slate_attention
from allrank_tpu_torch.training import make_optimizer, make_train_step

torch.set_num_threads(2)

F = 6
LOSS_KW = {"weighing_scheme": "ndcgLoss2PP_scheme", "mu": 10.0}


def _model_config(cfg, pe):
    return cfg.ModelConfig(
        fc_model=cfg.FCConfig(sizes=[16], input_norm=True, activation="ReLU",
                              dropout=0.0),
        transformer=cfg.TransformerConfig(
            N=2, d_ff=32, h=2, dropout=0.0,
            positional_encoding=(cfg.PositionalEncodingConfig(
                strategy="fixed", max_indices=256) if pe else None)),
        post_model=cfg.PostModelConfig(d_output=1))


def _pair(pe):
    jdef = jfactory.make_model(_model_config(jconfig, pe), F)
    params = jax.tree.map(np.asarray, jfactory.init_params(
        jax.random.PRNGKey(0), jdef))
    model = load_jax_params(
        LTRModel(make_model(_model_config(tconfig, pe), F), device="cpu"),
        params)
    return jdef, params, model


def _batch(l, seed=1):
    """Two slates: one full, one ragged (a padding tail of 150)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, l, F).astype(np.float32)
    y = rng.randint(0, 5, size=(2, l)).astype(np.float32)
    y[1, l - 150:] = -1.0
    indices = np.tile(np.arange(l, dtype=np.int32), (2, 1))
    indices[y == -1.0] = -1
    return x, y, indices


# L=1100 takes B4 with the flagship's fixed positional encoding, whose 256
# ranks are fewer than L: ranks past it read the zero padding row, as in
# the JAX package (models/positional.py:35 there); L=1300 takes B5
CASES = [(1100, True), (1300, False)]


@pytest.mark.parametrize("l,pe", CASES, ids=["b4-fixed-pe", "b5-no-pe"])
def test_scores_match_jax(l, pe):
    jdef, params, model = _pair(pe)
    x, y, indices = _batch(l)
    mask = y == -1.0
    ref = np.asarray(jfactory.score(params, jdef, x, mask, indices))
    with torch.inference_mode():
        got = model.score(torch.tensor(x), torch.tensor(mask),
                          torch.tensor(indices).long()).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    # fp32 through two blocks, summed in another order
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("l,pe", CASES, ids=["b4-fixed-pe", "b5-no-pe"])
def test_train_step_matches_jax(l, pe):
    """Step 1 at dropout 0 in fp32: the loss at 1e-4, each gradient within
    1e-3 of its tensor's largest value plus 1e-5 of the largest gradient
    (the rule of the card's step checks; a gradient that is zero in exact
    arithmetic is fp32 noise of larger sums)."""
    jdef, params, model = _pair(pe)
    x, y, indices = _batch(l, seed=2)

    def loss_of(p):
        preds = jfactory.forward(p, jdef, jnp.asarray(x), jnp.asarray(y == -1),
                                 jnp.asarray(indices), train=True,
                                 rng=jax.random.PRNGKey(0))
        return jax_lambdaLoss(preds, jnp.asarray(y), **LOSS_KW)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_of))(
        jax.tree.map(jnp.asarray, params))
    opt = make_optimizer("SGD", {"lr": 0.0}, model.parameters())
    step = make_train_step(model, lambdaLoss, LOSS_KW, False, opt, None,
                           "float32")
    loss, _ = step(x, y, indices)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    ref = {k: v for k, v in flatten_params(
        jax.tree.map(np.asarray, ref_grads)).items()
        if not k.endswith("pe|table")}
    got = {name.replace(".", "|"): p.grad.numpy()
           for name, p in model.named_parameters()}
    assert set(got) == set(ref)
    top = max(float(np.abs(g).max()) for g in ref.values())
    for key, r in ref.items():
        err = float(np.abs(got[key] - r).max())
        assert err <= 1e-3 * float(np.abs(r).max()) + 1e-5 * top, (key, err)


def _block_inputs(b, l, d, seed, last=0):
    """x and a mask: slate 0 full, slate 1 a third, slate 2 ``last``
    documents."""
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(b, l, d).astype(np.float32))
    lengths = np.array([l, l // 3, last][:b])
    mask = torch.tensor(np.arange(l)[None, :] >= lengths[:, None])
    return x, mask


@pytest.mark.parametrize("form", [
    pytest.param(fused_slate_attention, id="fused"),
    pytest.param(tiled_slate_attention, id="tiled")])
def test_split_block_equals_the_b1_block_at_dropout(form):
    """At L=240 and p=0.3 with the same four seeds the split block computes
    the B1 block's function with B1's masks (the keyed hash on the global
    element index of each tensor): the same output and gradients, through
    the plain versions. With B4 the forward is B1's to the bit; B5's
    recurrence sums in another order. The gradients are taken on slates
    with a valid document: on a fully padded one B5's dv is L times B1's
    (P rebuilt from an lse that fp32 rounds to -1e9, as in the JAX B5;
    ROADMAP Queue C), which the forward below shows is the only difference
    there, and which the losses never reach (they mask padded documents)."""
    d, h, l = 32, 2, 240
    block = EncoderBlock(TransformerDef(N=1, d_model=d, d_ff=64, h=h,
                                        dropout=0.3),
                         torch.Generator().manual_seed(0))
    seeds = (11, 22, 33, 44)
    x, empty_mask = _block_inputs(3, l, d, seed=4)
    with torch.no_grad():
        torch.testing.assert_close(block(x, empty_mask, 0.3, seeds, form),
                                   block(x, empty_mask, 0.3, seeds),
                                   rtol=1e-5, atol=1e-5)
    x, mask = _block_inputs(3, l, d, seed=4, last=7)
    outs, grads = [], []
    for f in (None, form):
        block.zero_grad()
        xx = x.clone().requires_grad_()
        y = block(xx, mask, 0.3, seeds, f)
        (y * torch.linspace(-1, 1, d)).sum().backward()
        outs.append(y.detach())
        grads.append([xx.grad] + [p.grad.clone() for p in block.parameters()])
    if form is fused_slate_attention:
        assert torch.equal(outs[1], outs[0])
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-5)
    for g, r in zip(grads[1], grads[0]):
        scale = r.abs().max().item()
        assert (g - r).abs().max().item() <= 1e-4 * scale + 1e-6
    # the masks really are on: dropout 0 gives another output
    assert (block(x, mask, 0.0, seeds, form) - outs[0]).abs().max() > 1e-2


def test_dispatch_by_slate_length():
    forms = {l: encoder_form(l, "cuda") for l in (1, 240, 1024, 1025, 1224,
                                                  1225, 4096, 8192)}
    b4, b5 = fused_slate_attention, tiled_slate_attention
    assert forms == {1: None, 240: None, 1024: None, 1025: b4, 1224: b4,
                     1225: b5, 4096: b5, 8192: b5}
    with pytest.raises(NotImplementedError, match="L <= 8192"):
        encoder_form(8193, "cuda")
    # CPU tensors run the plain versions at any length
    assert encoder_form(8193, "cpu") is tiled_slate_attention


def test_long_block_runs_each_form_on_the_cpu():
    """Through ``Transformer.forward`` the form follows L: the block output
    at L=1100 and 1300 is finite and the fully padded slate's rows too."""
    from allrank_tpu_torch.models.transformer import Transformer

    tdef = TransformerDef(N=1, d_model=16, d_ff=32, h=2, dropout=0.0)
    enc = Transformer(tdef, torch.Generator().manual_seed(1))
    for l in (1100, 1300):
        x, mask = _block_inputs(3, l, 16, seed=l)
        with torch.inference_mode():
            y = enc(x, mask, torch.zeros(3, l, dtype=torch.long))
        assert y.shape == (3, l, 16) and torch.isfinite(y).all()
