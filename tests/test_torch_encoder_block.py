"""The port's whole-encoder B10 (allrank_tpu_torch/ops/encoder_block.py)
against the JAX package's: the TPU kernel's forward and gradients in Pallas
interpret mode on the CPU, torch autograd of the port's own plain forward,
the chained plain sublayers, the stacked weights carried across, and the
``MEGA_ENCODER_ENABLED`` switch of the port's encoder.

On the CPU the port's wrappers take their plain PyTorch versions (the CUDA
kernels run only on the card; tests/test_torch_gpu.py holds them against
the plain versions there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import allrank_tpu.models.transformer as JT
import allrank_tpu_torch.models.transformer as T
from allrank_tpu.ops import encoder_block as jax_encoder
from allrank_tpu_torch import config as tconfig
from allrank_tpu_torch.interop import load_jax_params
from allrank_tpu_torch.models.core import std_layer_norm
from allrank_tpu_torch.models.factory import LTRModel, make_model
from allrank_tpu_torch.ops import encoder_block
from allrank_tpu_torch.ops.attention_block import AttentionSublayer
from allrank_tpu_torch.ops.encoder_block import (
    encoder_backward_plain,
    encoder_forward_plain,
    stack_block_weights,
)
from allrank_tpu_torch.ops.ffn_block import FFNSublayer

torch.set_num_threads(2)

N, D, D_FF, H, B, L = 2, 32, 64, 2, 4, 24
LENGTHS = (L, 9, 1, 0)  # full, ragged, one document, fully padded
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, ref, dtype, what):
    """tests/test_torch_backward.py's rule: fp32, the same arithmetic
    summed in another order; bf16, the same rounding points, where an fp32
    sum on the other side of a rounding edge moves a bf16 intermediate by
    one ulp: 2^-6 of the tensor's largest value."""
    got = np.asarray(got, dtype=np.float32)
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape, what
    assert np.isfinite(got).all(), what
    scale = float(np.abs(ref).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-5 * scale + 1e-6, err_msg=what)
    else:
        err = float(np.abs(got - ref).max())
        assert err <= 2 ** -6 * scale + 1e-6, (what, err, scale)


def _inputs(seed=0, n=N, d=D, d_ff=D_FF, lengths=LENGTHS, l=L):
    """x, an output cotangent, the key mask, the 12 stacked weights and the
    final LN pair, as numpy, from a seed."""
    rng = np.random.RandomState(seed)
    x = rng.randn(len(lengths), l, d).astype(np.float32)
    dy = rng.randn(len(lengths), l, d).astype(np.float32)
    mask = np.arange(l)[None, :] >= np.asarray(lengths)[:, None]

    def vec(m, center=0.0):
        return (center + 0.1 * rng.randn(n, m)).astype(np.float32)

    def mat(m, k):
        return (rng.randn(n, m, k) / np.sqrt(m)).astype(np.float32)

    stacks = [vec(d, 1.0), vec(d), mat(d, 3 * d), vec(3 * d), mat(d, d),
              vec(d), vec(d, 1.0), vec(d), mat(d, d_ff), vec(d_ff),
              mat(d_ff, d), vec(d)]
    fs = (1.0 + 0.1 * rng.randn(d)).astype(np.float32)
    fb = (0.1 * rng.randn(d)).astype(np.float32)
    return x, dy, mask, stacks, fs, fb


def _t(arrays):
    return [torch.tensor(a) for a in arrays]


def _jax_encoder(x, mask, seeds, stacks, fs, fb, p=0.0):
    return jax_encoder.encoder_forward(
        x, jnp.asarray(mask), jnp.asarray(seeds, jnp.int32),
        tuple(map(jnp.asarray, stacks)), jnp.asarray(fs), jnp.asarray(fb),
        h=H, p_drop=p)


# ----------------------------------------------------------------------------
# the plain versions against the TPU kernel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_plain_matches_tpu_kernel(dtype):
    jdt, tdt = DTYPES[dtype]
    x, _, mask, stacks, fs, fb = _inputs(seed=1)
    seeds = [0] * (4 * N)
    with pltpu.force_tpu_interpret_mode():
        ref = _jax_encoder(jnp.asarray(x, jdt), mask, seeds, stacks, fs, fb)
    got = encoder_forward_plain(torch.tensor(x).to(tdt), torch.tensor(mask),
                                seeds, _t(stacks), *_t((fs, fb)), h=H)
    assert got.dtype == tdt
    got = got.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        # the JAX package's own tolerance for B10 (tests/ops/test_mega_blocks)
        np.testing.assert_allclose(got, ref, atol=2e-5)
    else:
        err = float(np.abs(got - ref).max())
        assert err <= 2 ** -6 * float(np.abs(ref).max()), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_plain_matches_tpu_kernel_grad(dtype):
    """dx, the 12 stacked gradients and the final LN pair against jax.grad
    of sum(sin(encoder_forward)), the cotangent cos(y) taken from the JAX
    forward so that both sides differentiate at the same point."""
    jdt, tdt = DTYPES[dtype]
    x, _, mask, stacks, fs, fb = _inputs(seed=2)
    seeds = [0] * (4 * N)

    def loss(xx, *ws):
        y = _jax_encoder(xx, mask, seeds, ws[:12], ws[12], ws[13])
        return jnp.sum(jnp.sin(y.astype(jnp.float32))), y

    with pltpu.force_tpu_interpret_mode():
        (_, y), ref = jax.value_and_grad(
            loss, argnums=tuple(range(15)), has_aux=True)(
            jnp.asarray(x, jdt), *map(jnp.asarray, stacks + [fs, fb]))
    dy = np.cos(np.asarray(y.astype(jnp.float32)))
    got = encoder_backward_plain(
        torch.tensor(x).to(tdt), torch.tensor(mask), seeds, _t(stacks),
        *_t((fs, fb)), torch.tensor(dy).to(tdt), h=H)
    assert got[0].dtype == tdt and len(got) == 15
    for i, (g, r) in enumerate(zip(got, ref)):
        _close(g.float().numpy(), np.asarray(r.astype(jnp.float32)), dtype,
               f"gradient {i}")


@pytest.mark.parametrize("p", [0.0, 0.3])
def test_backward_plain_matches_autograd_of_the_plain_forward(p):
    x, dy, mask, stacks, fs, fb = _inputs(seed=3)
    seeds = list(range(11, 11 + 4 * N))
    leaves = [t.requires_grad_() for t in _t([x] + stacks + [fs, fb])]
    y = encoder_forward_plain(leaves[0], torch.tensor(mask), seeds,
                              leaves[1:13], leaves[13], leaves[14], h=H,
                              p_drop=p)
    ref = torch.autograd.grad(y, leaves, torch.tensor(dy))
    got = encoder_backward_plain(torch.tensor(x), torch.tensor(mask), seeds,
                                 _t(stacks), *_t((fs, fb)), torch.tensor(dy),
                                 h=H, p_drop=p)
    for i, (g, r) in enumerate(zip(got, ref)):
        _close(g.numpy(), r.numpy(), "float32", f"gradient {i}")


def test_dropout_masks_are_the_chained_sublayers():
    """At dropout 0.3, B10's plain forward and backward against the port's
    chained sublayers (their autograd Functions, the final LN in torch ops)
    on the same seeds: the masks are keyed on (seed, stream, element), so
    the output is the same bits and the gradients agree to fp32 rounding of
    the final LayerNorm's backward."""
    x, dy, mask, stacks, fs, fb = _inputs(seed=4)
    seeds = list(range(21, 21 + 4 * N))
    key_mask = torch.tensor(mask)
    leaves = [t.requires_grad_() for t in _t([x] + stacks + [fs, fb])]
    hid = leaves[0]
    for n in range(N):
        w = [s[n] for s in leaves[1:13]]
        hid = AttentionSublayer.apply(hid, key_mask, *w[:6], H, 0.3, 0.3,
                                      tuple(seeds[4 * n:4 * n + 2]))
        hid = FFNSublayer.apply(hid, *w[6:], 0.3, 0.3,
                                tuple(seeds[4 * n + 2:4 * n + 4]))
    chained = std_layer_norm(hid, leaves[13], leaves[14])
    ref = torch.autograd.grad(chained, leaves, torch.tensor(dy))
    args = (key_mask, seeds, _t(stacks), *_t((fs, fb)))
    y = encoder_forward_plain(torch.tensor(x), *args, h=H, p_drop=0.3)
    assert torch.equal(y, chained.detach())
    assert not torch.allclose(
        y, encoder_forward_plain(torch.tensor(x), *args, h=H))
    got = encoder_backward_plain(torch.tensor(x), *args, torch.tensor(dy),
                                 h=H, p_drop=0.3)
    for i, (g, r) in enumerate(zip(got, ref)):
        scale = float(r.abs().max())
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0,
                                   atol=1e-6 * max(scale, 1.0),
                                   err_msg=f"gradient {i}")


# ----------------------------------------------------------------------------
# the weights carried across, and the switch


def _jax_flat_weights(monkeypatch, params, tdef, x, mask):
    """The stacks the JAX package's dispatch hands its encoder kernel
    (``flat_weights`` inside ``_mega_encoder_runner``), caught by a spy in
    place of the kernel with the dispatch forced on (on one device, its
    unsharded form)."""
    from allrank_tpu.ops import autotune

    caught = {}

    def spy(x, key_mask, seeds, block_weights, final_scale, final_bias, *,
            h, p_drop=0.0):
        caught["w"] = tuple(block_weights) + (final_scale, final_bias)
        return jnp.zeros_like(x)

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    monkeypatch.setattr(JT, "MEGA_SUBLAYER_MIN_LEN", 0)
    monkeypatch.setitem(autotune.DEFAULTS, "fused_attention_min_groups", 0)
    monkeypatch.setattr(JT, "MEGA_ENCODER_ENABLED", True)
    monkeypatch.setattr(jax_encoder, "encoder_forward", spy)
    JT.transformer_apply(params, tdef, jnp.asarray(x), jnp.asarray(mask),
                         jnp.zeros(mask.shape, jnp.int32), train=False)
    return caught["w"]


def _transformer_pair(seed=0, dropout=0.0, n=N):
    jdef = JT.TransformerDef(N=n, d_model=D, d_ff=D_FF, h=H, dropout=dropout)
    params = jax.tree.map(np.asarray,
                          JT.transformer_init(jax.random.PRNGKey(seed), jdef))
    model = load_jax_params(
        T.Transformer(T.TransformerDef(N=n, d_model=D, d_ff=D_FF, h=H,
                                       dropout=dropout)), params)
    return jdef, params, model


def test_stacked_weights_are_the_jax_packages(monkeypatch):
    jdef, params, model = _transformer_pair(seed=5)
    x, _, mask, *_ = _inputs(seed=5)
    ref = _jax_flat_weights(monkeypatch, params, jdef, x, mask)
    stacks, fs, fb = stack_block_weights(model)
    got = tuple(stacks) + (fs, fb)
    assert len(ref) == len(got) == encoder_block.STACKED_PER_BLOCK + 2
    for i, (g, r) in enumerate(zip(got, ref)):
        assert tuple(g.shape) == tuple(r.shape), i
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(r),
                                      err_msg=f"stack {i}")


def test_switched_encoder_matches_the_jax_xla_path(monkeypatch):
    """At dropout 0, the port's encoder with the switch on (B10's plain
    version on the CPU) against the JAX package's transformer_apply on its
    XLA path: the output and the gradients of sum(sin(y))."""
    jdef, params, model = _transformer_pair(seed=6)
    x, _, mask, *_ = _inputs(seed=6)
    idx = np.zeros(mask.shape, np.int32)

    def loss(p, xx):
        y = JT.transformer_apply(p, jdef, xx, jnp.asarray(mask), idx,
                                 train=True, rng=None)
        return jnp.sum(jnp.sin(y)), y

    (_, ref_y), (ref_g, ref_dx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    monkeypatch.setattr(T, "MEGA_ENCODER_ENABLED", True)
    xx = torch.tensor(x).requires_grad_()
    y = model(xx, torch.tensor(mask), torch.tensor(idx).long(), train=True)
    torch.sin(y).sum().backward()
    _close(y.detach().numpy(), np.asarray(ref_y), "float32", "y")
    _close(xx.grad.numpy(), np.asarray(ref_dx), "float32", "dx")
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_g)[0]
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert len(flat_ref) == len(grads)
    for path, r in flat_ref:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        _close(grads[name].numpy(), np.asarray(r), "float32", name)


def _ltr_model(dropout, seed=0):
    mdef = make_model(tconfig.ModelConfig(
        fc_model=tconfig.FCConfig(sizes=[D], input_norm=True,
                                  activation="ReLU", dropout=0.0),
        transformer=tconfig.TransformerConfig(
            N=N, d_ff=D_FF, h=H, dropout=dropout,
            positional_encoding=tconfig.PositionalEncodingConfig(
                strategy="fixed", max_indices=L)),
        post_model=tconfig.PostModelConfig(d_output=1)), 10)
    return LTRModel(mdef, torch.Generator().manual_seed(seed), device="cpu")


def _ltr_batch(seed=7):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, L, 10).astype(np.float32)
    y = rng.randint(0, 5, (B, L)).astype(np.float32)
    for i, n in enumerate(LENGTHS):
        y[i, n:] = -1.0
    indices = np.tile(np.arange(L), (B, 1))
    return x, y, indices


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_switch_on_scores_and_steps_as_switch_off(monkeypatch, dropout):
    """LTRModel's forward in training form and one train step on the CPU,
    switch on against switch off: the same seeds from the same generator,
    the same function; the gradients differ only by the final LayerNorm's
    backward formula (B10's against autograd of the torch ops)."""
    from allrank_tpu_torch.losses import get_loss
    from allrank_tpu_torch.training import make_optimizer, make_train_step

    x, y, indices = _ltr_batch()
    runs = []
    for on in (False, True):
        monkeypatch.setattr(T, "MEGA_ENCODER_ENABLED", on)
        model = _ltr_model(dropout)
        gen = torch.Generator().manual_seed(3)
        out = model(torch.tensor(x), torch.tensor(y) == -1.0,
                    torch.tensor(indices), train=True, generator=gen)
        loss_fn, needs_rng = get_loss("lambdaLoss")
        step = make_train_step(
            model, loss_fn, {"weighing_scheme": "ndcgLoss2PP_scheme"},
            needs_rng, make_optimizer("SGD", {"lr": 0.0}, model.parameters()),
            None, "float32", generator=torch.Generator().manual_seed(4))
        loss, _ = step(x, y, indices)
        runs.append((out.detach(), loss.item(),
                     {n: p.grad.clone() for n, p in model.named_parameters()}))
    (out0, loss0, g0), (out1, loss1, g1) = runs
    assert torch.equal(out0, out1)
    assert loss1 == pytest.approx(loss0, rel=1e-6)
    for name in g0:
        _close(g1[name].numpy(), g0[name].numpy(), "float32", name)


@pytest.mark.parametrize("on,shape,calls", [
    (True, dict(), 1),
    (False, dict(), 0),
    (True, dict(l=1025), 0),
    (True, dict(d=288, h=3), 0),
    (True, dict(d_ff=2048), 0),
    (True, dict(d=18, h=3), 0),
], ids=["on", "off", "L1025", "d288", "dff2048", "d_k6"])
def test_switch_dispatches_b10_inside_its_envelope(monkeypatch, on, shape,
                                                   calls):
    """A spy counts the encoder's calls of B10 per forward: one with the
    switch on inside the envelope, none with it off, none outside (L=1025,
    d=288, d_ff=2048, a head of 6 fp32 columns, off whole 16-byte rows),
    where the chained forms run."""
    d, h, l = shape.get("d", D), shape.get("h", H), shape.get("l", 8)
    d_ff = shape.get("d_ff", D_FF)
    model = T.Transformer(T.TransformerDef(N=1, d_model=d, d_ff=d_ff, h=h,
                                           dropout=0.0),
                          torch.Generator().manual_seed(0))
    seen = []

    def spy(*args, **kwargs):
        seen.append(args[0].shape)
        return encoder_block.encoder_forward(*args, **kwargs)

    monkeypatch.setattr(T, "MEGA_ENCODER_ENABLED", on)
    monkeypatch.setattr(T, "encoder_forward", spy)
    x = torch.randn(2, l, d)
    mask = torch.arange(l)[None, :] >= torch.tensor([l, 3])[:, None]
    with torch.no_grad():
        y = model(x, mask, torch.zeros(2, l, dtype=torch.long))
    assert len(seen) == calls and y.shape == (2, l, d)
    assert torch.isfinite(y).all()


# ----------------------------------------------------------------------------
# the forward's parked state, the routes and the split counts


def _chained_grads(x, mask, seeds, stacks, fs, fb, dy, p, tdt):
    """The chained plain sublayers' autograd Functions and the final LN in
    torch ops, at dropout p in dtype tdt: the gradients of (x, the 12
    stacks, the final LN pair) for the cotangent dy."""
    key_mask = torch.tensor(mask)
    leaves = [t.requires_grad_() for t in [torch.tensor(x).to(tdt)]
              + _t(stacks + [fs, fb])]
    hid = leaves[0]
    for n in range(N):
        w = [s[n] for s in leaves[1:13]]
        hid = AttentionSublayer.apply(hid, key_mask, *w[:6], H, p, p,
                                      tuple(seeds[4 * n:4 * n + 2]))
        hid = FFNSublayer.apply(hid, *w[6:], p, p,
                                tuple(seeds[4 * n + 2:4 * n + 4]))
    y = std_layer_norm(hid, leaves[13], leaves[14])
    return torch.autograd.grad(y, leaves, torch.tensor(dy).to(tdt))


@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_parked_backward_is_the_replaying_one(dtype, p):
    """The backward on the forward's parked sublayer inputs against the
    backward that replays the forward: the same bits. Both against the
    gradients of the JAX package's encoder (p = 0; at p = 0.3 its masks are
    the TPU's generator's, so the reference is the port's chained
    sublayers, whose masks B10 keys alike) under the file's rule, at the
    file's lengths (full, ragged, one document, fully padded)."""
    jdt, tdt = DTYPES[dtype]
    x, dy, mask, stacks, fs, fb = _inputs(seed=8)
    seeds = list(range(31, 31 + 4 * N)) if p else [0] * (4 * N)
    args = (torch.tensor(x).to(tdt), torch.tensor(mask), seeds, _t(stacks),
            *_t((fs, fb)))
    y, saved = encoder_forward_plain(*args, h=H, p_drop=p, return_saved=True)
    assert torch.equal(y, encoder_forward_plain(*args, h=H, p_drop=p))
    assert len(saved) == 2 * N + 1 and saved[0] is args[0]
    if p:
        ref = _chained_grads(x, mask, seeds, stacks, fs, fb, dy, p, tdt)
        cot = torch.tensor(dy).to(tdt)
    else:
        def loss(xx, *ws):
            yy = _jax_encoder(xx, mask, seeds, ws[:12], ws[12], ws[13])
            return jnp.sum(jnp.sin(yy.astype(jnp.float32))), yy

        with pltpu.force_tpu_interpret_mode():
            (_, jy), ref = jax.value_and_grad(
                loss, argnums=tuple(range(15)), has_aux=True)(
                jnp.asarray(x, jdt), *map(jnp.asarray, stacks + [fs, fb]))
        cot = torch.tensor(np.cos(np.asarray(jy.astype(jnp.float32)))).to(tdt)
    parked = encoder_backward_plain(*args, cot, h=H, p_drop=p, saved=saved)
    replayed = encoder_backward_plain(*args, cot, h=H, p_drop=p)
    assert len(parked) == len(replayed) == 15
    for i, (a, b, r) in enumerate(zip(parked, replayed, ref)):
        assert torch.equal(a, b), f"gradient {i}: parked != replayed"
        r = r.float().numpy() if torch.is_tensor(r) else np.asarray(
            r.astype(jnp.float32))
        _close(a.float().numpy(), r, dtype, f"gradient {i}")


# (d, h) pairs of the envelope: d_k below, at and above 128, d off the
# 16-column steps
ROUTE_WIDTHS = [(8, 1), (8, 2), (32, 1), (32, 4), (128, 1), (128, 4),
                (144, 1), (144, 2), (256, 1), (256, 2), (256, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h", ROUTE_WIDTHS)
def test_route_is_the_chained_routes(d, h, dtype):
    from allrank_tpu_torch.ops import attention_block, ffn_block

    for d_ff in (64, 512, 1024):
        got = encoder_block.route(dtype, d, h, d_ff)
        assert got == (attention_block.route(dtype, d, h),
                       ffn_block.route(dtype, d, d_ff))
        assert "/".join(got) in encoder_block.ROUTES
        assert (got[0] == "simt") == (d // h > 128)


@pytest.mark.parametrize("dtype,d,h,d_ff", [
    (torch.float16, 128, 4, 512), (torch.float32, 288, 3, 512),
    (torch.bfloat16, 130, 4, 512), (torch.float32, 128, 4, 2048)],
    ids=["float16", "d288", "d_mod_h", "dff2048"])
def test_route_raises_where_the_envelope_does(dtype, d, h, d_ff):
    with pytest.raises(NotImplementedError):
        encoder_block.check_envelope(2, 8, d, d_ff, 1, dtype, h)
    with pytest.raises(NotImplementedError):
        encoder_block.route(dtype, d, h, d_ff)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_each_head_class_has_its_source(dtype):
    """``library`` names a source of the repo for each head class: padded
    d_k 32, 64, 128 and wider heads."""
    import os

    from allrank_tpu_torch.ops import _build

    names = {encoder_block.library(dtype, 256, h) for h in (8, 4, 2, 1)}
    assert len(names) == 4
    for name in names:
        assert os.path.exists(_build.source_path(name)), name


def _chained_split_counts(monkeypatch, dtype, b, l, d, h, d_ff):
    """The split counts B1's and B2's backward wrappers hand their kernels
    at these shapes on the routes the encoder takes, caught by a stand-in
    library on the CPU: (s_qkv, s_out, s_1, s_2)."""
    import contextlib

    from allrank_tpu_torch.ops import _build, attention_block, ffn_block

    calls = {}

    class Library:
        def __getattr__(self, name):
            def launch(*args):
                calls[name] = [a for a in args if type(a) is int]
                return 0
            return launch

    monkeypatch.setattr(_build, "load", lambda *args: Library())
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    way_a, way_f = encoder_block.route(dtype, d, h, d_ff)
    x, dy = torch.zeros(b, l, d, dtype=dtype), torch.zeros(b, l, d,
                                                             dtype=dtype)
    vec, mat = torch.zeros(d), torch.zeros(d, d)
    attention_block.launch_bwd(
        way_a, x, torch.zeros(b, l, dtype=torch.bool), vec, vec,
        torch.zeros(d, 3 * d), torch.zeros(3 * d), mat, vec, dy, h,
        saved=(torch.zeros(b, l, 3 * d, dtype=dtype),
               torch.zeros(b, h, l, 2)))
    ffn_block.launch_bwd(way_f, x, vec, vec, torch.zeros(d, d_ff),
                         torch.zeros(d_ff), torch.zeros(d_ff, d), vec, dy)
    (attn,) = [v for k, v in calls.items() if k.startswith("attention")]
    (ffn,) = [v for k, v in calls.items() if k.startswith("ffn")]
    return attn[4], attn[5], ffn[3], ffn[4]


@pytest.mark.parametrize("dtype,b,l,d,h,d_ff", [
    (torch.float32, 64, 240, 128, 4, 512), (torch.bfloat16, 64, 240, 128, 4,
                                            512),
    (torch.float32, 4, 70, 256, 1, 1024), (torch.bfloat16, 4, 70, 256, 1,
                                           1024),
    (torch.float32, 8, 240, 144, 2, 384)],
    ids=["flagship-fp32", "flagship-bf16", "simt-fp32", "simt-bf16",
         "d144-fp32"])
def test_split_counts_are_the_chained_routes(monkeypatch, dtype, b, l, d, h,
                                             d_ff):
    got = encoder_block.split_counts(dtype, b * l, d, h, d_ff)
    assert got == _chained_split_counts(monkeypatch, dtype, b, l, d, h, d_ff)


def test_whole_encoder_backward_reads_the_parked_state(monkeypatch):
    """WholeEncoder on the CPU: the forward runs the blocks once and hands
    its sublayer inputs to the backward, which runs no block forward again
    and gives the replaying backward's bits."""
    x, dy, mask, stacks, fs, fb = _inputs(seed=9)
    seeds = list(range(41, 41 + 4 * N))
    runs = []
    blocks = encoder_block._blocks_plain

    def counted(*args):
        runs.append(args[0].shape)
        return blocks(*args)

    monkeypatch.setattr(encoder_block, "_blocks_plain", counted)
    leaves = [t.requires_grad_() for t in _t([x] + stacks + [fs, fb])]
    y = encoder_block.encoder_forward(leaves[0], torch.tensor(mask), seeds,
                                      leaves[1:13], leaves[13], leaves[14],
                                      h=H, p_drop=0.3)
    assert len(runs) == 1
    got = torch.autograd.grad(y, leaves, torch.tensor(dy))
    assert len(runs) == 1, "the backward replayed the forward"
    ref = encoder_backward_plain(torch.tensor(x), torch.tensor(mask), seeds,
                                 _t(stacks), *_t((fs, fb)), torch.tensor(dy),
                                 h=H, p_drop=0.3)
    assert len(runs) == 2
    for i, (g, r) in enumerate(zip(got, ref)):
        assert torch.equal(g, r), f"gradient {i}"


# ----------------------------------------------------------------------------
# the timing tool's yardsticks


def test_the_library_yardstick_computes_b10s_function():
    """The library chain ``time_sublayers --encoder`` times beside B10
    (per block std-LN, matmul, SDPA, relu; the final std-LN) is B10's
    function: at dropout 0 in fp32 it agrees with the plain version on
    slates with a valid document, and its backward with the plain
    backward."""
    from allrank_tpu_torch.tools.time_sublayers import encoder_library

    x, dy, mask, stacks, fs, fb = _inputs(seed=10, lengths=(L, 9, 1, 3))
    args = (torch.tensor(x), torch.tensor(mask))
    ws = (_t(stacks), *_t((fs, fb)))
    fwd, bwd = encoder_library(*args, *ws, torch.tensor(dy), H)
    seeds = [0] * (4 * N)
    torch.testing.assert_close(
        fwd(), encoder_forward_plain(args[0], args[1], seeds, *ws, h=H),
        rtol=1e-4, atol=1e-5)
    ref = encoder_backward_plain(args[0], args[1], seeds, *ws,
                                 torch.tensor(dy), h=H)
    for i, (g, r) in enumerate(zip(bwd(), ref)):
        _close(g.numpy(), r.numpy(), "float32", f"gradient {i}")


def test_time_sublayers_encoder_measures_nothing_without_a_card(monkeypatch,
                                                                 capsys):
    from allrank_tpu_torch.tools import time_sublayers

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert time_sublayers.main(["--encoder"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    flops = (time_sublayers.encoder_flops(False),
             time_sublayers.encoder_flops(True))
    assert [round(f / 1e9, 2) for f in flops] == [31.71, 79.02]
