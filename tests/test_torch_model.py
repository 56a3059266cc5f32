"""The port's whole scoring model (allrank_tpu_torch/models) against the
JAX package's ``factory.score``, with the JAX weights carried across by
``interop`` (and through a ``model.npz`` written by the JAX package)."""

import jax
import numpy as np
import pytest
import torch

import allrank_tpu.config as jconfig
from __graft_entry__ import _flagship_mdef
from allrank_tpu.models import factory as jfactory
from allrank_tpu.training.checkpoint import save_params
from allrank_tpu_torch import config as tconfig
from allrank_tpu_torch.interop import load_jax_params, load_npz
from allrank_tpu_torch.models.factory import LTRModel, make_model

torch.set_num_threads(2)


def _model_config(cfg, d_ff=32, h=2, pe="fixed", d_output=1, act=None,
                  sizes=(16,)):
    return cfg.ModelConfig(
        fc_model=cfg.FCConfig(sizes=list(sizes), input_norm=True,
                              activation="ReLU", dropout=0.0),
        transformer=cfg.TransformerConfig(
            N=2, d_ff=d_ff, h=h, dropout=0.0,
            positional_encoding=(cfg.PositionalEncodingConfig(
                strategy=pe, max_indices=20) if pe else None)),
        post_model=cfg.PostModelConfig(d_output=d_output,
                                       output_activation=act),
    )


def _pair(n_features, seed=0, **kw):
    """The same architecture in both packages; the JAX weights (as numpy)
    carried into the port."""
    jdef = jfactory.make_model(_model_config(jconfig, **kw), n_features)
    tdef = make_model(_model_config(tconfig, **kw), n_features)
    params = jax.tree.map(np.asarray,
                          jfactory.init_params(jax.random.PRNGKey(seed), jdef))
    model = load_jax_params(LTRModel(tdef, device="cpu"), params)
    return jdef, params, model


def _batch(b, l, f, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, l, f).astype(np.float32)
    lengths = rng.randint(1, l + 1, size=b)
    lengths[-1] = 0  # a fully padded slate
    mask = np.arange(l)[None, :] >= lengths[:, None]
    indices = np.tile(np.arange(l), (b, 1)).astype(np.int32)
    return x, mask, indices


def _scores(model, x, mask, indices, dtype):
    with torch.inference_mode():
        return model.score(torch.tensor(x), torch.tensor(mask),
                           torch.tensor(indices).long(),
                           compute_dtype=dtype).float().numpy()


@pytest.mark.parametrize("kw", [
    dict(),
    dict(pe="learned", d_output=3, act="Sigmoid"),
    dict(pe=None, h=3, sizes=(12,)),  # d_k 4 with no positional encoding
], ids=["fixed-pe", "learned-pe-ordinal-head", "no-pe-3-heads"])
def test_score_matches_jax_fp32(kw):
    jdef, params, model = _pair(10, **kw)
    x, mask, indices = _batch(4, 9, 10)
    ref = np.asarray(jfactory.score(params, jdef, x, mask, indices))
    got = _scores(model, x, mask, indices, "float32")
    assert got.shape == ref.shape and np.isfinite(got).all()
    # fp32 through 2 blocks, summed in another order
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_score_bf16_tracks_jax_bf16():
    jdef, params, model = _pair(10)
    x, mask, indices = _batch(4, 9, 10, seed=2)
    ref = np.asarray(jfactory.score(params, jdef, x, mask, indices,
                                    compute_dtype=jax.numpy.bfloat16))
    got = _scores(model, x, mask, indices, "bfloat16")
    # bf16 (8-bit mantissa) rounded at different points in the two packages
    # (the port at the TPU kernels' points, JAX's CPU path at XLA's),
    # through 2 blocks: a few percent of the score scale
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 0.05 * scale + 0.02


def test_flagship_width_matches_jax():
    """The flagship model at its full width (136 features, d=128, h=4,
    d_ff=512, 4 blocks) at a tiny batch and slate."""
    jdef = _flagship_mdef()
    tdef = make_model(tconfig.ModelConfig(
        fc_model=tconfig.FCConfig(sizes=[128], input_norm=True,
                                  activation="ReLU", dropout=0.0),
        transformer=tconfig.TransformerConfig(
            N=4, d_ff=512, h=4, dropout=0.0,
            positional_encoding=tconfig.PositionalEncodingConfig(
                strategy="fixed", max_indices=256)),
        post_model=tconfig.PostModelConfig(d_output=1)), 136)
    params = jax.tree.map(np.asarray,
                          jfactory.init_params(jax.random.PRNGKey(3), jdef))
    model = load_jax_params(LTRModel(tdef, device="cpu"), params)
    x, mask, indices = _batch(2, 6, 136, seed=3)
    ref = np.asarray(jfactory.score(params, jdef, x, mask, indices))
    got = _scores(model, x, mask, indices, "float32")
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_npz_from_jax_save_params_loads(tmp_path):
    jdef, params, model = _pair(10, seed=4)
    path = str(tmp_path / "model.npz")
    save_params(params, path)
    fresh = make_model(_model_config(tconfig), 10)
    loaded = load_npz(LTRModel(fresh, torch.Generator().manual_seed(9),
                               device="cpu"), path)
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              loaded.state_dict().items()):
        assert torch.equal(a, b), k


def test_interop_is_strict():
    jdef, params, model = _pair(10)
    missing = dict(params)
    missing.pop("output")
    with pytest.raises(KeyError, match="output"):
        load_jax_params(model, missing)
    extra = dict(params, spare={"w": np.zeros(3)})
    with pytest.raises(KeyError, match="spare"):
        load_jax_params(model, extra)
    bad = jax.tree.map(lambda a: a, params)
    bad["output"] = {"w": np.zeros((3, 1), np.float32),
                     "b": params["output"]["b"]}
    with pytest.raises(ValueError, match="output|w"):
        load_jax_params(model, bad)


def test_parameter_names_are_the_jax_tree_paths():
    jdef, params, model = _pair(10)
    from allrank_tpu_torch.interop import flatten_params

    assert sorted(k.replace(".", "|") for k in model.state_dict()) == \
        sorted(flatten_params(params))
    assert tuple(model.transformer.layers[0].qkv.w.shape) == (16, 48)


def test_encoder_raises_outside_the_kernel_envelope_on_cuda():
    """The envelope is checked before any launch (CPU tensors run the plain
    versions at any size, so the check is called directly here)."""
    from allrank_tpu_torch.ops.attention_block import check_envelope

    with pytest.raises(NotImplementedError, match="d_model <= 256"):
        check_envelope(2, 8, 288, torch.float32, 4)
    with pytest.raises(NotImplementedError, match="L <= 1024"):
        check_envelope(2, 1025, 128, torch.float32, 4)
    with pytest.raises(NotImplementedError, match="float16"):
        check_envelope(2, 8, 128, torch.float16, 4)
    check_envelope(64, 240, 144, torch.bfloat16, 2)  # d_k 72: inside
