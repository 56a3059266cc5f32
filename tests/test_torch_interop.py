"""The port's bridge to reference checkpoints (allrank_tpu_torch/interop.py)
against the JAX package's (allrank_tpu/interop.py) on the CPU: the same
params tree from a reference-layout state_dict, the same state_dict back,
the same errors, and both CLIs' files."""

import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import allrank_tpu.config as jconfig
from allrank_tpu import interop as jinterop
from allrank_tpu.models import factory as jfactory
from allrank_tpu.training.checkpoint import load_params
from allrank_tpu_torch import config as tconfig
from allrank_tpu_torch.interop import (
    export_params,
    flatten_params,
    load_jax_params,
    load_npz,
    load_torch_state_dict,
    params_to_torch_state_dict,
    torch_state_dict_to_params,
)
from allrank_tpu_torch.models.factory import LTRModel, make_model

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAPER_CONFIG = "reproducibility/configs/contextaware_web30k/ndcgloss2pp.json"
N_FEATURES = 24
# the JAX test's configurations (tests/test_interop.py)
CASES = [("fixed", 1, None), ("learned", 1, None), ("fixed", 4, "Sigmoid"),
         (None, 1, None)]
CASE_IDS = ["fixed", "learned", "d_output4-sigmoid", "no-pe"]


def _model_config(cfg, pe="fixed", d_output=1, act=None):
    return cfg.ModelConfig(
        fc_model=cfg.FCConfig(sizes=[32], input_norm=True, activation="ReLU",
                              dropout=0.0),
        transformer=cfg.TransformerConfig(
            N=2, d_ff=48, h=2, dropout=0.0,
            positional_encoding=(cfg.PositionalEncodingConfig(
                strategy=pe, max_indices=40) if pe else None)),
        post_model=cfg.PostModelConfig(d_output=d_output,
                                       output_activation=act),
    )


def _mdefs(case):
    return (jfactory.make_model(_model_config(jconfig, *case), N_FEATURES),
            make_model(_model_config(tconfig, *case), N_FEATURES))


def _fixed_pe_table(d, max_len):
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32)
                 * np.float32(-math.log(10000.0) / d))
    pe = np.zeros((max_len + 1, d), dtype=np.float32)
    pe[:max_len, 0::2] = np.sin(pos * div)
    pe[:max_len, 1::2] = np.cos(pos * div)
    return pe


def _ref_state_dict(mdef, seed=0):
    """Seeded tensors in the reference LTRModel's state_dict layout."""
    rng = np.random.RandomState(seed)

    def t(*shape):
        return torch.from_numpy((0.2 * rng.randn(*shape)).astype(np.float32))

    sd = {}
    dims = (mdef.fc.n_features,) + tuple(mdef.fc.sizes)
    sd["input_layer.input_norm.weight"] = 1.0 + 0.1 * t(dims[0])
    sd["input_layer.input_norm.bias"] = t(dims[0])
    for i in range(len(mdef.fc.sizes)):
        sd[f"input_layer.layers.{i}.weight"] = t(dims[i + 1], dims[i])
        sd[f"input_layer.layers.{i}.bias"] = t(dims[i + 1])
    tdef = mdef.transformer
    d = tdef.d_model
    for i in range(tdef.N):
        for j in range(4):
            sd[f"encoder.layers.{i}.self_attn.linears.{j}.weight"] = t(d, d)
            sd[f"encoder.layers.{i}.self_attn.linears.{j}.bias"] = t(d)
        sd[f"encoder.layers.{i}.feed_forward.w_1.weight"] = t(tdef.d_ff, d)
        sd[f"encoder.layers.{i}.feed_forward.w_1.bias"] = t(tdef.d_ff)
        sd[f"encoder.layers.{i}.feed_forward.w_2.weight"] = t(d, tdef.d_ff)
        sd[f"encoder.layers.{i}.feed_forward.w_2.bias"] = t(d)
        for s in (0, 1):
            sd[f"encoder.layers.{i}.sublayer.{s}.norm.a_2"] = 1.0 + 0.1 * t(d)
            sd[f"encoder.layers.{i}.sublayer.{s}.norm.b_2"] = t(d)
    sd["encoder.norm.a_2"] = 1.0 + 0.1 * t(d)
    sd["encoder.norm.b_2"] = t(d)
    if tdef.positional_encoding == "fixed":
        sd["encoder.position.pe"] = torch.from_numpy(
            _fixed_pe_table(d, tdef.max_indices))
    elif tdef.positional_encoding == "learned":
        sd["encoder.position.pe.weight"] = t(tdef.max_indices + 1, d)
    sd["output_layer.w_1.weight"] = t(mdef.output.d_output, d)
    sd["output_layer.w_1.bias"] = t(mdef.output.d_output)
    return sd


def _assert_same_leaves(got, want):
    got, want = flatten_params(got), flatten_params(want)
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def _batch(bsz=3, L=17, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(bsz, L, N_FEATURES).astype(np.float32)
    lengths = np.array([L, 12, 6])
    mask = np.arange(L)[None, :] >= lengths[:, None]
    indices = np.tile(np.arange(L, dtype=np.int32), (bsz, 1))
    indices[mask] = -1
    return x, mask, indices


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_state_dict_to_params_is_jax_bit_for_bit_and_scores_match(case):
    jdef, tdef = _mdefs(case)
    sd = _ref_state_dict(tdef)
    params = torch_state_dict_to_params(sd, tdef)
    _assert_same_leaves(params, jinterop.torch_state_dict_to_params(sd, jdef))
    model = load_jax_params(LTRModel(tdef, device="cpu"), params)
    x, mask, indices = _batch()
    want = np.asarray(jfactory.score(params, jdef, x, mask, indices))
    with torch.no_grad():
        got = model.score(torch.from_numpy(x), torch.from_numpy(mask),
                          torch.from_numpy(indices).long()).numpy()
    np.testing.assert_allclose(got[~mask], want[~mask], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_params_to_state_dict_is_jax_bit_for_bit(case):
    jdef, tdef = _mdefs(case)
    sd = _ref_state_dict(tdef, seed=3)
    params = jinterop.torch_state_dict_to_params(sd, jdef)
    want = jinterop.params_to_torch_state_dict(params, jdef)
    model = load_jax_params(LTRModel(tdef, device="cpu"), params)
    # the tree, and the flat form of flatten_params and export_params
    for given in (params, flatten_params(params), export_params(model)):
        got = params_to_torch_state_dict(given, tdef)
        assert list(got) == list(want)
        for key, value in want.items():
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
    # and back: the reference layout round-trips exactly
    for key, value in sd.items():
        np.testing.assert_array_equal(want[key], value.numpy(), err_msg=key)


def test_module_prefix_is_stripped():
    jdef, tdef = _mdefs(CASES[0])
    sd = _ref_state_dict(tdef)
    wrapped = {f"module.{k}": v for k, v in sd.items()}
    _assert_same_leaves(torch_state_dict_to_params(wrapped, tdef),
                        jinterop.torch_state_dict_to_params(sd, jdef))


def _edits(sd):
    missing = dict(sd)
    del missing["encoder.norm.a_2"]
    extra = dict(sd, **{"encoder.layers.9.bogus": torch.zeros(3)})
    wrong = dict(sd, **{"output_layer.w_1.weight": torch.zeros(7, 7)})
    norm = dict(sd, **{"encoder.norm.a_2": torch.zeros(5)})
    table = dict(sd, **{"encoder.position.pe": torch.zeros(3, 32)})
    return {"missing": missing, "extra": extra, "linear": wrong,
            "norm": norm, "table": table}


@pytest.mark.parametrize("edit", ["missing", "extra", "linear", "norm",
                                  "table"])
def test_mismatched_checkpoints_raise_as_in_jax(edit):
    jdef, tdef = _mdefs(CASES[0])
    bad = _edits(_ref_state_dict(tdef))[edit]
    with pytest.raises((KeyError, ValueError)) as want:
        jinterop.torch_state_dict_to_params(bad, jdef)
    with pytest.raises(want.type) as got:
        torch_state_dict_to_params(bad, tdef)
    assert str(got.value) == str(want.value)


def test_load_torch_state_dict_reads_tensors_only(tmp_path):
    _, tdef = _mdefs(CASES[0])
    sd = _ref_state_dict(tdef)
    torch.save(sd, str(tmp_path / "model.pkl"))
    got = load_torch_state_dict(str(tmp_path / "model.pkl"))
    want = jinterop.load_torch_state_dict(str(tmp_path / "model.pkl"))
    assert list(got) == list(want) == list(sd)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    # a pickle that is not tensors is refused
    torch.save({"a": object()}, str(tmp_path / "code.pkl"))
    with pytest.raises(Exception, match="(?i)weights_only|unsupported"):
        load_torch_state_dict(str(tmp_path / "code.pkl"))


def _write_config(tmp_path, case):
    """A paper config (both packages parse the whole file) with the test's
    model."""
    pe, d_output, act = case
    with open(os.path.join(REPO, PAPER_CONFIG)) as f:
        cfg = json.load(f)
    cfg["model"] = {
        "fc_model": {"sizes": [32], "input_norm": True, "activation": "ReLU",
                     "dropout": 0.0},
        "transformer": {"N": 2, "d_ff": 48, "h": 2, "dropout": 0.0,
                        "positional_encoding": (
                            {"strategy": pe, "max_indices": 40} if pe
                            else None)},
        "post_model": {"d_output": d_output, "output_activation": act}}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _cli(args, module):
    """The port's CLI in a subprocess (as a user runs it), or the JAX
    package's in this process (its subprocess would import JAX anew)."""
    if module == "jax":
        argv = sys.argv
        sys.argv = ["allrank_tpu.interop", *args]
        try:
            jinterop.run()
        finally:
            sys.argv = argv
        return
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "allrank_tpu_torch.interop", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO,
        timeout=120)
    assert out.returncode == 0, out.stdout.decode()


@pytest.mark.parametrize("case", [CASES[0], CASES[2]],
                         ids=[CASE_IDS[0], CASE_IDS[2]])
def test_cli_both_ways_writes_what_the_jax_cli_writes(tmp_path, case):
    jdef, tdef = _mdefs(case)
    cfg = _write_config(tmp_path, case)
    sd = _ref_state_dict(tdef, seed=7)
    torch.save(sd, str(tmp_path / "model.pkl"))
    common = ["--config-file-name", cfg, "--n-features", str(N_FEATURES)]
    for who in ("port", "jax"):
        _cli(common + ["--input-model-path", str(tmp_path / "model.pkl"),
                       "--output-model-path", str(tmp_path / f"{who}.npz")],
             who)
    # the port's model.npz is what the JAX package's load_params reads, and
    # holds the JAX CLI's arrays bit for bit
    template = jfactory.init_params(jax.random.PRNGKey(0), jdef)
    ours = load_params(template, str(tmp_path / "port.npz"))
    theirs = load_params(template, str(tmp_path / "jax.npz"))
    _assert_same_leaves(jax.tree.map(np.asarray, ours),
                        jax.tree.map(np.asarray, theirs))
    with np.load(str(tmp_path / "port.npz")) as a, \
            np.load(str(tmp_path / "jax.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
    # export: both CLIs from the same model.npz
    for who in ("port", "jax"):
        _cli(common + ["--direction", "export",
                       "--input-model-path", str(tmp_path / "jax.npz"),
                       "--output-model-path", str(tmp_path / f"{who}.pkl")],
             who)
    ours = torch.load(str(tmp_path / "port.pkl"), weights_only=True)
    theirs = torch.load(str(tmp_path / "jax.pkl"), weights_only=True)
    assert list(ours) == list(theirs) == list(sd)
    for key, value in theirs.items():
        assert ours[key].dtype == value.dtype, key
        assert torch.equal(ours[key], value), key
        assert torch.equal(value, sd[key]), key
    # and the port's own loader takes the port's model.npz
    model = load_npz(LTRModel(tdef, device="cpu"), str(tmp_path / "port.npz"))
    _assert_same_leaves(export_params(model),
                        flatten_params(torch_state_dict_to_params(sd, tdef)))

