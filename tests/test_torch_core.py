"""The port's primitives (allrank_tpu_torch/models/core.py, positional.py,
config.py), its device rule and its import isolation, against the JAX
package where there is a counterpart."""

import ast
import glob
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allrank_tpu.config import Config as JaxConfig
from allrank_tpu.models import core as jcore
from allrank_tpu.models import positional as jpos
from allrank_tpu_torch.config import Config
from allrank_tpu_torch.models import core, positional
from allrank_tpu_torch.utils.device import resolve_device

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32 elementwise and row-reduction math summed in another order
F32 = dict(rtol=1e-5, atol=1e-6)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ln_params(d, seed=1):
    rng = np.random.RandomState(seed)
    return ((1 + 0.1 * rng.randn(d)).astype(np.float32),
            (0.1 * rng.randn(d)).astype(np.float32))


def test_std_layer_norm_matches_jax_with_zero_row():
    x = _x(4, 6, 10)
    x[1, 2] = 0.0  # an all-zero row: variance 0, the 1e-24 floor applies
    g, b = _ln_params(10)
    ref = jcore.std_layer_norm_apply({"scale": jnp.asarray(g),
                                      "bias": jnp.asarray(b)}, jnp.asarray(x))
    got = core.std_layer_norm(torch.tensor(x), torch.tensor(g),
                              torch.tensor(b))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)
    np.testing.assert_allclose(got[1, 2].numpy(), b, **F32)


def test_layer_norm_has_torch_semantics():
    x = _x(3, 5, 7, seed=2)
    g, b = _ln_params(7, seed=3)
    ref = jcore.layer_norm_apply({"scale": jnp.asarray(g),
                                  "bias": jnp.asarray(b)}, jnp.asarray(x))
    got = core.layer_norm(torch.tensor(x), torch.tensor(g), torch.tensor(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)
    ln = torch.nn.LayerNorm(7)
    with torch.no_grad():
        ln.weight.copy_(torch.tensor(g))
        ln.bias.copy_(torch.tensor(b))
        np.testing.assert_allclose(got.numpy(), ln(torch.tensor(x)).numpy(),
                                   **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_matches_jax(dtype):
    x, w = _x(2, 4, 6, seed=4), _x(6, 3, seed=5)
    b = _x(3, seed=6)
    ref = jcore.dense_apply({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                            jnp.asarray(x, getattr(jnp, dtype)))
    got = core.dense(torch.tensor(x).to(getattr(torch, dtype)),
                     torch.tensor(w), torch.tensor(b))
    assert got.dtype == getattr(torch, dtype)
    # bf16: both products round their output to bf16 once, the bias add
    # rounds again; a flip at either moves a value by one bf16 ulp
    tol = F32 if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("name", sorted(core.ACTIVATIONS))
def test_activations_match_jax(name):
    x = _x(64, seed=7) * 4
    ref = jcore.get_activation(name)(jnp.asarray(x))
    got = core.get_activation(name)(torch.tensor(x))
    # transcendental functions of two libraries: a few fp32 ulps
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=2e-6, atol=2e-6)


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="Unknown activation"):
        core.get_activation("Swishy")


def test_xavier_uniform_is_seeded_and_bounded():
    a = core.xavier_uniform((30, 50), torch.Generator().manual_seed(3))
    b = core.xavier_uniform((30, 50), torch.Generator().manual_seed(3))
    limit = np.sqrt(6.0 / 80)
    assert torch.equal(a, b)
    assert a.abs().max() <= limit and a.abs().max() > 0.9 * limit


def test_fixed_table_is_the_jax_table():
    np.testing.assert_array_equal(positional.fixed_positional_table(10, 7),
                                  jpos.fixed_positional_table(10, 7))


@pytest.mark.parametrize("kind", ["fixed", "learned"])
def test_positional_encoding_matches_jax_with_padded_indices(kind):
    d, max_len = 8, 6
    x = _x(2, 5, d, seed=8)
    mask = np.array([[False] * 5, [False, False, True, True, True]])
    # ranks past max_len clamp to the zero row; padded docs go there too
    indices = np.array([[0, 3, 5, 6, 9], [1, 2, 0, 4, 4]], dtype=np.int32)
    if kind == "fixed":
        module = positional.FixedPositionalEncoding(d, max_len)
        params = {"table": jnp.asarray(module.table.numpy())}
        apply = jpos.fixed_pe_apply
    else:
        module = positional.LearnedPositionalEncoding(
            d, max_len, torch.Generator().manual_seed(0))
        assert not module.table[-1].any()  # the zero padding row
        params = {"table": jnp.asarray(module.table.detach().numpy())}
        apply = jpos.learned_pe_apply
    ref = apply(params, jnp.asarray(x), jnp.asarray(mask),
                jnp.asarray(indices))
    with torch.no_grad():
        got = module(torch.tensor(x), torch.tensor(mask),
                     torch.tensor(indices))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


def test_config_reads_model_and_slate_length():
    path = os.path.join(REPO, "reproducibility", "configs",
                        "contextaware_web30k", "ordinal.json")
    cfg, ref = Config.from_json(path), JaxConfig.from_json(path)
    assert json.dumps(vars(cfg.model), default=vars, sort_keys=True) == \
        json.dumps(vars(ref.model), default=vars, sort_keys=True)
    assert cfg.data.slate_length == ref.data.slate_length


def test_default_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    # the entry points default to the GPU and say so
    from allrank_tpu_torch.config import FCConfig, ModelConfig, PostModelConfig
    from allrank_tpu_torch.models.factory import LTRModel, make_model
    from allrank_tpu_torch.serve_http import SlateScoringService
    from allrank_tpu_torch.serving import make_ranker, make_scorer

    mdef = make_model(ModelConfig(
        fc_model=FCConfig(sizes=[4], input_norm=False, activation=None,
                          dropout=None),
        transformer=None, post_model=PostModelConfig(d_output=1)), 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LTRModel(mdef)
    model = LTRModel(mdef, device="cpu")
    for entry in (lambda: make_scorer(model), lambda: make_ranker(model),
                  lambda: SlateScoringService(model, 4, 3)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of allrank_tpu_torch, imported in a fresh process,
    leaves no ``jax`` and no ``allrank_tpu``/``allrank_tpu.*`` module
    loaded (the port's own name starts with ``allrank_tpu`` too)."""
    code = """
import importlib, pkgutil, sys
import allrank_tpu_torch
names = [m.name for m in pkgutil.walk_packages(allrank_tpu_torch.__path__,
                                               "allrank_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "allrank_tpu" or m.startswith("allrank_tpu."))
print(len(names), bad)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 25 and bad == "[]", out.stdout


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_of_the_port_names_jax_or_the_jax_package():
    """Lazy imports inside functions too: no ``import jax`` and no import of
    ``allrank_tpu`` as a whole module name in the port or chip_smoke.py."""
    paths = glob.glob(os.path.join(REPO, "allrank_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    for path in paths:
        for name in _imported_roots(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "allrank_tpu"), (path, name)
