"""Weights carried across from the JAX package and from the reference.

The JAX package keeps parameters as a pytree of arrays and saves it as an
npz keyed by tree path joined with ``|`` (``transformer|layers|0|qkv|w``).
``LTRModel`` names its parameters and buffers the same way with ``.``, and
keeps the JAX layouts (dense ``w`` is ``[d_in, d_out]``; the fused
``qkv.w`` is ``[d, 3d]`` as q|k|v blocks), so no transposes are needed.
Both loaders are strict: a missing, extra or mis-shaped key raises.
``export_params`` is their inverse.

The reference allRank persists a trained model as a pickled torch
``state_dict`` (``model.pkl``). ``torch_state_dict_to_params`` maps it onto
the JAX-shaped params tree (numpy arrays) that ``load_jax_params`` takes,
and ``params_to_torch_state_dict`` maps back; both are the JAX package's
``interop.py`` mapping, kept here as a copy:

    input_layer.input_norm.{weight,bias}        -> fc.input_norm.{scale,bias}
    input_layer.layers.{i}.{weight,bias}        -> fc.layers[i].{w^T,b}
    encoder.layers.{i}.self_attn.linears.{0,1,2}-> transformer.layers[i].qkv
                                                   (w = [Wq^T | Wk^T | Wv^T])
    encoder.layers.{i}.self_attn.linears.3      -> transformer.layers[i].out
    encoder.layers.{i}.feed_forward.w_{1,2}     -> transformer.layers[i].ff{1,2}
    encoder.layers.{i}.sublayer.{0,1}.norm      -> transformer.layers[i].ln{1,2}
    encoder.norm.{a_2,b_2}                      -> transformer.final_ln
    encoder.position.pe[.weight]                -> transformer.pe.table
    output_layer.w_1.{weight,bias}              -> output.{w^T,b}

A ``module.``-prefixed state_dict (saved through a data-parallel wrapper)
is handled transparently; a missing, extra or mis-shaped tensor raises.

CLI (file conversion only; nothing runs on a device):
    python -m allrank_tpu_torch.interop \
        --config-file-name config.json --n-features 136 \
        --input-model-path model.pkl --output-model-path model.npz \
        [--direction import|export]
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

_SEP = "|"


def flatten_params(params: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict/list params tree as ``{"a|0|w": ndarray}``."""
    if isinstance(params, dict):
        items = ((str(k), v) for k, v in params.items())
    elif isinstance(params, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(params))
    else:
        return {prefix: np.asarray(params)}
    flat: Dict[str, np.ndarray] = {}
    for key, value in items:
        flat.update(flatten_params(value,
                                   f"{prefix}{_SEP}{key}" if prefix else key))
    return flat


def _load_flat(model: nn.Module, flat: Dict[str, np.ndarray],
               source: str) -> nn.Module:
    targets = {name.replace(".", _SEP): t
               for name, t in model.state_dict(keep_vars=True).items()}
    missing = sorted(set(targets) - set(flat))
    extra = sorted(set(flat) - set(targets))
    if missing or extra:
        raise KeyError(f"{source} does not match the model: missing "
                       f"{missing}, unexpected {extra}")
    for key, t in targets.items():
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for '{key}': {source} has "
                             f"{arr.shape}, the model {tuple(t.shape)}")
    with torch.no_grad():
        for key, t in targets.items():
            t.copy_(torch.tensor(np.asarray(flat[key]), dtype=t.dtype))
    return model


def load_jax_params(model: nn.Module, params: Any) -> nn.Module:
    """Copies the JAX package's params tree (numpy arrays, as from
    ``jax.tree.map(np.asarray, params)``) into ``model`` in place."""
    return _load_flat(model, flatten_params(params), "params")


def load_npz(model: nn.Module, path: str) -> nn.Module:
    """Copies a ``model.npz`` written by the JAX package's
    ``training.checkpoint.save_params`` into ``model`` in place."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    return _load_flat(model, flat, path)


def export_params(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's parameters and buffers as ``{"a|0|w": ndarray}`` under
    the JAX package's key names (the flat form ``load_npz`` reads and
    ``flatten_params`` gives)."""
    return {name.replace(".", _SEP): t.detach().cpu().numpy().copy()
            for name, t in model.state_dict(keep_vars=True).items()}


# -- the reference's state_dict ------------------------------------------------

def _to_numpy(t: Any) -> np.ndarray:
    """torch.Tensor | ndarray | array-like -> ndarray of its own dtype."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _strip_module_prefix(state: Mapping[str, Any]) -> Dict[str, Any]:
    if state and all(k.startswith("module.") for k in state):
        return {k[len("module."):]: v for k, v in state.items()}
    return dict(state)


def _take(state: Dict[str, Any], key: str) -> np.ndarray:
    if key not in state:
        raise KeyError(
            f"reference checkpoint is missing '{key}' — wrong config for "
            f"this checkpoint? (have e.g. {sorted(state)[:6]}...)"
        )
    return _to_numpy(state.pop(key))


def _linear(state: Dict[str, Any], prefix: str, d_in: int, d_out: int) -> dict:
    """nn.Linear(d_in, d_out) -> our dense {w: [d_in, d_out], b: [d_out]}."""
    w = _take(state, f"{prefix}.weight")
    b = _take(state, f"{prefix}.bias")
    if w.shape != (d_out, d_in):
        raise ValueError(
            f"'{prefix}.weight' has shape {w.shape}, expected {(d_out, d_in)}"
        )
    return {"w": np.ascontiguousarray(w.T), "b": b}


def _std_norm(state: Dict[str, Any], prefix: str, dim: int) -> dict:
    """Reference custom LayerNorm (a_2/b_2) -> our {scale, bias}."""
    a = _take(state, f"{prefix}.a_2")
    b = _take(state, f"{prefix}.b_2")
    if a.shape != (dim,):
        raise ValueError(f"'{prefix}.a_2' has shape {a.shape}, expected {(dim,)}")
    return {"scale": a, "bias": b}


def _pe_table(state: Dict[str, Any], key: str, kind: str, rows: int, d: int,
              max_indices: int) -> np.ndarray:
    table = _take(state, key)
    if table.shape != (rows, d):
        raise ValueError(
            f"{kind} positional table has shape {table.shape}, "
            f"expected {(rows, d)} (max_indices={max_indices})"
        )
    return table


def torch_state_dict_to_params(state_dict: Mapping[str, Any], mdef) -> dict:
    """A reference LTRModel ``state_dict`` as the JAX package's params tree
    (nested dicts and lists of numpy arrays) for the model ``mdef`` (from
    ``make_model``): ``load_jax_params`` copies it into an ``LTRModel``.

    Raises with a precise message on any missing/extra/mis-shaped tensor, so
    a config/checkpoint mismatch fails loudly rather than scoring garbage.
    """
    state = _strip_module_prefix(dict(state_dict))
    params: dict = {}

    if mdef.fc:
        dims = (mdef.fc.n_features,) + tuple(mdef.fc.sizes)
        fc: dict = {
            "layers": [
                _linear(state, f"input_layer.layers.{i}", dims[i], dims[i + 1])
                for i in range(len(mdef.fc.sizes))
            ]
        }
        if mdef.fc.input_norm:
            # torch nn.LayerNorm: weight -> scale, bias -> bias
            fc["input_norm"] = {
                "scale": _take(state, "input_layer.input_norm.weight"),
                "bias": _take(state, "input_layer.input_norm.bias"),
            }
        params["fc"] = fc

    if mdef.transformer:
        tdef = mdef.transformer
        d = tdef.d_model
        layers = []
        for i in range(tdef.N):
            at = f"encoder.layers.{i}.self_attn.linears"
            q = _linear(state, f"{at}.0", d, d)
            k = _linear(state, f"{at}.1", d, d)
            v = _linear(state, f"{at}.2", d, d)
            layers.append({
                "qkv": {
                    "w": np.concatenate([q["w"], k["w"], v["w"]], axis=1),
                    "b": np.concatenate([q["b"], k["b"], v["b"]]),
                },
                "out": _linear(state, f"{at}.3", d, d),
                "ff1": _linear(
                    state, f"encoder.layers.{i}.feed_forward.w_1", d, tdef.d_ff
                ),
                "ff2": _linear(
                    state, f"encoder.layers.{i}.feed_forward.w_2", tdef.d_ff, d
                ),
                "ln1": _std_norm(state, f"encoder.layers.{i}.sublayer.0.norm", d),
                "ln2": _std_norm(state, f"encoder.layers.{i}.sublayer.1.norm", d),
            })
        tr: dict = {
            "layers": layers,
            "final_ln": _std_norm(state, "encoder.norm", d),
        }
        rows = tdef.max_indices + 1
        if tdef.positional_encoding == "learned":
            tr["pe"] = {"table": _pe_table(
                state, "encoder.position.pe.weight", "learned", rows, d,
                tdef.max_indices)}
        elif tdef.positional_encoding == "fixed":
            # the sin/cos table is a buffer in the reference state_dict;
            # carried over verbatim so that scores match bit for bit
            tr["pe"] = {"table": _pe_table(
                state, "encoder.position.pe", "fixed", rows, d,
                tdef.max_indices)}
        params["transformer"] = tr

    params["output"] = _linear(
        state, "output_layer.w_1", mdef.output.d_model, mdef.output.d_output
    )

    if state:
        raise ValueError(
            f"reference checkpoint has {len(state)} unmapped tensor(s): "
            f"{sorted(state)} — config does not describe this checkpoint"
        )
    return params


def _unflatten(flat: Mapping[str, Any]) -> dict:
    """``{"a|0|w": x}`` back into nested dicts, lists where the keys are
    indices (the inverse of ``flatten_params``)."""
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split(_SEP)
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def params_to_torch_state_dict(params: Mapping[str, Any], mdef
                               ) -> Dict[str, np.ndarray]:
    """Inverse of ``torch_state_dict_to_params``: a params tree, or its flat
    form (``flatten_params``, ``export_params``), as a reference-layout
    state_dict of numpy arrays, so that a model trained here drops back into
    a torch serving stack that expects the reference's LTRModel naming."""
    if any(_SEP in k for k in params):
        params = _unflatten(params)
    sd: Dict[str, np.ndarray] = {}

    def put_linear(prefix: str, dense: Mapping[str, Any]) -> None:
        sd[f"{prefix}.weight"] = np.ascontiguousarray(np.asarray(dense["w"]).T)
        sd[f"{prefix}.bias"] = np.asarray(dense["b"])

    def put_std_norm(prefix: str, ln: Mapping[str, Any]) -> None:
        sd[f"{prefix}.a_2"] = np.asarray(ln["scale"])
        sd[f"{prefix}.b_2"] = np.asarray(ln["bias"])

    if mdef.fc:
        fc = params["fc"]
        if mdef.fc.input_norm:
            sd["input_layer.input_norm.weight"] = np.asarray(
                fc["input_norm"]["scale"])
            sd["input_layer.input_norm.bias"] = np.asarray(
                fc["input_norm"]["bias"])
        for i, layer in enumerate(fc["layers"]):
            put_linear(f"input_layer.layers.{i}", layer)

    if mdef.transformer:
        tdef = mdef.transformer
        d = tdef.d_model
        tr = params["transformer"]
        for i, lp in enumerate(tr["layers"]):
            at = f"encoder.layers.{i}.self_attn.linears"
            qkv_w = np.asarray(lp["qkv"]["w"])  # [d, 3d]
            qkv_b = np.asarray(lp["qkv"]["b"])
            for j in range(3):
                sd[f"{at}.{j}.weight"] = np.ascontiguousarray(
                    qkv_w[:, j * d:(j + 1) * d].T
                )
                sd[f"{at}.{j}.bias"] = qkv_b[j * d:(j + 1) * d]
            put_linear(f"{at}.3", lp["out"])
            put_linear(f"encoder.layers.{i}.feed_forward.w_1", lp["ff1"])
            put_linear(f"encoder.layers.{i}.feed_forward.w_2", lp["ff2"])
            put_std_norm(f"encoder.layers.{i}.sublayer.0.norm", lp["ln1"])
            put_std_norm(f"encoder.layers.{i}.sublayer.1.norm", lp["ln2"])
        put_std_norm("encoder.norm", tr["final_ln"])
        if tdef.positional_encoding == "learned":
            sd["encoder.position.pe.weight"] = np.asarray(tr["pe"]["table"])
        elif tdef.positional_encoding == "fixed":
            sd["encoder.position.pe"] = np.asarray(tr["pe"]["table"])

    put_linear("output_layer.w_1", params["output"])
    return sd


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A reference ``model.pkl`` (a pickled torch state_dict) as numpy
    arrays, unpickled with ``weights_only=True`` (tensors only, no code)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: _to_numpy(v) for k, v in state.items()}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Convert checkpoints between the reference (allRank "
        "torch model.pkl) and this framework (model.npz)"
    )
    p.add_argument("--config-file-name", required=True,
                   help="the config the checkpoint was trained with")
    p.add_argument("--input-model-path", required=True,
                   help="model.pkl (import) or model.npz (export)")
    p.add_argument("--output-model-path", required=True,
                   help="model.npz (import) or model.pkl (export)")
    p.add_argument("--n-features", required=True, type=int,
                   help="feature dimensionality of the training data")
    p.add_argument("--direction", choices=("import", "export"),
                   default="import",
                   help="'import': reference pkl -> npz (default); "
                   "'export': npz -> reference-layout pkl")
    return p.parse_args(argv)


def run(argv=None) -> None:
    from allrank_tpu_torch.config import Config
    from allrank_tpu_torch.models.factory import LTRModel, make_model
    from allrank_tpu_torch.training.checkpoint import save_params
    from allrank_tpu_torch.utils.ltr_logging import get_logger

    args = parse_args(argv)
    config = Config.from_json(args.config_file_name)
    mdef = make_model(config.model, n_features=args.n_features)
    # the model is a strict template of names and shapes, on the CPU
    model = LTRModel(mdef, device="cpu")
    n_params = sum(p.numel() for p in model.state_dict().values())
    if args.direction == "import":
        state = load_torch_state_dict(args.input_model_path)
        load_jax_params(model, torch_state_dict_to_params(state, mdef))
        save_params(model, args.output_model_path)
        get_logger().info(
            "imported %d reference tensors -> %s (%d parameters)",
            len(state), args.output_model_path, n_params,
        )
    else:
        load_npz(model, args.input_model_path)
        sd = {
            k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in params_to_torch_state_dict(
                export_params(model), mdef).items()
        }
        torch.save(sd, args.output_model_path)
        get_logger().info(
            "exported %d parameters -> %s (%d reference tensors)",
            n_params, args.output_model_path, len(sd),
        )


if __name__ == "__main__":
    run()
