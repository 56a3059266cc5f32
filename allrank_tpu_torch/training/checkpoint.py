"""Parameter checkpointing: the model <-> one ``.npz`` file under the JAX
package's key names (tree path joined with ``|``), so either package loads
the other's ``model.npz`` (the JAX package's ``training/checkpoint.py``).

The optimizer state of the partial checkpoint is saved in this package's own
layout: ``torch.optim``'s per-parameter state tensors keyed
``<parameter index>|<state name>``; the JAX package's Orbax backend is not
ported.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
from torch import nn

from allrank_tpu_torch import interop
from allrank_tpu_torch.utils.file_utils import is_gs_path


def _write_npz(arrays: Dict[str, np.ndarray], path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    return path


def save_params(model: nn.Module, path: str) -> str:
    """Write the model's parameters as ``{tree_path: ndarray}`` npz; returns
    path."""
    return _write_npz(interop.export_params(model), path)


def load_params(model: nn.Module, path: str) -> nn.Module:
    """Load an npz checkpoint (written by this package or the JAX package)
    into ``model`` in place; a missing, extra or mis-shaped key raises."""
    if is_gs_path(path):
        raise NotImplementedError(
            "gs:// paths are not yet ported to allrank_tpu_torch")
    return interop.load_npz(model, path)


def save_opt_state(optimizer: torch.optim.Optimizer, path: str) -> str:
    """Write the optimizer's per-parameter state tensors and each group's
    learning rate."""
    state = optimizer.state_dict()
    arrays = {f"{index}|{name}": torch.as_tensor(value).cpu().numpy()
              for index, entry in state["state"].items()
              for name, value in entry.items()}
    arrays["lr"] = np.asarray([g["lr"] for g in state["param_groups"]])
    return _write_npz(arrays, path)


def load_opt_state(optimizer: torch.optim.Optimizer, path: str) -> None:
    """Restore what ``save_opt_state`` wrote into ``optimizer`` (built over
    the same parameters in the same order) in place."""
    state = optimizer.state_dict()
    with np.load(path, allow_pickle=False) as data:
        entries: Dict[int, dict] = {}
        for key in data.files:
            if key == "lr":
                continue
            index, name = key.split("|", 1)
            entries.setdefault(int(index), {})[name] = torch.from_numpy(
                data[key].copy())
        for group, lr in zip(state["param_groups"], data["lr"]):
            group["lr"] = float(lr)
    state["state"] = entries
    optimizer.load_state_dict(state)  # casts to each parameter's device
