"""Device resolution shared by the entry points.

Every entry point runs on the GPU unless its caller asks for the CPU: a
default that quietly ran on the CPU would hide a missing card behind a
thousandfold slowdown.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the current CUDA device; raises ``RuntimeError``
    when CUDA was asked for (explicitly or by default) and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "allrank_tpu_torch runs on a CUDA GPU by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def require_one_device(parallel) -> None:
    """Refuses, as not yet ported, what the JAX package runs over several
    devices: a ``parallel`` layout of more than one device (``data = -1``
    means the devices the run has: here one) and a multi-process launch."""
    sizes = {"data": max(int(parallel.data), 1), "model": int(parallel.model),
             "sequence": int(parallel.sequence)}
    if any(n > 1 for n in sizes.values()):
        raise NotImplementedError(
            f"a parallel layout of more than one device {sizes} is not yet "
            "ported to allrank_tpu_torch")
    if (int(os.environ.get("WORLD_SIZE", "1")) > 1
            or os.environ.get("JAX_COORDINATOR_ADDRESS")
            or os.environ.get("COORDINATOR_ADDRESS")):
        raise NotImplementedError(
            "multi-process runs are not yet ported to allrank_tpu_torch")
