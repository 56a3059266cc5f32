"""Device resolution shared by the entry points.

Every entry point runs on the GPU unless its caller asks for the CPU: a
default that quietly ran on the CPU would hide a missing card behind a
thousandfold slowdown.
"""

from __future__ import annotations

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
