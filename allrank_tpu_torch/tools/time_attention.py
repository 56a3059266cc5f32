"""Times the bare slate-attention kernels B4 (``ops/attention_fused.py``)
and B5 (``ops/attention_tiled.py``) on the card: forward and backward, fp32
and bf16, dropout 0, at the shapes of their main paths, as one JSON line
each with the card's name and power limit: ``ms``, one call timed by CUDA
events (median of ``--iters`` after warm-up; the host's launch is in it),
and ``graph_ms``, the device's own time, 20 calls captured in one CUDA
graph and replayed (``timing.graph_ms``). ``--ptxas`` first prints each kernel's registers and
spills from the build's ``-Xptxas=-v`` log.

To compare two checkouts inside one call (the only fair comparison: two
calls may land on two cards), run this file by its path with each
checkout's root first on ``PYTHONPATH``, in turns::

    PYTHONPATH=/path/to/other python allrank_tpu_torch/tools/time_attention.py
    PYTHONPATH=. python allrank_tpu_torch/tools/time_attention.py

The line ``package`` says which checkout was timed. Without a card it
exits 2: it measures nothing on the CPU.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys

import torch

# (B, h, L, d_k): the (16, 1200) step's (and at B=8), the (8, 4096) step's,
# B1's longest slate and the int8 tower's serving shape
SHAPES = ((16, 4, 1200, 32), (8, 4, 1200, 32), (8, 4, 4096, 32),
          (16, 4, 1024, 32), (64, 4, 240, 32))


def ptxas_lines(source: str) -> list:
    """(kernel, registers and spill lines) from ``source``'s build log."""
    from allrank_tpu_torch.ops import _build

    out, name = [], None
    with open(_build.log_path(source)) as f:
        for line in f:
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                name = found.group(1)
            elif name and ("registers" in line or "spill" in line):
                out.append((name, line.strip()))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--ptxas", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_attention: no CUDA device", file=sys.stderr)
        return 2
    import allrank_tpu_torch
    from allrank_tpu_torch.ops import _build
    from allrank_tpu_torch.ops.attention_fused import (
        attention_fused_bwd,
        attention_fused_fwd,
    )
    from allrank_tpu_torch.ops.attention_tiled import (
        tiled_attention_bwd,
        tiled_attention_fwd,
    )
    from allrank_tpu_torch.tools.timing import _median_event_ms, graph_ms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    package = allrank_tpu_torch.__file__
    _build.build(["attention_fused", "attention_tiled"])
    if args.ptxas:
        for source in ("attention_fused", "attention_tiled"):
            for name, line in ptxas_lines(source):
                print(f"ptxas {source} {name}: {line}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    for b, h, l, dk in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn(b, h, l, dk, generator=gen).to(dtype)
                           .to(dev) for _ in range(4))
            lengths = torch.randint(1, l + 1, (b,), generator=gen)
            lengths[0] = l
            mask = (torch.arange(l)[None, :] >= lengths[:, None]).to(dev)
            _, stats = attention_fused_fwd(q, k, v, mask, return_saved=True)
            out, lse = tiled_attention_fwd(q, k, v, mask, return_saved=True)
            fns = {
                "attention_fused_fwd": lambda: attention_fused_fwd(q, k, v,
                                                                   mask),
                "attention_fused_bwd": lambda: attention_fused_bwd(
                    q, k, v, mask, do, stats=stats),
                "tiled_attention_fwd": lambda: tiled_attention_fwd(q, k, v,
                                                                   mask),
                "tiled_attention_bwd": lambda: tiled_attention_bwd(
                    q, k, v, mask, out, lse, do)}
            iters = max(3, args.iters // 2) if l > 2000 else args.iters
            for name, fn in fns.items():
                ms = _median_event_ms(fn, iters, 3)
                print(json.dumps({"kernel": name, "shape": [b, h, l, dk],
                                  "dtype": str(dtype).split(".")[-1],
                                  "ms": ms, "graph_ms": graph_ms(fn),
                                  "card": card, "package": package}))
            del q, k, v, do, mask, stats, out, lse, fns
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
