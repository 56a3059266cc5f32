"""Times the bare slate-attention kernels B4 (``ops/attention_fused.py``)
and B5 (``ops/attention_tiled.py``) on the card: forward and backward, fp32
and bf16, dropout 0, at the shapes of their main paths, as one JSON line
each with the card's name and power limit: ``ms``, one call timed by CUDA
events (median of ``--iters`` after warm-up; the host's launch is in it),
and ``graph_ms``, the device's own time, 20 calls captured in one CUDA
graph and replayed (``timing.graph_ms``). ``--library`` adds the
yardstick ``scaled_dot_product_attention`` with the additive key mask
(-1e9 at padded keys) on the same inputs: ``library_ms`` event-timed,
``library_device_ms`` its device time (the forward in a CUDA graph; the
backward, which autograd keeps out of a graph, as the sum of its kernels'
durations in a torch.profiler trace, ``timing.kernel_ms``) and
``library_kernels``, the kernels' names, which say whether it ran on the
tensor cores. ``--ptxas`` first prints each kernel's registers and spills
from the build's ``-Xptxas=-v`` log. ``--scorer`` times instead one
end-to-end fp32 path, the long-slate scorer of ``chip_smoke.py`` phase 22:
the paper config's model (``PAPER_CONFIG``, dropout 0, seeded random
weights) through ``make_scorer`` in fp32 at B=4, L=8192 (lengths 8192,
5000, 0, 1): ms a call (CUDA events), the device's busy ms a call and its
device time by kernel (a torch.profiler trace of 5 calls).

To compare two checkouts inside one call (the only fair comparison: two
calls may land on two cards), run this file by its path with each
checkout's root first on ``PYTHONPATH``, in turns::

    PYTHONPATH=/path/to/other python allrank_tpu_torch/tools/time_attention.py
    PYTHONPATH=. python allrank_tpu_torch/tools/time_attention.py

The line ``package`` says which checkout was timed, ``route`` which kernels
of it ran. Without a card it exits 2: it measures nothing on the CPU.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

PAPER_CONFIG = "reproducibility/configs/contextaware_web30k/ndcgloss2pp.json"
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


def library_fns(q, k, v, mask, do, p_drop: float = 0.0):
    """The yardstick ``scaled_dot_product_attention`` on q, k, v [B, h, L,
    d_k] with the additive key mask (-1e9 where mask [B, L] is True, at
    padded keys), dropout at ``p_drop`` and the cotangent do: (forward,
    backward by autograd on one retained forward), functions that run it
    once. Never called by the port; ``chip_smoke.py`` times it too."""
    mask_add = torch.zeros(q.shape[0], 1, 1, q.shape[2], dtype=q.dtype,
                           device=q.device).masked_fill(
        mask[:, None, None, :], -1e9)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=mask_add,
                                         dropout_p=p_drop)
    return (lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask_add, dropout_p=p_drop),
            lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))


def route_of(module, dtype, dk: int) -> str:
    """The kernels a call takes: the module's ``route`` where the checkout
    has one, else its earlier split (bf16 on the tensor cores, fp32 on the
    SIMT units)."""
    if hasattr(module, "route"):
        return module.route(dtype, dk)
    return "mma" if dtype == torch.bfloat16 else "simt"


def time_scorer(card: str, package: str, iters: int) -> dict:
    """``--scorer``'s line: the fp32 long-slate scorer's ms a call, device
    busy ms a call and device ms a call by kernel."""
    import numpy as np

    from allrank_tpu_torch.config import Config
    from allrank_tpu_torch.models.factory import LTRModel, make_model
    from allrank_tpu_torch.serving import make_scorer
    from allrank_tpu_torch.tools.timing import (
        _median_event_ms,
        busy_us,
        trace_kernels,
    )

    b, l, features, calls = 4, 8192, 136, 5
    dev = torch.device("cuda", 0)
    cfg = Config.from_json(PAPER_CONFIG)
    cfg.model.transformer.dropout = 0.0
    model = LTRModel(make_model(cfg.model, features),
                     torch.Generator().manual_seed(0), device=dev)
    scorer = make_scorer(model, "float32")
    x = torch.as_tensor(np.random.RandomState(22).randn(b, l, features)
                        .astype(np.float32), device=dev)
    lengths = torch.tensor([l, 5000, 0, 1], device=dev)

    def call():
        return scorer(x, lengths)

    ms = _median_event_ms(call, iters, 3)
    spans, window_us = trace_kernels(call, calls)
    by_name: dict = {}
    for name, start, end in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / calls / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"path": "long-slate scorer, paper config, fp32",
            "shape": [b, l, features], "ms": ms,
            "device_busy_ms": busy_us(spans) / calls / 1e3,
            "by_kernel_ms": {k[:80]: v for k, v in top},
            "card": card, "package": package}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--ptxas", action="store_true")
    parser.add_argument("--library", action="store_true",
                        help="also time scaled_dot_product_attention")
    parser.add_argument("--scorer", action="store_true",
                        help="time the fp32 long-slate scorer instead")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_attention: no CUDA device", file=sys.stderr)
        return 2
    import allrank_tpu_torch
    from allrank_tpu_torch.ops import _build
    from allrank_tpu_torch.ops import attention_fused as b4
    from allrank_tpu_torch.ops import attention_tiled as b5
    from allrank_tpu_torch.tools.timing import (
        _median_event_ms,
        graph_ms,
        kernel_ms,
    )

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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.scorer:
        print(json.dumps(time_scorer(card, package, args.iters)), flush=True)
        return 0
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    for b, h, l, dk in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn(b, h, l, dk, generator=gen).to(dtype)
                           .to(dev) for _ in range(4))
            lengths = torch.randint(1, l + 1, (b,), generator=gen)
            lengths[0] = l
            mask = (torch.arange(l)[None, :] >= lengths[:, None]).to(dev)
            _, stats = b4.attention_fused_fwd(q, k, v, mask,
                                              return_saved=True)
            out, lse = b5.tiled_attention_fwd(q, k, v, mask,
                                              return_saved=True)
            fns = {
                "attention_fused_fwd": lambda: b4.attention_fused_fwd(
                    q, k, v, mask),
                "attention_fused_bwd": lambda: b4.attention_fused_bwd(
                    q, k, v, mask, do, stats=stats),
                "tiled_attention_fwd": lambda: b5.tiled_attention_fwd(
                    q, k, v, mask),
                "tiled_attention_bwd": lambda: b5.tiled_attention_bwd(
                    q, k, v, mask, out, lse, do)}
            lib = library_fns(q, k, v, mask, do) if args.library else None
            iters = max(3, args.iters // 2) if l > 2000 else args.iters
            for name, fn in fns.items():
                line = {"kernel": name, "shape": [b, h, l, dk],
                        "dtype": str(dtype).split(".")[-1],
                        "route": route_of(b4 if "fused" in name else b5,
                                          dtype, dk),
                        "ms": _median_event_ms(fn, iters, 3),
                        "graph_ms": graph_ms(fn)}
                if lib is not None:
                    backward = name.endswith("bwd")
                    lib_fn = lib[backward]
                    by_name = kernel_ms(lib_fn)
                    line.update(
                        library_ms=_median_event_ms(lib_fn, iters, 3),
                        library_device_ms=(sum(by_name.values()) if backward
                                           else graph_ms(lib_fn)),
                        library_kernels={n[:120]: t
                                         for n, t in by_name.items()})
                line.update(card=card, package=package)
                print(json.dumps(line), flush=True)
            del q, k, v, do, mask, stats, out, lse, fns, lib
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
