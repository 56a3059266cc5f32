"""Times the sublayer kernels B1 (``ops/attention_block.py``) and B2
(``ops/ffn_block.py``) on the card at the flagship shape (B=64, L=240,
d=128, h=4, d_ff=512, ragged lengths, one fully padded slate), forward and
backward, fp32 and bf16, beside their library chains (std-LN in torch ops,
``torch.matmul``, ``scaled_dot_product_attention`` or ``relu``, backward by
autograd), as one JSON line each with the card's name and power limit:
``ms``, one call timed by CUDA events (median of ``--iters`` after warm-up;
the host's launches are in it), and ``graph_ms``, the device's own time,
20 calls captured in one CUDA graph and replayed (``timing.graph_ms``); a
library backward, whose autograd engine refuses capture (it makes the
legacy stream wait on the capturing one), takes instead the sum of its
kernels' durations in a torch.profiler trace of 10 calls
(``timing.kernel_ms``). ``--profile`` adds each wrapper's
device time by kernel from such a trace; ``--ptxas SOURCE ...`` first
prints each kernel's registers and spills from those sources' build logs.
``--step`` instead times ``bench.py``'s train step (the flagship model:
136 features, FC [128], 4 blocks of d=128, h=4, d_ff=512, dropout 0, bf16,
Adam at 1e-3, lambdaLoss with ndcgLoss2PP at B=64, L=240 with a
40-document padding tail): the step's ms (CUDA events, the host's time in
it), the device's busy ms a step and its idle share, and its device time
by kernel, from a torch.profiler trace of 5 steps.

To compare two checkouts inside one call (two calls may land on two
cards), run this file by its path with each checkout's root first on
``PYTHONPATH``, in turns::

    PYTHONPATH=/path/to/other python allrank_tpu_torch/tools/time_sublayers.py
    PYTHONPATH=. python allrank_tpu_torch/tools/time_sublayers.py

The line's ``package`` says which checkout was timed. Without a card it
exits 2: it measures nothing on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

B, L, D, H, D_FF = 64, 240, 128, 4, 512


def b1_library(x, mask_add, g, b, wqkv, bqkv, wout, bout, h):
    """The attention sublayer in library calls: the std-LN in torch ops,
    torch.matmul and scaled_dot_product_attention (a yardstick only)."""
    from allrank_tpu_torch.models.core import std_layer_norm

    bsz, l, d = x.shape
    qkv = torch.matmul(std_layer_norm(x, g, b), wqkv) + bqkv
    q, k, v = qkv.view(bsz, l, 3, h, d // h).permute(2, 0, 3, 1, 4)
    ctx = F.scaled_dot_product_attention(q, k, v, attn_mask=mask_add)
    ctx = ctx.transpose(1, 2).reshape(bsz, l, d)
    return x + (torch.matmul(ctx, wout) + bout)


def b2_library(x, g, b, w1, b1, w2, b2):
    """The FFN sublayer in library calls: std-LN, torch.matmul, relu."""
    from allrank_tpu_torch.models.core import std_layer_norm

    hidden = torch.relu(torch.matmul(std_layer_norm(x, g, b), w1) + b1)
    return x + (torch.matmul(hidden, w2) + b2)


def inputs(gen, dtype, dev):
    """x, the key mask, B1's and B2's parameters and an output cotangent."""
    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    lengths = torch.randint(1, L + 1, (B,), generator=gen)
    lengths[0] = 0
    mask = (torch.arange(L)[None, :] >= lengths[:, None]).to(dev)
    attn = [1 + r(D, scale=0.1), r(D, scale=0.1),
            r(D, 3 * D, scale=D ** -0.5), r(3 * D, scale=0.1),
            r(D, D, scale=D ** -0.5), r(D, scale=0.1)]
    ffn = [1 + r(D, scale=0.1), r(D, scale=0.1),
           r(D, D_FF, scale=D ** -0.5), r(D_FF, scale=0.1),
           r(D_FF, D, scale=D_FF ** -0.5), r(D, scale=0.1)]
    x = r(B, L, D).to(dtype).to(dev)
    dy = r(B, L, D).to(dtype).to(dev)
    return (x, mask, [p.to(dev) for p in attn], [p.to(dev) for p in ffn],
            dy)


def library_fns(kind, x, mask, params, dy):
    """(forward, backward by autograd on one retained forward) of a library
    chain as functions that run it once."""
    dtype = x.dtype
    leaves = [t.detach().to(dtype).requires_grad_()
              for t in [x] + list(params)]
    if kind == "b1":
        mask_add = torch.zeros(B, 1, 1, L, dtype=dtype,
                               device=x.device).masked_fill(
            mask[:, None, None, :], -1e9)

        def fwd():
            return b1_library(leaves[0], mask_add, *leaves[1:], H)
    else:
        def fwd():
            return b2_library(*leaves)

    out = fwd()
    return (fwd,
            lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True))


def flagship_step(dev):
    """``bench.py``'s train step on a model of seeded random weights, and
    its batch: (step, (x, y, indices))."""
    import numpy as np

    from allrank_tpu_torch.config import (
        FCConfig,
        ModelConfig,
        PositionalEncodingConfig,
        PostModelConfig,
        TransformerConfig,
    )
    from allrank_tpu_torch.losses import get_loss
    from allrank_tpu_torch.models.factory import LTRModel, make_model
    from allrank_tpu_torch.training import make_optimizer, make_train_step

    features = 136
    mdef = make_model(ModelConfig(
        fc_model=FCConfig(sizes=[128], input_norm=True, activation="ReLU",
                          dropout=0.0),
        transformer=TransformerConfig(
            N=4, d_ff=D_FF, h=H, dropout=0.0,
            positional_encoding=PositionalEncodingConfig(
                strategy="fixed", max_indices=256)),
        post_model=PostModelConfig(d_output=1)), features)
    model = LTRModel(mdef, torch.Generator().manual_seed(0), device=dev)
    loss_fn, needs_rng = get_loss("lambdaLoss")
    step = make_train_step(
        model, loss_fn, {"weighing_scheme": "ndcgLoss2PP_scheme", "mu": 10.0},
        needs_rng, make_optimizer("Adam", {"lr": 1e-3}, model.parameters()),
        None, "bfloat16")
    rng = np.random.RandomState(0)
    x = rng.randn(B, L, features).astype(np.float32)
    y = np.clip(np.round(2.0 + x[..., 0] + 0.5 * rng.randn(B, L)), 0,
                4).astype(np.float32)
    indices = np.tile(np.arange(L), (B, 1))
    y[:, -40:] = -1.0
    indices[:, -40:] = -1
    return step, tuple(torch.as_tensor(t, device=dev)
                       for t in (x, y, indices))


def time_step(card: str, package: str, iters: int) -> dict:
    """``--step``'s line: the flagship step's ms, device busy ms a step,
    idle share and device ms a step by kernel (the ten largest)."""
    from allrank_tpu_torch.tools.timing import (
        _median_event_ms,
        busy_us,
        trace_kernels,
    )

    dev = torch.device("cuda", 0)
    step, batch = flagship_step(dev)
    calls = 5
    ms = _median_event_ms(lambda: step(*batch), iters, 3)
    spans, window_us = trace_kernels(lambda: step(*batch), calls)
    by_name = {}
    for name, start, end in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / calls / 1e3
    busy = busy_us(spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"step": "bench.py config, flagship, bf16", "shape": [B, L],
            "ms": ms, "device_busy_ms": busy / calls / 1e3,
            "idle_share": 1 - busy / window_us,
            "by_kernel_ms": {k[:80]: v for k, v in top},
            "card": card, "package": package}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--ptxas", nargs="*", default=())
    parser.add_argument("--profile", action="store_true",
                        help="also each kernel's device time by name")
    parser.add_argument("--step", action="store_true",
                        help="time bench.py's train step instead")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_sublayers: no CUDA device", file=sys.stderr)
        return 2
    import allrank_tpu_torch
    from allrank_tpu_torch.ops import _build
    from allrank_tpu_torch.ops import attention_block as b1
    from allrank_tpu_torch.ops import ffn_block as b2
    from allrank_tpu_torch.tools.time_attention import ptxas_lines
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
    sources = [s for s in ("attention_block", "attention_block_mma",
                           "ffn_block", "ffn_block_mma", *args.ptxas)
               if os.path.exists(_build.source_path(s))]
    _build.build(sorted(set(sources)))
    for source in args.ptxas:
        for name, line in ptxas_lines(source):
            print(f"ptxas {source} {name}: {line}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.step:
        print(json.dumps(time_step(card, package, args.iters)), flush=True)
        return 0
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        x, mask, ap, fp, dy = inputs(gen, dtype, dev)
        _, saved = b1.attention_sublayer_fwd(x, mask, *ap, H,
                                             return_saved=True)
        # an older checkout, whose modules have no route, runs SIMT alone
        routes = {"attention": (b1.route(dtype, D, H)
                                if hasattr(b1, "route") else "simt"),
                  "ffn": (b2.route(dtype, D, D_FF)
                          if hasattr(b2, "route") else "simt")}
        kernels = {
            "attention_sublayer_fwd": lambda: b1.attention_sublayer_fwd(
                x, mask, *ap, H),
            "attention_sublayer_bwd": lambda: b1.attention_sublayer_bwd(
                x, mask, *ap, dy, H, saved=saved),
            "ffn_sublayer_fwd": lambda: b2.ffn_sublayer_fwd(x, *fp),
            "ffn_sublayer_bwd": lambda: b2.ffn_sublayer_bwd(x, *fp, dy)}
        libs = {"b1": library_fns("b1", x, mask, ap, dy),
                "b2": library_fns("b2", x, mask, fp, dy)}
        lib_of = {"attention_sublayer_fwd": ("b1", 0),
                  "attention_sublayer_bwd": ("b1", 1),
                  "ffn_sublayer_fwd": ("b2", 0),
                  "ffn_sublayer_bwd": ("b2", 1)}
        for name, fn in kernels.items():
            kind, bwd = lib_of[name]
            lib_fn = libs[kind][bwd]
            print(json.dumps({
                "kernel": name, "shape": [B, L, D, H, D_FF],
                "dtype": str(dtype).split(".")[-1],
                "route": routes[name.split("_")[0]],
                "ms": _median_event_ms(fn, args.iters, 3),
                "graph_ms": graph_ms(fn),
                "library_ms": _median_event_ms(lib_fn, args.iters, 3),
                "library_device_ms": (sum(kernel_ms(lib_fn).values())
                                      if bwd else graph_ms(lib_fn)),
                "by_kernel_ms": kernel_ms(fn) if args.profile else None,
                "card": card, "package": package}), flush=True)
        del kernels, libs, saved
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
