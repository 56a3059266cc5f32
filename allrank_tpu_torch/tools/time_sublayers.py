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
136 features, FC [128], 4 blocks of d=128, h=4, d_ff=512, dropout 0, Adam
at 1e-3, lambdaLoss with ndcgLoss2PP at B=64, L=240 with a 40-document
padding tail), in fp32 (``make_train_step``'s default) and in bf16
(``bench.py``'s): the step's ms (CUDA events, the host's time in it), the
device's busy ms a step and its idle share, and its device time by kernel,
from a torch.profiler trace of 5 steps; then the flagship scorer's ms a
call in both dtypes. ``--encoder`` instead times the whole-encoder kernel
pair B10 (``ops/encoder_block.py``) at the flagship (the same shape, N=4
blocks), fp32 and bf16, forward and backward, as device time: B10's
kernels' durations in a checked torch.profiler trace (its backward on the
forward's parked state, where the checkout's B10 takes one, and replaying
the forward), beside the chain of B1's and B2's kernels on their routes (a
CUDA graph) and the library chain (``encoder_library``, its backward the
sum of its kernels in a trace), and the bound of the function's products
at the tensor cores' rate (3xTF32 for fp32). ``--probes`` instead times
the probe kernels X2 (``ops/boundary_shift.py``) and X3
(``ops/attention_variants.py``) in bf16, each in device time (a CUDA
graph) with one event-timed call beside it: X2's plain and shifted kernels
at B=64, L=240 (M = 15,360 rows), d=128, d3=384 beside ``x2_library``; X3
in each mode at B=64, L=240, d=128, h=4 (ragged keys, one empty slate),
``full`` beside ``b1_library`` and B1's own forward, which it computes;
``--long`` adds X3 and B1 at B=16, L=1024, where B1 costs most.
``--losses`` instead times the loss kernels in fp32 as device time (a CUDA
graph; a library backward its kernels' sum in a trace) with one event-timed
call beside each: B9 (``ops/approx_pos.py``), forward and backward, at
B=64, L=240 with 200 valid documents and, every document valid, at (16,
1024), (2, 4096) and (2, 8192) (where the checkout's kernel covers it),
beside ``chip_smoke.approx_library`` and the bound of
``chip_smoke.approx_work`` (``time_approx``); B3
(``ops/lambda_pairs.py``) and B6 (``ops/lambda_tiled.py``) at B=64, k=240
(a 40-document padding tail, ndcgLoss2PP), and B6 at its main paths' (16, 1024) and (8, 4096) (a
100-document tail), beside ``chain_library`` and their bounds; B8
(``ops/neuralsort.py``) by route ("cluster" and "l2"; a checkout without
routes times its one kernel) at
N=64, L=240 and N=4, L=512 beside ``soft_sort_library``; B7
(``ops/sinkhorn.py``) by route ("cluster" and "l2"; likewise) at N=8, L=640
and N=2, L=768 beside ``sinkhorn_library``; X4
(``ops/neuralsort_layout.py``) at N=64, L=240 beside ``soft_sort_library``; then the NeuralNDCG recipe's
train step (``neuralndcg_atmax.json``, bf16) at B=64, L=240 and at B=8,
L=640, where the Sinkhorn kernel B7 runs, and the approxNDCG recipe's
(``approxndcg.json``, bf16) at B=64, L=240: each step's ms, the device's
busy ms a step from a torch.profiler trace of 5 steps, B8's, B7's and
B9's shares of that busy time and the device time by kernel
(``time_recipe_steps``; kernels, copies and fills only:
``timing.device_spans`` leaves out the ranges the profiler annotates on the
device's timeline, such as Adam's step, which span host time). ``--int8`` instead times the int8 dense kernel X1
(``ops/q8_dense.py``) at the flagship int8 tower's six sites (M = 15,360)
beside its library and the float layer's bf16 matmul, and the sums over a
scorer call's 18 launches (``time_int8``).

To compare two checkouts inside one call (two calls may land on two
cards), run this file by its path with each checkout's root first on
``PYTHONPATH``, in turns::

    PYTHONPATH=/path/to/other python allrank_tpu_torch/tools/time_sublayers.py
    PYTHONPATH=. python allrank_tpu_torch/tools/time_sublayers.py

The line's ``package`` says which checkout was timed; the traces are read
by that checkout's ``tools/timing.py``. Without a card it
exits 2: it measures nothing on the CPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

B, L, D, H, D_FF = 64, 240, 128, 4, 512
FEATURES = 136
D3 = 384  # X2's hidden width
LONG = (16, 1024)  # B1's costliest slate length at the flagship's width
NEURAL_CONFIG = ("reproducibility/configs/neuralndcg_web30k/"
                 "neuralndcg_atmax.json")
APPROX_CONFIG = "reproducibility/configs/neuralndcg_web30k/approxndcg.json"


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


def chain_library(pair_args, kw):
    """The lambdaLoss pair chain in the JAX package's XLA-path formulation
    (``losses/lambdaloss._plain_chain``), a yardstick only: returns
    (forward, backward by autograd) as functions that run it once."""
    import allrank_tpu_torch.losses.lambdaloss as ll

    yp, ts, g, valid = pair_args
    ok = valid > 0.5
    raw = torch.where(ok, ts, float("-inf"))
    d_row = ll.position_tables(yp.shape[1], yp.device)[0]

    def forward(leaf):
        return ll._plain_chain(leaf, raw, ts, ok, g, d_row, None,
                               kw["scheme"], kw["k_eff"], kw["sigma"],
                               kw["mu"], kw["log_base"], kw["eps"])[0]

    leaf = yp.detach().requires_grad_()
    total = forward(leaf)
    return (lambda: forward(yp),
            lambda: torch.autograd.grad(total, leaf, retain_graph=True))


def soft_sort_library(s, pad, vec, transpose):
    """The soft-sort chain in the JAX package's XLA-path formulation
    (``deterministic_neural_sort`` -> the freezing ``sinkhorn_scaling`` ->
    ``einsum``), a yardstick only: returns (forward, backward by autograd)
    as functions that run it once."""
    from allrank_tpu_torch.ops.soft_sort import (
        deterministic_neural_sort,
        sinkhorn_scaling,
    )

    mask = pad > 0.5

    def forward(leaf):
        p = sinkhorn_scaling(deterministic_neural_sort(leaf, 1.0, mask), mask,
                             backend="plain")
        return torch.einsum("bij,bi->bj" if transpose else "bij,bj->bi", p,
                            vec)

    leaf = s.detach().requires_grad_()
    out = forward(leaf)
    dout = torch.ones_like(out)
    return (lambda: forward(s),
            lambda: torch.autograd.grad(out, leaf, dout, retain_graph=True))


def sinkhorn_library(m0):
    """Sinkhorn scaling as the freezing chain of torch ops
    (``sinkhorn_scaling(backend="plain")``), a yardstick only: returns
    (forward, backward by autograd) as functions that run it once."""
    from allrank_tpu_torch.ops.soft_sort import sinkhorn_scaling

    leaf = m0.detach().requires_grad_()
    out = sinkhorn_scaling(leaf, backend="plain")
    dp = torch.ones_like(out)
    return (lambda: sinkhorn_scaling(m0, backend="plain"),
            lambda: torch.autograd.grad(out, leaf, dp, retain_graph=True))


def premasked_matrices(gen, n, l, dev):
    """B7's inputs: row-stochastic [n, l, l] matrices with the Sinkhorn
    pre-fill of ragged padding (slate 0 full, the last one fully
    padded)."""
    lengths = torch.randint(1, l + 1, (n,), generator=gen)
    lengths[0] = l
    lengths[-1] = 0
    pad = torch.arange(l)[None, :] >= lengths[:, None]
    m0 = torch.softmax(torch.randn(n, l, l, generator=gen) * 3.0, dim=-1)
    m0 = torch.where(pad[:, :, None] | pad[:, None, :], 0.0, m0)
    return torch.where(pad[:, :, None] & pad[:, None, :], 1.0, m0).to(dev)


def b2_library(x, g, b, w1, b1, w2, b2):
    """The FFN sublayer in library calls: std-LN, torch.matmul, relu."""
    from allrank_tpu_torch.models.core import std_layer_norm

    hidden = torch.relu(torch.matmul(std_layer_norm(x, g, b), w1) + b1)
    return x + (torch.matmul(hidden, w2) + b2)


def x2_library(x, pre, w1, w2, shifted):
    """The boundary kernels in library calls, a yardstick only: the
    no-gain std-LN in torch ops, bf16 ``torch.matmul`` and ``relu``."""
    def ln(v):
        c = v - v.mean(dim=-1, keepdim=True)
        var = (c * c).sum(dim=-1, keepdim=True) / max(v.shape[-1] - 1, 1)
        return (c / (torch.sqrt(torch.clamp(var, min=1e-24)) + 1e-6)).to(
            torch.bfloat16)

    if shifted:
        out = x + torch.matmul(torch.relu(pre), w2)
        return out, torch.matmul(ln(out.float()), w1)
    return x + torch.matmul(torch.relu(torch.matmul(ln(x.float()), w1)), w2)


def encoder_library(x, mask, stacks, fs, fb, dy, h):
    """B10's function in library calls, a yardstick only: per block
    ``b1_library`` and ``b2_library``, then the final std-LN, in x's
    dtype; returns (forward, backward by autograd) as functions that run it
    once."""
    from allrank_tpu_torch.models.core import std_layer_norm

    dtype = x.dtype
    mask_add = torch.zeros(x.shape[0], 1, 1, x.shape[1], dtype=dtype,
                           device=x.device).masked_fill(
        mask[:, None, None, :], -1e9)

    def forward(xx, ws, fs_, fb_):
        for n in range(ws[0].shape[0]):
            w = [t[n] for t in ws]
            xx = b1_library(xx, mask_add, *w[:6], h)
            xx = b2_library(xx, *w[6:])
        return std_layer_norm(xx, fs_, fb_)

    leaves = [t.detach().to(dtype).requires_grad_()
              for t in [x] + list(stacks) + [fs, fb]]
    out = forward(leaves[0], leaves[1:13], leaves[13], leaves[14])
    cast = [t.to(dtype) for t in stacks]
    return (lambda: forward(x, cast, fs.to(dtype), fb.to(dtype)),
            lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True))


def encoder_chained_fwd(x, mask, seeds, stacks, fs, fb, h, p):
    """B10's function through the chained B1/B2 kernels on the routes the
    encoder takes with the switch off (``attention_block.route``,
    ``ffn_block.route``: B10's routes, whose tile bodies it runs), the final
    LayerNorm in torch ops: (y, the state ``encoder_chained_bwd`` reads)."""
    from allrank_tpu_torch.models.core import std_layer_norm
    from allrank_tpu_torch.ops import attention_block as b1
    from allrank_tpu_torch.ops import ffn_block as b2

    ways = (b1.route(x.dtype, x.shape[-1], h),
            b2.route(x.dtype, x.shape[-1], stacks[8].shape[-1]))
    inputs, saved = [], []
    for n in range(stacks[0].shape[0]):
        w = [t[n] for t in stacks]
        inputs.append(x)
        x, sv = b1.launch_fwd(ways[0], x, mask, *w[:6], h, p, p,
                              seeds[4 * n:4 * n + 2], return_saved=True)
        saved.append(sv)
        inputs.append(x)
        x = b2.launch_fwd(ways[1], x, *w[6:], p, p,
                          seeds[4 * n + 2:4 * n + 4])
    return std_layer_norm(x, fs, fb), (inputs, saved, x, ways)


def encoder_chained_bwd(state, mask, seeds, stacks, fs, dy, h, p):
    """The backward of ``encoder_chained_fwd`` through the B1/B2 backward
    kernels on the forward's routes: (dx, *12 stacked gradients, dfs, dfb),
    as B10's."""
    from allrank_tpu_torch.ops import attention_block as b1
    from allrank_tpu_torch.ops import ffn_block as b2

    inputs, saved, z, ways = state
    n_blocks = stacks[0].shape[0]
    dz, dfs, dfb = b1.ln_backward(z.float(), fs, dy.float())
    g = dz.to(z.dtype)
    grads = [[None] * n_blocks for _ in range(12)]
    for n in reversed(range(n_blocks)):
        w = [t[n] for t in stacks]
        g, *ffn = b2.launch_bwd(ways[1], inputs[2 * n + 1], *w[6:], g, p, p,
                                seeds[4 * n + 2:4 * n + 4])
        g, *attn = b1.launch_bwd(ways[0], inputs[2 * n], mask, *w[:6], g, h,
                                 p, p, seeds[4 * n:4 * n + 2],
                                 saved=saved[n])
        for i, t in enumerate(attn + ffn):
            grads[i][n] = t
    return (g, *(torch.stack(t) for t in grads), dfs, dfb)


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


def x2_inputs(gen, b, l, dev, d=D, d3=D3):
    """x [B, L, d], pre [B, L, d3], W1 [d, d3], W2 [d3, d] and the next
    kernel's W1', bf16, at the JAX probe's scales."""
    def r(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to(
            torch.bfloat16).to(dev)

    return (r(b, l, d, scale=0.5), r(b, l, d3, scale=0.5),
            r(d, d3, scale=0.05), r(d3, d, scale=0.05),
            r(d, d3, scale=0.05))


def x3_inputs(gen, b, l, d, dev):
    """x [B, L, d] bf16, the key mask (slate 0 fully padded, the others
    ragged) and B1's fp32 parameters, rounded to bf16 values."""
    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    lengths = torch.randint(1, l + 1, (b,), generator=gen)
    lengths[0] = 0
    mask = torch.arange(l)[None, :] >= lengths[:, None]
    params = [1 + r(d, scale=0.1), r(d, scale=0.1),
              r(d, 3 * d, scale=d ** -0.5), r(3 * d, scale=0.1),
              r(d, d, scale=d ** -0.5), r(d, scale=0.1)]
    return ([r(b, l, d).to(torch.bfloat16).to(dev), mask.to(dev)]
            + [p.to(torch.bfloat16).float().to(dev) for p in params])


def library_args(args, h):
    """``b1_library``'s arguments for B1's: the additive key mask and the
    parameters in bf16."""
    x, mask = args[:2]
    mask_add = torch.zeros(x.shape[0], 1, 1, x.shape[1], dtype=x.dtype,
                           device=x.device).masked_fill(
        mask[:, None, None, :], -1e9)
    return [x, mask_add] + [p.to(torch.bfloat16) for p in args[2:]] + [h]


def _route(module, *args) -> str:
    """The module's route for ``args``; an older checkout's module, which
    has no route, runs its SIMT kernels alone."""
    return module.route(*args) if hasattr(module, "route") else "simt"


def time_probes(card: str, package: str, iters: int, long: bool) -> list:
    """X2's and X3's lines (``--probes``)."""
    from allrank_tpu_torch.ops import attention_block as b1
    from allrank_tpu_torch.ops import attention_variants as x3
    from allrank_tpu_torch.ops import boundary_shift as x2
    from allrank_tpu_torch.tools.timing import _median_event_ms, graph_ms

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    lines = []

    def line(kernel, shape, fn, lib_fn, **extra):
        lines.append({
            "kernel": kernel, "shape": shape,
            "ms": _median_event_ms(fn, iters, 3), "graph_ms": graph_ms(fn),
            "library_ms": (None if lib_fn is None
                           else _median_event_ms(lib_fn, iters, 3)),
            "library_device_ms": None if lib_fn is None else graph_ms(lib_fn),
            **extra, "card": card, "package": package})
        print(json.dumps(lines[-1]), flush=True)

    x, pre, w1, w2, w1n = x2_inputs(gen, B, L, dev)
    line("boundary_plain", [B, L, D, D3], lambda: x2.boundary_plain(x, w1, w2),
         lambda: x2_library(x, pre, w1, w2, False))
    line("boundary_shift", [B, L, D, D3],
         lambda: x2.boundary_shift(x, pre, w2, w1n),
         lambda: x2_library(x, pre, w1n, w2, True))
    del x, pre, w1, w2, w1n
    for b, l in [(B, L)] + ([LONG] if long else []):
        a = x3_inputs(gen, b, l, D, dev)
        lib = library_args(a, H)
        for mode in x3.MODES:
            line(f"attention_variant_{mode}", [b, l, D, H],
                 lambda m=mode: x3.attention_variant_fwd(*a, H, mode=m),
                 (lambda: b1_library(*lib)) if mode == "full" else None,
                 route=_route(x3, D, H))
        line("attention_sublayer_fwd", [b, l, D, H],
             lambda: b1.attention_sublayer_fwd(*a, H), None,
             route=_route(b1, torch.bfloat16, D, H))
        del a, lib
        torch.cuda.empty_cache()
    return lines


def pair_inputs(gen, b, k, dev, tail: int = 40):
    """B3's and B6's inputs: labels 0-4, the last ``tail`` documents
    padding (``bench.py``'s 40; the long-slate steps' 100), gains (2^label
    - 1) / 30."""
    ts = torch.randint(0, 5, (b, k), generator=gen).float()
    valid = torch.ones(b, k)
    valid[:, -tail:] = 0.0
    yp = torch.randn(b, k, generator=gen) * valid
    return [t.to(dev) for t in (yp, ts, (2.0 ** ts - 1.0) / 30.0, valid)]


def soft_sort_inputs(gen, n, l, dev):
    """B8's inputs: scores, 0/1 pad floats (ragged lengths, slate 0 full),
    power-of-two gains, an output cotangent."""
    s = torch.randn(n, l, generator=gen)
    lengths = torch.randint(1, l + 1, (n,), generator=gen)
    lengths[0] = l
    pad = (torch.arange(l)[None, :] >= lengths[:, None]).float()
    labels = torch.randint(0, 5, (n, l), generator=gen).float()
    vec = (2.0 ** labels - 1.0) * (1.0 - pad)
    return [t.to(dev) for t in (s, pad, vec, torch.randn(n, l,
                                                          generator=gen))]


def recipe_step(dev, config: str = NEURAL_CONFIG):
    """A recipe's train step (``config`` as written; the NeuralNDCG and
    approxNDCG recipes: 2 blocks of d=96, h=1, dropout 0.1, bf16, Adam) on
    seeded weights, and ``flagship_step``'s batch of B=64, L=240."""
    from allrank_tpu_torch.config import Config
    from allrank_tpu_torch.losses import get_loss
    from allrank_tpu_torch.models.factory import LTRModel, make_model
    from allrank_tpu_torch.training import make_optimizer, make_train_step

    cfg = Config.from_json(config)
    model = LTRModel(make_model(cfg.model, FEATURES),
                     torch.Generator().manual_seed(0), device=dev)
    loss_fn, needs_rng = get_loss(cfg.loss.name)
    step = make_train_step(
        model, loss_fn, cfg.loss.args, needs_rng,
        make_optimizer(cfg.optimizer.name, dict(cfg.optimizer.args),
                       model.parameters()),
        cfg.training.gradient_clipping_norm, cfg.training.compute_dtype,
        generator=torch.Generator().manual_seed(1))
    return step, flagship_step(dev)[1]


def long_neural_batch(dev, b: int = 8, l: int = 640):
    """A batch past B8's 512 documents for the NeuralNDCG step, where the
    loss runs the Sinkhorn kernel B7: seeded features and labels 0-4, the
    last 100 documents padding."""
    import numpy as np

    rng = np.random.RandomState(7)
    x = rng.randn(b, l, FEATURES).astype(np.float32)
    y = rng.randint(0, 5, (b, l)).astype(np.float32)
    indices = np.tile(np.arange(l), (b, 1))
    y[:, -100:] = -1.0
    indices[:, -100:] = -1
    return tuple(torch.as_tensor(t, device=dev) for t in (x, y, indices))


def approx_inputs(gen, b, l, dev, n_valid):
    """B9's inputs as the approxNDCG loss hands them over: scores, 0/1
    validity with the first ``n_valid`` documents of each slate valid (the
    loss sorts the padding last) and padded scores zeroed, a cotangent."""
    valid = torch.zeros(b, l)
    valid[:, :n_valid] = 1.0
    s = torch.randn(b, l, generator=gen) * valid
    return [t.to(dev) for t in (s, valid, torch.randn(b, l, generator=gen))]


def time_approx(card: str, package: str, iters: int) -> list:
    """B9's lines (``ops/approx_pos.py``), forward and backward, as device
    time beside ``chip_smoke.approx_library`` and the bound of
    ``chip_smoke.approx_work``: at B=64, L=240 with 200 valid documents
    (the approxNDCG recipe's step), and every document valid at (16, 1024),
    (2, 4096) and (2, 8192) where the checkout's kernel covers it."""
    import chip_smoke
    from allrank_tpu_torch.ops import approx_pos as b9
    from allrank_tpu_torch.tools.timing import (
        _median_event_ms,
        graph_ms,
        kernel_ms,
    )

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    lines = []
    eps = 1e-10
    for b, l, n_valid in ((B, L, 200), (16, 1024, 1024), (2, 4096, 4096),
                          (2, 8192, 8192)):
        if l > b9.MAX_LENGTH:
            continue
        s, valid, u = approx_inputs(gen, b, l, dev, n_valid)
        lib = chip_smoke.approx_library(s, valid, 1.0, eps)
        for way, fn in (
                ("approx_pos_fwd",
                 functools.partial(b9.approx_pos_fwd, s, valid, 1.0, eps)),
                ("approx_pos_bwd",
                 functools.partial(b9.approx_pos_bwd, s, valid, u, 1.0,
                                   eps))):
            backward = way.endswith("_bwd")
            lib_fn = lib[backward]
            # the parent's chip_smoke has no approx_work: no bound there
            work = (chip_smoke.approx_work(valid, backward)
                    if hasattr(chip_smoke, "approx_work") else None)
            lines.append({
                "kernel": way, "shape": [b, l], "valid": n_valid,
                "graph_ms": graph_ms(fn), "ms": _median_event_ms(fn, iters, 3),
                "library_device_ms": (sum(kernel_ms(lib_fn).values())
                                      if backward else graph_ms(lib_fn)),
                "library_ms": _median_event_ms(lib_fn, iters, 3),
                "bound_ms": (chip_smoke.bound(work[0], work[1],
                                              torch.float32)[0]
                             if work else None),
                "pairs": work[2] if work else None, "card": card,
                "package": package})
            print(json.dumps(lines[-1]), flush=True)
        del s, valid, u, lib
        torch.cuda.empty_cache()
    return lines


def time_losses(card: str, package: str, iters: int) -> list:
    """``--losses``' lines: B9, B3, B6, B8 and B7 by route and X4 as device
    time beside their libraries, and the busy time of the NeuralNDCG recipe
    step (B8's and B7's shares of it at L=240 and L=640) and of the
    approxNDCG recipe step (B9's share)."""
    import chip_smoke
    from allrank_tpu_torch.ops import lambda_pairs as b3
    from allrank_tpu_torch.ops import lambda_tiled as b6
    from allrank_tpu_torch.ops import neuralsort as b8
    from allrank_tpu_torch.ops import neuralsort_layout as x4
    from allrank_tpu_torch.ops import sinkhorn as b7
    from allrank_tpu_torch.tools.timing import (
        _median_event_ms,
        graph_ms,
        kernel_ms,
    )

    lines = time_approx(card, package, iters)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)

    def line(kernel, shape, fn, lib_fn, backward, **extra):
        lines.append({
            "kernel": kernel, "shape": shape, "graph_ms": graph_ms(fn),
            "ms": _median_event_ms(fn, iters, 3),
            "library_device_ms": (sum(kernel_ms(lib_fn).values()) if backward
                                  else graph_ms(lib_fn)),
            "library_ms": _median_event_ms(lib_fn, iters, 3),
            **extra, "card": card, "package": package})
        print(json.dumps(lines[-1]), flush=True)

    def chain_bound(args, kw, backward):
        # chip_smoke.chain_work's operations and bytes: 28 (forward) or 36
        # operations a selected pair, a compare for each other
        flops, moved, selected = chip_smoke.chain_work(
            args, kw, 36 if backward else 28, backward)
        return {"selected_pairs": selected,
                "bound_ms": chip_smoke.bound(flops, moved, torch.float32)[0]}

    args = pair_inputs(gen, B, L, dev)
    kw = dict(scheme="ndcgLoss2PP_scheme", k_eff=L, sigma=1.0, mu=10.0,
              log_base="binary", eps=1e-10)
    gout = torch.ones(B, device=dev)
    lib = chain_library(args, kw)
    blocks = (b3.cluster_size(L) if hasattr(b3, "cluster_size") else 1)
    line("lambda_pairs_fwd", [B, L], lambda: b3.lambda_pairs_fwd(*args, **kw),
         lib[0], False, cluster=blocks, **chain_bound(args, kw, False))
    line("lambda_pairs_bwd", [B, L],
         lambda: b3.lambda_pairs_bwd(*args, gout, **kw), lib[1], True,
         cluster=blocks, **chain_bound(args, kw, True))
    line("lambda_tiled_fwd", [B, L], lambda: b6.lambda_tiled_fwd(*args, **kw),
         lib[0], False, **chain_bound(args, kw, False))
    line("lambda_tiled_bwd", [B, L],
         lambda: b6.lambda_tiled_bwd(*args, gout, **kw), lib[1], True,
         **chain_bound(args, kw, True))
    del args, lib
    # B6 at its main paths' shapes: the long-slate lambdaLoss step's (16,
    # 1024) and the paper config's (8, 4096), a 100-document padding tail
    for b, k in (LONG, (8, 4096)):
        args = pair_inputs(gen, b, k, dev, tail=100)
        kw = dict(kw, k_eff=k)
        gout = torch.ones(b, device=dev)
        lib = chain_library(args, kw)
        line("lambda_tiled_fwd", [b, k],
             lambda: b6.lambda_tiled_fwd(*args, **kw), lib[0], False,
             **chain_bound(args, kw, False))
        line("lambda_tiled_bwd", [b, k],
             lambda: b6.lambda_tiled_bwd(*args, gout, **kw), lib[1], True,
             **chain_bound(args, kw, True))
        del args, lib
        torch.cuda.empty_cache()
    routes = b8.ROUTES if hasattr(b8, "launch_fwd") else ("l2",)
    for n, l in ((B, L), (4, 512)):
        s, pad, vec, dout = soft_sort_inputs(gen, n, l, dev)
        lib = soft_sort_library(s, pad, vec, False)
        for way in routes:
            if hasattr(b8, "launch_fwd"):
                fwd = functools.partial(b8.launch_fwd, way)
                bwd = functools.partial(b8.launch_bwd, way)
            else:
                fwd, bwd = b8.soft_sort_fwd, b8.soft_sort_bwd
            _, a_hist, b_hist = fwd(s, pad, vec, 1.0, 50, False)
            extra = ({"cluster": [b8.cluster_plan(l, bw)[0]
                                  for bw in (False, True)]}
                     if way == "cluster" else {})
            line("soft_sort_fwd", [n, l],
                 lambda: fwd(s, pad, vec, 1.0, 50, False), lib[0], False,
                 route=way, **extra)
            line("soft_sort_bwd", [n, l],
                 lambda: bwd(s, pad, vec, a_hist, b_hist, dout, 1.0, 50,
                             False), lib[1], True, route=way, **extra)
        del s, pad, vec, dout, lib
        torch.cuda.empty_cache()
    s, pad, vec, dout = soft_sort_inputs(gen, B, L, dev)
    lib = soft_sort_library(s, pad, vec, False)
    _, a_hist, b_hist = x4.layout_soft_sort_fwd(s, pad, vec, 1.0, 50, False)
    line("layout_soft_sort_fwd", [B, L],
         lambda: x4.layout_soft_sort_fwd(s, pad, vec, 1.0, 50, False),
         lib[0], False)
    line("layout_soft_sort_bwd", [B, L],
         lambda: x4.layout_soft_sort_bwd(s, pad, vec, a_hist, b_hist, dout,
                                         1.0, 50, False), lib[1], True)
    del s, pad, vec, dout, lib
    b7_routes = b7.ROUTES if hasattr(b7, "launch_fwd") else ("l2",)
    for n, l in ((8, 640), (2, 768)):
        m0 = premasked_matrices(gen, n, l, dev)
        dp = torch.randn(n, l, l, generator=gen).to(dev)
        lib = sinkhorn_library(m0)
        for way in b7_routes:
            if hasattr(b7, "launch_fwd"):
                fwd = functools.partial(b7.launch_fwd, way)
                bwd = functools.partial(b7.launch_bwd, way)
            else:
                fwd, bwd = b7.sinkhorn_fwd, b7.sinkhorn_bwd
            _, a_hist, b_hist = fwd(m0, 50)
            extra = ({"cluster": b7.cluster_plan(l, False)[0]}
                     if way == "cluster" else {})
            line("sinkhorn_fwd", [n, l], lambda: fwd(m0, 50), lib[0], False,
                 route=way, **extra)
            line("sinkhorn_bwd", [n, l],
                 lambda: bwd(m0, a_hist, b_hist, dp, 50), lib[1], True,
                 route=way, **extra)
        del m0, dp, lib
        torch.cuda.empty_cache()
    return lines + time_recipe_steps(card, package, iters)


def time_recipe_steps(card: str, package: str, iters: int) -> list:
    """``--losses``' step lines: the NeuralNDCG recipe's step at B=64, L=240
    and B=8, L=640 and the approxNDCG recipe's at B=64, L=240, each with
    its ms, the device's busy ms a step, its idle share, B8's, B7's and
    B9's shares of the busy time and the device time by kernel (each
    kernel of at least 1 % of it)."""
    from allrank_tpu_torch.tools.timing import (
        _median_event_ms,
        busy_us,
        trace_kernels,
    )

    dev = torch.device("cuda", 0)
    lines = []
    step, batch = recipe_step(dev)
    approx_step = recipe_step(dev, APPROX_CONFIG)[0]
    calls = 5
    for label, step, batch in (
            ("NeuralNDCG recipe (neuralndcg_atmax.json), bf16", step, batch),
            ("NeuralNDCG recipe (neuralndcg_atmax.json), bf16", step,
             long_neural_batch(dev)),
            ("approxNDCG recipe (approxndcg.json), bf16", approx_step,
             batch)):
        ms = _median_event_ms(lambda: step(*batch), iters, 3)
        spans, window_us = trace_kernels(lambda: step(*batch), calls)
        busy = busy_us(spans)
        share = {}
        for key, part in (("b8", "soft_sort"), ("b7", "sinkhorn"),
                          ("b9", "approx_")):
            us = sum(end - start for name, start, end in spans
                     if part in name)
            share.update({f"{key}_ms": us / calls / 1e3,
                          f"{key}_share": us / busy})
        by_kernel = {}
        for name, start, end in spans:
            by_kernel[name[:80]] = (by_kernel.get(name[:80], 0.0)
                                    + (end - start) / calls / 1e3)
        lines.append({
            "step": label, "shape": list(batch[1].shape), "ms": ms,
            "device_busy_ms": busy / calls / 1e3,
            "idle_share": 1 - busy / window_us, **share,
            "by_kernel_ms": {k: v for k, v in sorted(
                by_kernel.items(), key=lambda kv: -kv[1])
                if v * calls * 1e3 >= 0.01 * busy},
            "card": card, "package": package})
        print(json.dumps(lines[-1]), flush=True)
    return lines


def time_int8(card: str, package: str, iters: int) -> list:
    """``--int8``' lines: X1 (``ops/q8_dense.py``) at the six sites of the
    flagship int8 tower (``chip_smoke.Q8_SITES``: M = 15,360 rows, static
    mode, bf16 x, the head's fp32) as device time, with one event-timed
    call, beside its library (``chip_smoke.q8_library``: quantize ops,
    ``torch._int_mm``, epilogue; none where ``_int_mm`` refuses the shape)
    and the float layer's bf16 ``torch.matmul`` + bias, and its bound
    (``chip_smoke.q8_work``); then the sums over a scorer call's 18
    launches."""
    import chip_smoke
    from allrank_tpu_torch.ops.q8_dense import q8_dense
    from allrank_tpu_torch.tools.timing import _median_event_ms, graph_ms

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    lines = []
    for site, k, n, per_call in chip_smoke.Q8_SITES:
        dtype = torch.float32 if site == "output" else torch.bfloat16
        args = chip_smoke.q8_inputs(gen, B * L, k, n, dtype, "static", dev)
        x, w_t, _, _, inv = args
        wf = torch.randn(k, n, generator=gen).to(torch.bfloat16).to(dev)
        bf = torch.randn(n, generator=gen).to(torch.bfloat16).to(dev)
        x16 = x.to(torch.bfloat16)
        lib = chip_smoke.q8_library(*args)
        flops, moved = chip_smoke.q8_work(x, w_t, inv, dtype)

        def matmul():
            return torch.matmul(x16, wf) + bf

        lines.append({
            "kernel": "q8_dense", "site": site, "shape": [B * L, k, n],
            "dtype": str(dtype).split(".")[-1], "per_call": per_call,
            "graph_ms": graph_ms(lambda: q8_dense(*args)),
            "ms": _median_event_ms(lambda: q8_dense(*args), iters, 3),
            "library_device_ms": graph_ms(lib) if lib else None,
            "library_ms": _median_event_ms(lib, iters, 3) if lib else None,
            "bf16_matmul_device_ms": graph_ms(matmul),
            "bound_ms": chip_smoke.bound(flops, moved, torch.int8)[0],
            "card": card, "package": package})
        print(json.dumps(lines[-1]), flush=True)
    call = {"kernel": "q8_dense", "site": "per scorer call (18 launches)"}
    for key in ("graph_ms", "bound_ms", "bf16_matmul_device_ms"):
        call[key] = sum(v[key] * v["per_call"] for v in lines)
    call["library_device_ms_where_one"] = sum(
        v["library_device_ms"] * v["per_call"] for v in lines
        if v["library_device_ms"] is not None)
    lines.append({**call, "card": card, "package": package})
    print(json.dumps(lines[-1]), flush=True)
    return lines


def flagship_model(dev):
    """``bench.py``'s model (the flagship) of seeded random weights on
    ``dev``."""
    from allrank_tpu_torch.config import (
        FCConfig,
        ModelConfig,
        PositionalEncodingConfig,
        PostModelConfig,
        TransformerConfig,
    )
    from allrank_tpu_torch.models.factory import LTRModel, make_model

    mdef = make_model(ModelConfig(
        fc_model=FCConfig(sizes=[128], input_norm=True, activation="ReLU",
                          dropout=0.0),
        transformer=TransformerConfig(
            N=4, d_ff=D_FF, h=H, dropout=0.0,
            positional_encoding=PositionalEncodingConfig(
                strategy="fixed", max_indices=256)),
        post_model=PostModelConfig(d_output=1)), FEATURES)
    return LTRModel(mdef, torch.Generator().manual_seed(0), device=dev)


def flagship_step(dev, dtype: str = "bfloat16", model=None):
    """``bench.py``'s train step in ``dtype`` on ``model`` (by default
    ``flagship_model``), and its batch: (step, (x, y, indices))."""
    import numpy as np

    from allrank_tpu_torch.losses import get_loss
    from allrank_tpu_torch.training import make_optimizer, make_train_step

    model = flagship_model(dev) if model is None else model
    loss_fn, needs_rng = get_loss("lambdaLoss")
    step = make_train_step(
        model, loss_fn, {"weighing_scheme": "ndcgLoss2PP_scheme", "mu": 10.0},
        needs_rng, make_optimizer("Adam", {"lr": 1e-3}, model.parameters()),
        None, dtype)
    rng = np.random.RandomState(0)
    x = rng.randn(B, L, FEATURES).astype(np.float32)
    y = np.clip(np.round(2.0 + x[..., 0] + 0.5 * rng.randn(B, L)), 0,
                4).astype(np.float32)
    indices = np.tile(np.arange(L), (B, 1))
    y[:, -40:] = -1.0
    indices[:, -40:] = -1
    return step, tuple(torch.as_tensor(t, device=dev)
                       for t in (x, y, indices))


def time_step(card: str, package: str, iters: int, dtype: str) -> dict:
    """``--step``'s line in ``dtype``: the flagship step's ms, device busy
    ms a step, idle share and device ms a step by kernel (the ten largest),
    and the flagship scorer's ms a call (CUDA events) on the same model."""
    from allrank_tpu_torch.serving import make_scorer
    from allrank_tpu_torch.tools.timing import (
        _median_event_ms,
        busy_us,
        trace_kernels,
    )

    dev = torch.device("cuda", 0)
    model = flagship_model(dev)
    step, batch = flagship_step(dev, dtype, model)
    calls = 5
    ms = _median_event_ms(lambda: step(*batch), iters, 3)
    spans, window_us = trace_kernels(lambda: step(*batch), calls)
    # the scorer last: make_scorer puts the model in eval mode
    scorer = make_scorer(model, dtype)
    lengths = (batch[2] >= 0).sum(dim=1)
    scorer_ms = _median_event_ms(lambda: scorer(batch[0], lengths), iters, 3)
    by_name = {}
    for name, start, end in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / calls / 1e3
    busy = busy_us(spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"step": f"bench.py config, flagship, {dtype}", "shape": [B, L],
            "ms": ms, "device_busy_ms": busy / calls / 1e3,
            "idle_share": 1 - busy / window_us,
            "by_kernel_ms": {k[:80]: v for k, v in top},
            "scorer_ms": scorer_ms, "card": card, "package": package}


def encoder_flops(backward: bool, n: int = 4) -> float:
    """The products of B10's function at the flagship, each counted once
    (a backward's replay of the forward is a cost of a design, not of the
    function): forward 2 M d 3d + 4 B h L^2 d_k + 2 M d^2 + 4 M d d_ff,
    backward 16 M d^2 + 12 B h L^2 d_k + 10 M d d_ff a block, M = B L."""
    m, dk = B * L, D // H
    if backward:
        return n * (16 * m * D * D + 12 * B * H * L * L * dk
                    + 10 * m * D * D_FF)
    return n * (2 * m * D * 3 * D + 4 * B * H * L * L * dk + 2 * m * D * D
                + 4 * m * D * D_FF)


def time_encoder(card: str, package: str) -> list:
    """``--encoder``'s lines: B10 at the flagship in fp32 and bf16, forward
    and backward, beside the chain on its routes and the library chain, as
    device time (ms)."""
    import inspect

    from allrank_tpu_torch.ops import attention_block as b1
    from allrank_tpu_torch.ops import encoder_block as b10
    from allrank_tpu_torch.ops import ffn_block as b2
    from allrank_tpu_torch.tools.timing import graph_ms, kernel_ms

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    n = 4
    parks = "return_saved" in inspect.signature(
        b10.encoder_block_fwd).parameters
    lines = []
    for dtype in (torch.float32, torch.bfloat16):
        x, mask, ap, fp, dy = inputs(gen, dtype, dev)
        stacks = [torch.stack([t * (1 + 0.1 * i) for i in range(n)])
                  for t in ap + fp]
        fs, fb = 1 + 0.1 * torch.randn(D, generator=gen).to(dev), torch.zeros(
            D, device=dev)
        seeds = tuple(range(300, 300 + 4 * n))
        args = (x, mask, seeds, stacks, fs, fb)
        _, state = encoder_chained_fwd(*args, H, 0.0)
        lib = encoder_library(x, mask, stacks, fs, fb, dy, H)

        def b10_ms(fn):
            return sum(ms for name, ms in kernel_ms(fn).items()
                       if "encoder_" in name)

        fwd = {"b10": b10_ms(lambda: b10.encoder_block_fwd(*args, h=H)),
               "chained": graph_ms(lambda: encoder_chained_fwd(*args, H,
                                                               0.0)),
               "library": graph_ms(lib[0])}
        bwd = {"b10_replay": b10_ms(lambda: b10.encoder_block_bwd(
                   *args, dy, h=H)),
               "chained": graph_ms(lambda: encoder_chained_bwd(
                   state, mask, seeds, stacks, fs, dy, H, 0.0)),
               "library": sum(kernel_ms(lib[1]).values())}
        if parks:
            fwd["b10_parked"] = b10_ms(lambda: b10.encoder_block_fwd(
                *args, h=H, return_saved=True))
            _, saved = b10.encoder_block_fwd(*args, h=H, return_saved=True)
            bwd["b10"] = b10_ms(lambda: b10.encoder_block_bwd(
                *args, dy, h=H, saved=saved))
            del saved
        rate = 495e12 / 3 if dtype == torch.float32 else 989e12
        routes = "/".join((b1.route(dtype, D, H), b2.route(dtype, D, D_FF)))
        for direction, times in (("fwd", fwd), ("bwd", bwd)):
            lines.append({
                "kernel": f"encoder_block_{direction}",
                "shape": [B, L, D, H, D_FF, n],
                "dtype": str(dtype).split(".")[-1], "routes": routes,
                "device_ms": times,
                "bound_ms": encoder_flops(direction == "bwd", n) / rate * 1e3,
                "card": card, "package": package})
        del state, lib, stacks
        torch.cuda.empty_cache()
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--ptxas", nargs="*", default=())
    parser.add_argument("--profile", action="store_true",
                        help="also each kernel's device time by name")
    parser.add_argument("--step", action="store_true",
                        help="time bench.py's train step instead")
    parser.add_argument("--encoder", action="store_true",
                        help="time the whole-encoder kernel pair instead")
    parser.add_argument("--probes", action="store_true",
                        help="time the probe kernels X2 and X3 instead")
    parser.add_argument("--long", action="store_true",
                        help="with --probes, also X3 and B1 at B=16, "
                             "L=1024")
    parser.add_argument("--losses", action="store_true",
                        help="time the loss kernels B9, B3, B6, B8, B7 and "
                             "X4 and the NeuralNDCG and approxNDCG recipe "
                             "steps instead")
    parser.add_argument("--int8", action="store_true",
                        help="time the int8 dense kernel X1 at the flagship "
                             "int8 tower's six sites instead")
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
                           "attention_block_tf32x3", "ffn_block",
                           "ffn_block_mma", "ffn_block_tf32x3",
                           *(("encoder_block",
                              *(f"encoder_block_{dt}_dk32"
                                for dt in ("bf16", "f32")))
                             if args.encoder else ()),
                           *(("boundary_shift", "boundary_shift_mma",
                              "attention_variants",
                              *(f"attention_variants_mma_{m}" for m in (
                                  "full", "no_softmax", "norm_after_pv",
                                  "no_pv", "frame")))
                             if args.probes else ()),
                           *(("approx_pos", "lambda_pairs", "lambda_tiled",
                              "neuralsort", "neuralsort_cluster",
                              "neuralsort_layout", "sinkhorn",
                              "sinkhorn_cluster")
                             if args.losses else ()),
                           *(("q8_dense",) if args.int8 else ()),
                           *args.ptxas)
               if os.path.exists(_build.source_path(s))]
    _build.build(sorted(set(sources)))
    for source in args.ptxas:
        for name, line in ptxas_lines(source):
            print(f"ptxas {source} {name}: {line}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.encoder:
        for line in time_encoder(card, package):
            print(json.dumps(line), flush=True)
        return 0
    if args.probes:
        time_probes(card, package, args.iters, args.long)
        return 0
    if args.losses:
        time_losses(card, package, args.iters)
        return 0
    if args.int8:
        time_int8(card, package, args.iters)
        return 0
    if args.step:
        for dtype in ("float32", "bfloat16"):
            print(json.dumps(time_step(card, package, args.iters, dtype)),
                  flush=True)
        return 0
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        x, mask, ap, fp, dy = inputs(gen, dtype, dev)
        _, saved = b1.attention_sublayer_fwd(x, mask, *ap, H,
                                             return_saved=True)
        routes = {"attention": _route(b1, dtype, D, H),
                  "ffn": _route(b2, dtype, D, D_FF)}
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
