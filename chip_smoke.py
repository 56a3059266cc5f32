#!/usr/bin/env python3
"""On-GPU smoke run of the PyTorch/CUDA port, ``allrank_tpu_torch``.

Run from the root of a checkout on a machine with one NVIDIA H100 (the
kernels are built for sm_90a):

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and never prints its last line):

1. the card, torch and CUDA versions; builds the three kernel sources of
   ``allrank_tpu_torch/csrc`` with nvcc (one process per source, in
   parallel) and prints the seconds it took; turns TF32 off;
2. the attention sublayer kernel (B1) against its plain PyTorch version at
   B=64, L=240 for (d, h) = (128, 4), (144, 2), (96, 1), with ragged
   lengths and one lengths=0 slate, in fp32 and bf16, plus edge shapes;
3. the FFN sublayer kernel (B2) likewise, d_ff 512 and 384;
4. the flagship ranker (136 features, FC [128], 4 blocks of d=128, h=4,
   d_ff=512, random weights from a seeded ``torch.Generator``) through
   ``make_scorer``/``make_ranker`` on the GPU against the same model's
   plain run with ``device="cpu"``; bf16 against fp32;
5. ``SlateScoringService`` with buckets (1, 8, 64) behind ``run_server``
   on a free localhost port, answering concurrent JSON and ``.npy``
   requests, checked against direct scorer calls; this is the main path
   whose kernel launches are counted (the counters are set to 0 just
   before the requests and read just after);
6. times (CUDA events after warm-up, medians): each kernel, its plain
   version and a PyTorch library yardstick at the flagship serving shape,
   the scorer's slates/s with its device time by kernel and idle share
   (torch.profiler), the service's p50 request latency;
7. the B1 and B2 backward kernels against their plain versions (and the
   forwards at dropout 0.3), at the flagship widths and the edge shapes of
   phases 2-3, dropout 0 and 0.3, fp32 and bf16, with bit-identical masks;
8. the lambdaLoss pair-chain kernels (B3, forward and backward) against
   their plain versions: every weighing scheme, k = all or 10,
   L in {1, 240, 384}, a dummy slate;
9. the train step, the second main path: the paper config
   (``reproducibility/configs/contextaware_web30k/ndcgloss2pp.json``:
   136 features, dropout 0.3, bf16, Adam at 1e-3, lambdaLoss with
   ndcgLoss2PP) for 20 steps through ``make_train_step`` on a fixed
   synthetic batch of B=64, L=240 with a 40-document padding tail; every
   loss finite, the last 5 below the first 5, and per step 4 + 4 launches
   of each sublayer kernel's forward and backward and 1 + 1 of B3 (the
   counters are set to 0 just before the steps and read just after); at
   dropout 0 in fp32, step 1's loss and gradients on the GPU against the
   same model's plain run on the CPU;
10. times: the train step at ``bench.py``'s configuration (the flagship
    model, dropout 0, bf16) and at the paper config, with its idle share
    and device time by kernel; each new kernel, its plain version and a
    library yardstick;
11. a ``{"kernels": [...]}`` JSON line, the card's name and power limit as
    nvidia-smi reports them, and last ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import concurrent.futures
import copy
import io
import json
import math
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

B, L, N_FEATURES = 64, 240, 136  # the flagship serving shape
PAPER_WIDTHS = [(128, 4), (144, 2), (96, 1)]  # (d_model, h)
# H100 SXM published peaks (dense): fp32 on the SIMT units, bf16 on the
# tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
MEM_BYTES_PER_S = 3.35e12
# kernel vs plain version on the same inputs:
#  fp32: the same fp32 FMAs summed in another order;
#  bf16: the same rounding points, where an fp32 sum that lands on the
#        other side of a rounding edge moves y by one or two bf16 ulps
#        (2^-7 relative at most each)
KERNEL_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
              torch.bfloat16: dict(rtol=2 ** -6, atol=2 ** -6)}
# backward kernel vs plain version, per gradient tensor, relative to the
# tensor's largest value: fp32 sums taken in another order; bf16 at the
# same rounding points, where an fp32 sum on the other side of a rounding
# edge moves one bf16 intermediate by an ulp and a weight gradient summed
# over it a little
BWD_TOL = {torch.float32: (1e-4, 1e-6), torch.bfloat16: (2 ** -5, 1e-6)}
# B3 against its plain version: the JAX package's own tolerances for the
# loss sums; the gradient sum_j c_ij - sum_j c_ji is two fp32 sums of up
# to 2k terms whose difference may be far smaller than either, so its
# absolute part scales with the largest gradient
B3_VALUE_TOL = dict(rtol=2e-5, atol=1e-5)
B3_GRAD_RTOL, B3_GRAD_ATOL = 1e-4, 1e-5
# train step 1, GPU kernels vs the CPU plain run, fp32 through 4 blocks
# forward and backward: loss relative, each gradient relative to its own
# largest value plus 1e-5 of the largest gradient of all (a gradient that
# is zero in exact arithmetic, the output bias, is fp32 noise)
STEP_LOSS_RTOL, STEP_GRAD_TOL = 1e-4, 1e-3
# flagship scores, GPU kernels vs the CPU plain run, fp32 through 4 blocks
SCORE_TOL = 1e-3
# flagship scores, bf16 vs fp32 on the GPU: bf16 keeps 8 mantissa bits and
# rounds at every sublayer of 4 blocks; relative to the largest |score|
BF16_SCORE_TOL = 0.05


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def median_ms(fn, iters: int = 40, warmup: int = 5) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_mem = nbytes / MEM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def attn_inputs(gen, b, l, d, dtype, dev):
    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    lengths = torch.randint(1, l + 1, (b,), generator=gen)
    lengths[0] = 0  # a fully padded slate
    mask = torch.arange(l)[None, :] >= lengths[:, None]
    params = [1 + r(d, scale=0.1), r(d, scale=0.1),
              r(d, 3 * d, scale=d ** -0.5), r(3 * d, scale=0.1),
              r(d, d, scale=d ** -0.5), r(d, scale=0.1)]
    return ([r(b, l, d).to(dtype).to(dev), mask.to(dev)]
            + [p.to(dev) for p in params])


def ffn_inputs(gen, b, l, d, d_ff, dtype, dev):
    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    params = [1 + r(d, scale=0.1), r(d, scale=0.1),
              r(d, d_ff, scale=d ** -0.5), r(d_ff, scale=0.1),
              r(d_ff, d, scale=d_ff ** -0.5), r(d, scale=0.1)]
    return [r(b, l, d).to(dtype).to(dev)] + [p.to(dev) for p in params]


def check_kernel(name, kernel, plain, args, kwargs, dtype) -> float:
    """One launch against the plain version on the same inputs; returns the
    max abs error."""
    before = kernel.launches
    y = kernel(*args, **kwargs)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1, f"{name}: the kernel did not launch"
    ref = plain(*args, **kwargs)
    assert y.dtype == ref.dtype and y.shape == ref.shape
    assert torch.isfinite(y.float()).all(), f"{name}: non-finite output"
    torch.testing.assert_close(y.float(), ref.float(), **KERNEL_TOL[dtype])
    return (y.float() - ref.float()).abs().max().item()


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


def flagship_model(dev, dropout=0.0):
    """``__graft_entry__._flagship_mdef`` (the model ``bench.py`` trains)
    rebuilt in the port, random weights from a seeded generator."""
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
            N=4, d_ff=512, h=4, dropout=dropout,
            positional_encoding=PositionalEncodingConfig(
                strategy="fixed", max_indices=256)),
        post_model=PostModelConfig(d_output=1)), N_FEATURES)
    return LTRModel(mdef, torch.Generator().manual_seed(0), device=dev)


PAPER_CONFIG = "reproducibility/configs/contextaware_web30k/ndcgloss2pp.json"


def paper_setup(dev, dropout=None):
    """The paper config's model (random weights from a seeded generator),
    loss and optimizer settings; ``dropout`` overrides the config's 0.3."""
    from allrank_tpu_torch.config import Config
    from allrank_tpu_torch.models.factory import LTRModel, make_model

    cfg = Config.from_json(PAPER_CONFIG)
    if dropout is not None:
        cfg.model.transformer.dropout = dropout
    model = LTRModel(make_model(cfg.model, N_FEATURES),
                     torch.Generator().manual_seed(0), device=dev)
    return cfg, model


def train_batch(dev, seed=0):
    """B=64 slates of L=240 WEB30K-shaped documents with a 40-document
    padding tail (``bench.py``'s batch); labels 0-4 follow two features
    plus noise, so a few steps can lower the loss."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, L, N_FEATURES).astype(np.float32)
    y = np.clip(np.round(2.0 + x[..., 0] + 0.5 * x[..., 1]
                         + 0.5 * rng.randn(B, L)), 0, 4).astype(np.float32)
    indices = np.tile(np.arange(L), (B, 1))
    y[:, -40:] = -1.0
    indices[:, -40:] = -1
    return (torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev),
            torch.as_tensor(indices, device=dev))


def make_step(cfg, model, dtype, optimizer_name=None, lr=None):
    from allrank_tpu_torch.losses import get_loss
    from allrank_tpu_torch.training import make_optimizer, make_train_step

    loss_fn, needs_rng = get_loss(cfg.loss.name)
    args = dict(cfg.optimizer.args)
    if lr is not None:
        args["lr"] = lr
    opt = make_optimizer(optimizer_name or cfg.optimizer.name, args,
                         model.parameters())
    return make_train_step(model, loss_fn, cfg.loss.args, needs_rng, opt,
                           cfg.training.gradient_clipping_norm, dtype,
                           generator=torch.Generator().manual_seed(1))


def rel_err(got, ref) -> tuple:
    """(max abs error, max abs of the reference)."""
    return ((got.float() - ref.float()).abs().max().item(),
            ref.float().abs().max().item())


def b1_library_bwd(args, dy, h):
    """The backward of ``b1_library`` by autograd (SDPA's and matmul's own
    backward kernels): returns a function that runs it once."""
    xx, mask, g, bb, wqkv, bqkv, wout, bout = args
    dtype = xx.dtype
    leaves = [t.detach().to(dtype).requires_grad_()
              for t in (xx, g, bb, wqkv, bqkv, wout, bout)]
    mask_add = torch.zeros(xx.shape[0], 1, 1, xx.shape[1], dtype=dtype,
                           device=xx.device).masked_fill(
        mask[:, None, None, :], -1e9)
    out = b1_library(leaves[0], mask_add, *leaves[1:], h)
    return lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True)


def b2_library_bwd(args, dy):
    dtype = args[0].dtype
    leaves = [t.detach().to(dtype).requires_grad_() for t in args]
    out = b2_library(*leaves)
    return lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True)


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


def profile_calls(fn, tag: str, calls: int = 5) -> None:
    """Device time by kernel name over ``calls`` calls of ``fn``, and the
    device's idle share of that window (torch.profiler; prints "not
    measured" if the trace holds no device events)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"profile: no device events in the trace; idle share not "
              f"measured {tag}")
        return
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    busy += hi - lo
    print(f"profile: {calls} calls, host window {window_us / calls:.1f} us "
          f"per call, device busy {busy / calls:.1f} us per call, idle "
          f"share {1 - busy / window_us:.3f} {tag}")
    total = sum(by_name.values())
    for kname, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {us / calls:9.1f} us per call ({us / total:.3f} of device "
              f"time) {kname[:90]}")


def post(url: str, slate: np.ndarray, binary: bool) -> np.ndarray:
    if binary:
        buf = io.BytesIO()
        np.save(buf, slate)
        req = urllib.request.Request(
            url + "/score", data=buf.getvalue(),
            headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return np.load(io.BytesIO(r.read()), allow_pickle=False)
    req = urllib.request.Request(
        url + "/score", data=json.dumps({"slate": slate.tolist()}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return np.asarray(json.loads(r.read())["scores"], dtype=np.float32)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    from allrank_tpu_torch.ops import _build
    from allrank_tpu_torch.ops.attention_block import (
        attention_sublayer_bwd,
        attention_sublayer_bwd_plain,
        attention_sublayer_fwd,
        attention_sublayer_fwd_plain,
    )
    from allrank_tpu_torch.ops.ffn_block import (
        ffn_sublayer_bwd,
        ffn_sublayer_bwd_plain,
        ffn_sublayer_fwd,
        ffn_sublayer_fwd_plain,
    )
    from allrank_tpu_torch.ops.lambda_pairs import (
        SCHEMES,
        lambda_pairs_bwd,
        lambda_pairs_bwd_plain,
        lambda_pairs_fwd,
        lambda_pairs_fwd_plain,
    )
    from allrank_tpu_torch.serve_http import SlateScoringService, run_server
    from allrank_tpu_torch.serving import make_ranker, make_scorer

    dev = torch.device("cuda", 0)
    name_power = card()
    tag = f"[{name_power}]"
    kind = torch.cuda.get_device_name(0)

    # -- 1: card, versions, build --------------------------------------------
    print(f"card: {name_power}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    sources = ["attention_block", "ffn_block", "lambda_pairs"]
    _build.build(sources)
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, the three "
          f"sources in parallel)")
    for src in sources:
        with open(_build.log_path(src)) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"  {src}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(1234)
    errs = {}

    # -- 2: B1 against its plain version --------------------------------------
    cases = [(B, L, d, h) for d, h in PAPER_WIDTHS]
    cases += [(3, 1, 128, 4), (2, 1024, 144, 2), (5, 70, 256, 1)]
    for b, l, d, h in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = attn_inputs(gen, b, l, d, dtype, dev)
            err = check_kernel("attention_sublayer_fwd",
                               attention_sublayer_fwd,
                               attention_sublayer_fwd_plain, args + [h], {},
                               dtype)
            errs[("attn", b, l, d, dtype)] = err
            print(f"B1 vs plain B={b} L={l} d={d} h={h} {dtype}: "
                  f"max_abs_err {err:.3e} (tol {KERNEL_TOL[dtype]})")
    print("phase 2 ok: attention sublayer kernel matches its plain version")

    # -- 3: B2 against its plain version --------------------------------------
    cases = [(B, L, 128, 512), (B, L, 144, 512), (B, L, 96, 384),
             (B, L, 128, 384), (3, 1, 128, 512), (2, 1024, 256, 1024)]
    for b, l, d, d_ff in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = ffn_inputs(gen, b, l, d, d_ff, dtype, dev)
            err = check_kernel("ffn_sublayer_fwd", ffn_sublayer_fwd,
                               ffn_sublayer_fwd_plain, args, {}, dtype)
            errs[("ffn", b, l, d, d_ff, dtype)] = err
            print(f"B2 vs plain B={b} L={l} d={d} d_ff={d_ff} {dtype}: "
                  f"max_abs_err {err:.3e} (tol {KERNEL_TOL[dtype]})")
    print("phase 3 ok: FFN sublayer kernel matches its plain version")

    # -- 4: the flagship scorer and ranker -------------------------------------
    gpu_model = flagship_model(dev)
    cpu_model = copy.deepcopy(gpu_model).to("cpu")
    rng = np.random.RandomState(0)
    x = rng.randn(B, L, N_FEATURES).astype(np.float32)
    lengths = rng.randint(1, L + 1, size=B)
    lengths[5] = 0
    lengths[7] = L
    pad = np.arange(L)[None, :] >= lengths[:, None]
    scorer32 = make_scorer(gpu_model, "float32")
    scorer16 = make_scorer(gpu_model, "bfloat16")
    for scorer, label in ((scorer32, "fp32"), (scorer16, "bf16")):
        scorer(x, lengths)  # first call: loads the kernels
        attention_sublayer_fwd.launches = ffn_sublayer_fwd.launches = 0
        s = scorer(x, lengths)
        torch.cuda.synchronize()
        counts = (attention_sublayer_fwd.launches, ffn_sublayer_fwd.launches)
        assert counts == (4, 4), f"{label} scorer launches {counts} != (4, 4)"
    s32 = scorer32(x, lengths).cpu().numpy()
    s16 = scorer16(x, lengths).cpu().numpy()
    ref = make_scorer(cpu_model, "float32", device="cpu")(x, lengths).numpy()
    for s in (s32, s16):
        assert s.dtype == np.float32 and s.shape == (B, L)
        assert not np.isnan(s).any(), "NaN in scores"
        assert np.isneginf(s[pad]).all(), "padded positions must be -inf"
        assert np.isfinite(s[~pad]).all(), "non-finite score of a document"
    err32 = float(np.abs(s32[~pad] - ref[~pad]).max())
    assert err32 <= SCORE_TOL, f"GPU vs CPU scores: {err32} > {SCORE_TOL}"
    scale = float(np.abs(s32[~pad]).max())
    err16 = float(np.abs(s16[~pad] - s32[~pad]).max())
    assert err16 <= BF16_SCORE_TOL * scale, (
        f"bf16 vs fp32 scores: {err16} > {BF16_SCORE_TOL} * {scale}")
    order = make_ranker(gpu_model, "float32")(x, lengths).cpu().numpy()
    cpu_order = np.argsort(-ref, axis=-1, kind="stable")
    n_tie_swaps = 0
    for i in range(B):
        n = lengths[i]
        ranked = ref[i][order[i][:n]]
        # descending by the CPU scores, except inside ties within tolerance
        assert (np.diff(ranked) <= 2 * SCORE_TOL).all(), f"slate {i} order"
        assert sorted(order[i][n:]) == list(range(n, L)), "padding last"
        n_tie_swaps += int((order[i][:n] != cpu_order[i][:n]).sum())
    print(f"scorer fp32 GPU vs CPU plain: max_abs_err {err32:.3e} "
          f"(tol {SCORE_TOL}); bf16 vs fp32: {err16:.3e} (tol "
          f"{BF16_SCORE_TOL} x max|score| {scale:.3f}); ranker order equal "
          f"to the CPU's but for {n_tie_swaps} positions inside ties")
    print("phase 4 ok: flagship scorer and ranker on the GPU match the CPU")

    # -- 5: the service, the main path ------------------------------------------
    service = SlateScoringService(gpu_model, L, N_FEATURES, batch_size=64,
                                  max_wait_ms=5, compute_dtype="float32",
                                  batch_buckets=(1, 8, 64))
    server = run_server(service, 0, host="127.0.0.1")
    server_thread = threading.Thread(target=server.serve_forever, daemon=True)
    server_thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        slates = [rng.randn(n, N_FEATURES).astype(np.float32)
                  for n in (240, 1, 17, 64, 128, 199, 240, 5, 96, 233, 2,
                            150)]
        waves_before = service.stats()["waves_total"]
        attention_sublayer_fwd.launches = ffn_sublayer_fwd.launches = 0
        with concurrent.futures.ThreadPoolExecutor(len(slates)) as pool:
            futs = [pool.submit(post, url, s, i % 2 == 1)
                    for i, s in enumerate(slates)]
            answers = [f.result(timeout=120) for f in futs]
        main_launches = {"attention_sublayer_fwd":
                         attention_sublayer_fwd.launches,
                         "ffn_sublayer_fwd": ffn_sublayer_fwd.launches}
        with urllib.request.urlopen(url + "/statz", timeout=30) as r:
            stats = json.loads(r.read())
        waves = stats["waves_total"] - waves_before
        assert waves >= 1 and all(
            v == 4 * waves for v in main_launches.values()), (
            f"launches {main_launches} != 4 x {waves} waves")
        assert stats["requests_total"] == len(slates), stats
        assert sum(stats["waves_by_bucket"].values()) == stats["waves_total"]
        err_service = 0.0
        for s, got in zip(slates, answers):
            xb = np.zeros((1, L, N_FEATURES), dtype=np.float32)
            xb[0, : len(s)] = s
            direct = scorer32(xb, [len(s)]).cpu().numpy()[0, : len(s)]
            assert got.shape == (len(s),) and np.isfinite(got).all()
            np.testing.assert_allclose(got, direct, rtol=1e-4, atol=1e-4)
            err_service = max(err_service,
                              float(np.abs(got - direct).max()))
        print(f"service: {len(slates)} concurrent requests (JSON and .npy) "
              f"in {waves} waves {stats['waves_by_bucket']}, max_abs_err vs "
              f"direct scorer {err_service:.3e}; launches {main_launches}")
        one = rng.randn(L, N_FEATURES).astype(np.float32)
        lat = []
        for i in range(40):
            t = time.perf_counter()
            post(url, one, binary=True)
            if i >= 5:
                lat.append((time.perf_counter() - t) * 1e3)
        service_p50 = statistics.median(lat)
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    server_thread.join(timeout=10)
    print("phase 5 ok: service answers on the GPU and matches the scorer")

    # -- 6: times ------------------------------------------------------------
    d, h, d_ff = 128, 4, 512
    rows = []
    for kernel_name in ("attention_sublayer_fwd", "ffn_sublayer_fwd"):
        row = {"name": kernel_name, "route": "cuda"}
        for dtype in (torch.float32, torch.bfloat16):
            if kernel_name == "attention_sublayer_fwd":
                args = attn_inputs(gen, B, L, d, dtype, dev)
                xx, mask, g, bb, wqkv, bqkv, wout, bout = args
                lib_args = [xx, torch.zeros(B, 1, 1, L, dtype=dtype,
                                            device=dev).masked_fill(
                    mask[:, None, None, :], -1e9), g.to(dtype), bb.to(dtype),
                    wqkv.to(dtype), bqkv.to(dtype), wout.to(dtype),
                    bout.to(dtype), h]
                fns = (lambda: attention_sublayer_fwd(*args, h),
                       lambda: attention_sublayer_fwd_plain(*args, h),
                       lambda: b1_library(*lib_args))
                flops = (2 * B * L * d * 3 * d + 2 * 2 * B * h * L * L
                         * (d // h) + 2 * B * L * d * d)
                moved = 2 * nbytes(xx) + nbytes(*args[1:])
                err = errs[("attn", B, L, d, dtype)]
            else:
                args = ffn_inputs(gen, B, L, d, d_ff, dtype, dev)
                lib_args = [args[0]] + [p.to(dtype) for p in args[1:]]
                fns = (lambda: ffn_sublayer_fwd(*args),
                       lambda: ffn_sublayer_fwd_plain(*args),
                       lambda: b2_library(*lib_args))
                flops = 2 * 2 * B * L * d * d_ff
                moved = 2 * nbytes(args[0]) + nbytes(*args[1:])
                err = errs[("ffn", B, L, d, d_ff, dtype)]
            ms, plain_ms, lib_ms = (median_ms(fn) for fn in fns)
            bound_ms, bound_by = bound(flops, moved, dtype)
            sfx = "" if dtype == torch.float32 else "_bf16"
            row.update({f"max_abs_err{sfx}": err, f"ms{sfx}": ms,
                        f"plain_ms{sfx}": plain_ms,
                        f"bound_ms{sfx}": bound_ms,
                        f"bound_by{sfx}": bound_by,
                        f"library_ms{sfx}": lib_ms,
                        f"gflop{sfx}": flops / 1e9,
                        f"mbytes{sfx}": moved / 1e6})
            print(f"time {kernel_name} {dtype} B={B} L={L} d={d}: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                  f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
                  f"{flops / 1e9:.3f} GFLOP, {moved / 1e6:.2f} MB) {tag}")
        rows.append(row)
    xd = torch.as_tensor(x, device=dev)
    ld = torch.as_tensor(lengths, device=dev)
    for scorer, label in ((scorer32, "float32"), (scorer16, "bfloat16")):
        ms = median_ms(lambda: scorer(xd, ld), iters=20)
        print(f"time scorer {label} B={B} L={L}: {ms:.4f} ms per call, "
              f"{B / ms * 1e3:.1f} slates/s (input on the device) {tag}")
        profile_calls(lambda: scorer(xd, ld), f"scorer {label} {tag}")
    print(f"time service p50 request latency, one {L}-doc .npy slate, "
          f"fp32, buckets (1, 8, 64): {service_p50:.3f} ms {tag}")

    # -- 7: B1 and B2 backward against their plain versions -----------------
    bwd_errs = {}
    cases = [(B, L, 128, 4, 512), (3, 1, 128, 4, 512), (2, 1024, 144, 2, 512),
             (5, 70, 256, 1, 1024)]
    for b, l, d, h, d_ff in cases:
        for dtype in (torch.float32, torch.bfloat16):
            for p in (0.0, 0.3):
                seeds = (101, 202)
                a_args = attn_inputs(gen, b, l, d, dtype, dev)
                f_args = ffn_inputs(gen, b, l, d, d_ff, dtype, dev)
                dy = torch.randn(b, l, d, generator=gen).to(dtype).to(dev)
                y, saved = attention_sublayer_fwd(*a_args, h, p, p, seeds,
                                                  return_saved=True)
                torch.testing.assert_close(
                    y.float(), attention_sublayer_fwd_plain(
                        *a_args, h, p, p, seeds).float(), **KERNEL_TOL[dtype])
                z = ffn_sublayer_fwd(*f_args, p, p, seeds)
                torch.testing.assert_close(
                    z.float(), ffn_sublayer_fwd_plain(*f_args, p, p,
                                                      seeds).float(),
                    **KERNEL_TOL[dtype])
                worst, worst_rel = {}, {}
                for kname, got, ref in (
                        ("attention_sublayer_bwd",
                         attention_sublayer_bwd(*a_args, dy, h, p, p, seeds,
                                                saved=saved),
                         attention_sublayer_bwd_plain(*a_args, dy, h, p, p,
                                                      seeds)),
                        ("ffn_sublayer_bwd",
                         ffn_sublayer_bwd(*f_args, dy, p, p, seeds),
                         ffn_sublayer_bwd_plain(*f_args, dy, p, p, seeds))):
                    torch.cuda.synchronize()
                    rtol, atol = BWD_TOL[dtype]
                    for i, (g, r) in enumerate(zip(got, ref)):
                        assert torch.isfinite(g.float()).all(), (kname, i)
                        err, scale = rel_err(g, r)
                        assert err <= rtol * scale + atol, (
                            f"{kname} grad {i} B={b} L={l} d={d} {dtype} "
                            f"p={p}: {err} > {rtol} x {scale} + {atol}")
                        worst[kname] = max(worst.get(kname, 0.0), err)
                        worst_rel[kname] = max(worst_rel.get(kname, 0.0),
                                               err / (scale + atol))
                    bwd_errs[(kname, b, l, d, dtype, p)] = worst[kname]
                print(f"B1/B2 bwd vs plain B={b} L={l} d={d} h={h} "
                      f"d_ff={d_ff} {dtype} p={p}: max_abs_err "
                      f"{worst['attention_sublayer_bwd']:.3e} / "
                      f"{worst['ffn_sublayer_bwd']:.3e}, worst relative to "
                      f"its tensor's max|ref| "
                      f"{worst_rel['attention_sublayer_bwd']:.2e} / "
                      f"{worst_rel['ffn_sublayer_bwd']:.2e} (tol "
                      f"{BWD_TOL[dtype][0]:g})")
    print("phase 7 ok: B1 and B2 backward kernels (and the forwards at "
          "p=0.3) match their plain versions, masks bit-identical")

    # -- 8: B3 against its plain version -----------------------------------------
    b3_errs = {"lambda_pairs_fwd": 0.0, "lambda_pairs_bwd": 0.0}
    for l in (1, 240, 384):
        ts = torch.randint(0, 5, (B, l), generator=gen).float()
        valid = (torch.rand(B, l, generator=gen) > 0.15).float()
        valid[-1] = 0.0  # a dummy slate
        yp = torch.randn(B, l, generator=gen) * valid
        g = (2.0 ** ts - 1.0) / 30.0
        pair_args = [t.to(dev) for t in (yp, ts, g, valid)]
        gout = torch.linspace(0.5, 1.5, B, device=dev)
        for scheme in SCHEMES:
            for k in (None, 10):
                kw = dict(scheme=scheme, k_eff=l if k is None else min(k, l),
                          sigma=1.0, mu=10.0, log_base="binary", eps=1e-10)
                loss, cnt = lambda_pairs_fwd(*pair_args, **kw)
                ref_loss, ref_cnt = lambda_pairs_fwd_plain(*pair_args, **kw)
                assert torch.equal(cnt, ref_cnt), (scheme, k, l)
                torch.testing.assert_close(loss, ref_loss, **B3_VALUE_TOL)
                dyp = lambda_pairs_bwd(*pair_args, gout, **kw)
                ref_dyp = lambda_pairs_bwd_plain(*pair_args, gout, **kw)
                torch.testing.assert_close(
                    dyp, ref_dyp, rtol=B3_GRAD_RTOL,
                    atol=B3_GRAD_ATOL * ref_dyp.abs().max().item() + 1e-6)
                assert not dyp[-1].any(), "the dummy slate took a gradient"
                if l == L and k is None and scheme == "ndcgLoss2PP_scheme":
                    b3_errs["lambda_pairs_fwd"] = rel_err(loss, ref_loss)[0]
                    b3_errs["lambda_pairs_bwd"] = rel_err(dyp, ref_dyp)[0]
    print(f"B3 vs plain, 8 schemes x k in (all, 10) x L in (1, 240, 384): "
          f"ok; at L={L} ndcgLoss2PP max_abs_err loss "
          f"{b3_errs['lambda_pairs_fwd']:.3e}, grad "
          f"{b3_errs['lambda_pairs_bwd']:.3e}")
    print("phase 8 ok: lambdaLoss pair-chain kernels match their plain "
          "versions")

    # -- 9: the train step, the second main path ---------------------------------
    train_kernels = (attention_sublayer_fwd, attention_sublayer_bwd,
                     ffn_sublayer_fwd, ffn_sublayer_bwd, lambda_pairs_fwd,
                     lambda_pairs_bwd)
    per_step = (4, 4, 4, 4, 1, 1)
    cfg, model = paper_setup(dev)
    assert cfg.model.transformer.dropout == 0.3
    assert cfg.training.compute_dtype == "bfloat16"
    xb, yb, ib = train_batch(dev)
    step = make_step(cfg, model, cfg.training.compute_dtype)
    for k in train_kernels:
        k.launches = 0
    losses = []
    for i in range(20):
        before = [k.launches for k in train_kernels]
        loss, n_real = step(xb, yb, ib)
        losses.append(loss.item())
        got = tuple(k.launches - n for k, n in zip(train_kernels, before))
        assert got == per_step, f"step {i} launches {got} != {per_step}"
        assert math.isfinite(losses[-1]), f"step {i} loss {losses[-1]}"
    train_launches = {k.__name__: k.launches for k in train_kernels}
    assert list(train_launches.values()) == [20 * n for n in per_step]
    assert n_real.item() == B
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    assert last < first, f"loss did not fall: {first} -> {last}"
    print(f"train step, paper config (dropout 0.3, bf16, Adam 1e-3, "
          f"lambdaLoss ndcgLoss2PP), B={B} L={L}, 40-doc padding tail: 20 "
          f"steps, loss mean of the first 5 {first:.3f}, of the last 5 "
          f"{last:.3f}; launches {train_launches}")

    cfg0, gpu_model = paper_setup(dev, dropout=0.0)
    cpu_model = copy.deepcopy(gpu_model).to("cpu")
    batch_cpu = [t.cpu() for t in (xb, yb, ib)]
    results = []
    for m, batch in ((gpu_model, (xb, yb, ib)), (cpu_model, batch_cpu)):
        step = make_step(cfg0, m, "float32", optimizer_name="SGD", lr=0.0)
        loss, _ = step(*batch)
        results.append((loss.item(), {n: p.grad.float().cpu()
                                      for n, p in m.named_parameters()}))
    (gl, gg), (cl, cg) = results
    assert abs(gl - cl) <= STEP_LOSS_RTOL * abs(cl), (gl, cl)
    top = max(v.abs().max().item() for v in cg.values())
    step_err = 0.0
    for name, ref in cg.items():
        err, scale = rel_err(gg[name], ref)
        allowed = STEP_GRAD_TOL * scale + 1e-5 * top
        assert err <= allowed, (name, err, scale)
        step_err = max(step_err, err / allowed)
    print(f"train step 1 at dropout 0, fp32, GPU vs CPU plain: loss {gl:.6f} "
          f"vs {cl:.6f}; worst gradient error {step_err:.3f} of its "
          f"tolerance ({STEP_GRAD_TOL} x its tensor's max + 1e-5 x the "
          f"largest gradient {top:.3e})")
    print("phase 9 ok: the paper-config train step runs on the card through "
          "every kernel and learns; it matches the CPU at dropout 0")

    # -- 10: times of the train step and the new kernels ---------------------
    step_ms = {}
    for label, (cfg_t, model_t) in (
            ("bench.py config (flagship, dropout 0, bf16)",
             (cfg, flagship_model(dev))),
            ("paper config (dropout 0.3, bf16)", paper_setup(dev))):
        step = make_step(cfg_t, model_t, "bfloat16", optimizer_name="Adam",
                         lr=1e-3)
        ms = median_ms(lambda: step(xb, yb, ib), iters=20, warmup=3)
        step_ms[label] = ms
        print(f"time train step {label} B={B} L={L}: {ms:.4f} ms per step, "
              f"{B / ms * 1e3:.1f} slates/s {tag}")
        profile_calls(lambda: step(xb, yb, ib), f"train step {label} {tag}")

    d, h, d_ff = 128, 4, 512
    m_rows = B * L
    for kernel_name in ("attention_sublayer_bwd", "ffn_sublayer_bwd"):
        row = {"name": kernel_name, "route": "cuda"}
        for dtype in (torch.float32, torch.bfloat16):
            esz = torch.tensor([], dtype=dtype).element_size()
            dy = torch.randn(B, L, d, generator=gen).to(dtype).to(dev)
            if kernel_name == "attention_sublayer_bwd":
                args = attn_inputs(gen, B, L, d, dtype, dev)
                _, saved = attention_sublayer_fwd(*args, h, return_saved=True)
                fns = (lambda: attention_sublayer_bwd(*args, dy, h,
                                                      saved=saved),
                       lambda: attention_sublayer_bwd_plain(*args, dy, h),
                       b1_library_bwd(args, dy, h))
                # each product once: dO, S, dP, ctx, dQ, dK, dV, dn, dWqkv,
                # dWout
                flops = 16 * m_rows * d * d + 12 * B * h * L * L * (d // h)
                params = nbytes(*args[2:])
                moved = (nbytes(args[0], args[1], dy, *saved) + params
                         + m_rows * d * esz + params)
            else:
                args = ffn_inputs(gen, B, L, d, d_ff, dtype, dev)
                fns = (lambda: ffn_sublayer_bwd(*args, dy),
                       lambda: ffn_sublayer_bwd_plain(*args, dy),
                       b2_library_bwd(args, dy))
                # pre, dh, dn, dW1, dW2
                flops = 10 * m_rows * d * d_ff
                params = nbytes(*args[1:])
                moved = nbytes(args[0], dy) + params + m_rows * d * esz + params
            ms, plain_ms, lib_ms = (median_ms(fn, iters=20) for fn in fns)
            bound_ms, bound_by = bound(flops, moved, dtype)
            sfx = "" if dtype == torch.float32 else "_bf16"
            row.update({f"max_abs_err{sfx}": bwd_errs[(kernel_name, B, L, d,
                                                       dtype, 0.0)],
                        f"ms{sfx}": ms, f"plain_ms{sfx}": plain_ms,
                        f"bound_ms{sfx}": bound_ms, f"bound_by{sfx}": bound_by,
                        f"library_ms{sfx}": lib_ms,
                        f"gflop{sfx}": flops / 1e9,
                        f"mbytes{sfx}": moved / 1e6})
            print(f"time {kernel_name} {dtype} B={B} L={L} d={d}: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (autograd) "
                  f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
                  f"{flops / 1e9:.3f} GFLOP, {moved / 1e6:.2f} MB) {tag}")
        rows.append(row)

    # B3 at the train step's shape: the top-k block is all L=240 documents
    ts = torch.randint(0, 5, (B, L), generator=gen).float()
    valid = torch.ones(B, L)
    valid[:, -40:] = 0.0
    pair_args = [t.to(dev) for t in (torch.randn(B, L, generator=gen) * valid,
                                     ts, (2.0 ** ts - 1.0) / 30.0, valid)]
    kw = dict(scheme="ndcgLoss2PP_scheme", k_eff=L, sigma=1.0, mu=10.0,
              log_base="binary", eps=1e-10)
    gout = torch.ones(B, device=dev)
    lib = chain_library(pair_args, kw)
    pairs = B * L * L
    for kernel_name, fns, ops_per_pair, lib_fn in (
            ("lambda_pairs_fwd",
             (lambda: lambda_pairs_fwd(*pair_args, **kw),
              lambda: lambda_pairs_fwd_plain(*pair_args, **kw)), 28,
             lib[0]),
            ("lambda_pairs_bwd",
             (lambda: lambda_pairs_bwd(*pair_args, gout, **kw),
              lambda: lambda_pairs_bwd_plain(*pair_args, gout, **kw)),
             # the function needs each c_ij once; the kernel's second
             # evaluation (c_ji, so that no atomics are needed) is a cost of
             # its design and not part of the bound
             36, lib[1])):
        ms, plain_ms, lib_ms = (median_ms(fn, iters=20)
                                for fn in fns + (lib_fn,))
        flops = ops_per_pair * pairs
        moved = nbytes(*pair_args) + B * L * 4 + 2 * B * 4
        bound_ms, bound_by = bound(flops, moved, torch.float32)
        rows.append({"name": kernel_name, "route": "cuda",
                     "max_abs_err": b3_errs[kernel_name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms,
                     "gflop": flops / 1e9, "mbytes": moved / 1e6})
        print(f"time {kernel_name} float32 B={B} k={L}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, library (XLA-path chain, autograd) "
              f"{lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
              f"{ops_per_pair} operations per pair, {moved / 1e6:.3f} MB) "
              f"{tag}")

    # -- 11: the record ---------------------------------------------------------
    origin = {"attention_sublayer_fwd": (
        "allrank_tpu_torch/csrc/attention_block.cu",
        "allrank_tpu/ops/attention_block.py:343"),
        "ffn_sublayer_fwd": ("allrank_tpu_torch/csrc/ffn_block.cu",
                             "allrank_tpu/ops/ffn_block.py:204"),
        "attention_sublayer_bwd": ("allrank_tpu_torch/csrc/attention_block.cu",
                                   "allrank_tpu/ops/attention_block.py:375"),
        "ffn_sublayer_bwd": ("allrank_tpu_torch/csrc/ffn_block.cu",
                             "allrank_tpu/ops/ffn_block.py:233"),
        "lambda_pairs_fwd": ("allrank_tpu_torch/csrc/lambda_pairs.cu",
                             "allrank_tpu/ops/lambda_pallas.py:174"),
        "lambda_pairs_bwd": ("allrank_tpu_torch/csrc/lambda_pairs.cu",
                             "allrank_tpu/ops/lambda_pallas.py:197")}
    for row in rows:
        row["source"], row["replaces"] = origin[row["name"]]
        # serving (phase 5) is the forwards' main path, training (phase 9)
        # the backward and pair-chain kernels'
        row["launches"] = main_launches.get(row["name"],
                                            train_launches[row["name"]])
        row["train_launches"] = train_launches[row["name"]]
        assert row["launches"] > 0
        for k, v in row.items():
            assert not isinstance(v, float) or math.isfinite(v), (k, v)
    assert len(rows) == 6
    print(f"train step ms {json.dumps(step_ms)} {tag}")
    print(json.dumps({"kernels": rows}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
