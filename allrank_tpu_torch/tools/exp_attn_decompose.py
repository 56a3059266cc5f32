"""Where the B1 forward's time goes on the card, stage by stage (X3): the
counterpart of the JAX package's ``tools/exp_attn_decompose.py``.

Variant kernels of B1's forward with one stage changed at a time (wrong
math, honest timing; ``ops/attention_variants.py``), at dropout 0:

- full: the production math;
- no_softmax: probs = masked scores x 0.001 (no max, exp, sum, division);
- exp2: exp2 of the scaled scores in place of exp;
- norm_after_pv: the row scale applied after P.V;
- no_pv: ctx = v plus a thin slice of p (no P.V contraction);
- frame: LN + QKV + out-projection only (no attention core at all).

Each mode runs as a chain of K=8 kernels with distinct weights in 3
interleaved rounds (every mode back to back in each round; the minimum per
mode over the rounds is compared), each chain 16 times in one CUDA graph.
Then the production B1 forward and backward (``ops/attention_block.py``)
are K-swept (K = 2, 4, 8) and fitted, t(K) = intercept + slope K.

The kernels take B1's route (``ops/attention_variants.route``): the
tensor cores at the default d=128, h=4 (d_k 32); ``--d`` and ``--h`` choose
another width, the SIMT units for d_k > 128.

Usage: python -m allrank_tpu_torch.tools.exp_attn_decompose [B] [L]
[--d D] [--h H] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from allrank_tpu_torch.ops.attention_block import (
    attention_sublayer_bwd,
    attention_sublayer_fwd,
)
from allrank_tpu_torch.ops.attention_variants import (
    MODES,
    attention_variant_fwd,
    route,
)
from allrank_tpu_torch.tools.timing import clock_note, fit, measure
from allrank_tpu_torch.utils.device import resolve_device

D, H = 128, 4
K = 8
KS = (2, 4, 8)
ROUNDS = 3


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("B", type=int, nargs="?", default=64)
    p.add_argument("L", type=int, nargs="?", default=240)
    p.add_argument("--d", type=int, default=D, help="d_model (128)")
    p.add_argument("--h", type=int, default=H, help="heads (4)")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu (the plain versions)")
    return p.parse_args(argv)


def _bf16_values(a, device):
    """``a`` rounded to bf16 and kept as fp32 (B1's parameters are fp32;
    the kernels round them to bf16 as they load them, which is exact)."""
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).to(
        device=device, dtype=torch.float32)


def params(i, device, d=D):
    """Block i's parameters in B1's layout from ``RandomState(100 + i)``:
    gain 1, biases 0, Wqkv and Wout ~ 0.05 N(0, 1) in bf16."""
    r = np.random.RandomState(100 + i)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.ones(d, **f32), torch.zeros(d, **f32),
            _bf16_values(r.randn(d, 3 * d) * 0.05, device),
            torch.zeros(3 * d, **f32),
            _bf16_values(r.randn(d, d) * 0.05, device), torch.zeros(d, **f32))


def inputs(b, l, device, d=D):
    """x0 [B, L, d] bf16 from ``RandomState(0)``, no padded keys, and the
    eight blocks' parameters."""
    rs = np.random.RandomState(0)
    x0 = torch.from_numpy((rs.randn(b, l, d) * 0.1).astype(np.float32)).to(
        device=device, dtype=torch.bfloat16)
    key_mask = torch.zeros(b, l, dtype=torch.bool, device=device)
    return x0, key_mask, [params(i, device, d) for i in range(K)]


def main(argv=None) -> dict:
    """Runs the probe and prints its lines; returns the per-kernel cost of
    each mode (us), the derived stage costs (us) and the two fits."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    d, h = args.d, args.h
    x0, key_mask, plist = inputs(args.B, args.L, dev, d)
    print(clock_note(dev))
    way = route(d, h) if dev.type == "cuda" else "plain (cpu)"
    print(f"B={args.B} L={args.L} d={d} h={h}, route {way}")

    results = dict.fromkeys(MODES, float("inf"))
    for rnd in range(ROUNDS):
        for m in MODES:
            def body(xx, m=m):
                for i in range(K):
                    xx = attention_variant_fwd(xx, key_mask, *plist[i], h,
                                               mode=m)
                return xx
            t = measure(body, x0, f"[round {rnd}] attn fwd [{m}] x{K}", dev)
            results[m] = min(results[m], t / K * 1e3)

    print(f"\nper-kernel cost (us, min over interleaved rounds, K={K} "
          f"chains):")
    for m in MODES:
        print(f"  {m:<14} {results[m]:7.1f}")
    stages = {"softmax": results["full"] - results["no_softmax"],
              "exp2_saves": results["full"] - results["exp2"],
              "norm_after_pv_saves": results["full"]
              - results["norm_after_pv"],
              "pv": results["full"] - results["no_pv"],
              "frame": results["frame"]}
    print(f"\n  softmax total:        {stages['softmax']:7.1f}")
    print(f"  exp2 saves:           {stages['exp2_saves']:7.1f}"
          + ("  (the same kernels as full on this route: B1's exponent is "
             "exp2 already)" if way == "mma" else ""))
    print(f"  norm-after-PV saves:  {stages['norm_after_pv_saves']:7.1f}")
    print(f"  P@V contraction:      {stages['pv']:7.1f}")
    print(f"  LN+QKV+out frame:     {stages['frame']:7.1f}")

    # the production forward and backward calls, K-swept
    ts = []
    for k in KS:
        def body(xx, k=k):
            for i in range(k):
                xx = attention_sublayer_fwd(xx, key_mask, *plist[i], h)
            return xx
        ts.append(measure(body, x0, f"production fwd x{k}", dev))
    fwd_fit = fit(KS, ts, "production fwd call")

    saved = [attention_sublayer_fwd(x0, key_mask, *p, h,
                                    return_saved=True)[1] for p in plist]
    ts = []
    for k in KS:
        def body(dy, k=k):
            for i in range(k):
                dy = attention_sublayer_bwd(x0, key_mask, *plist[i], dy, h,
                                            saved=saved[i])[0]
            return dy
        ts.append(measure(body, x0, f"production bwd x{k}", dev))
    bwd_fit = fit(KS, ts, "production bwd call")
    return {"route": way, "modes_us": results, "stages_us": stages,
            "fwd_fit_ms": fwd_fit, "bwd_fit_ms": bwd_fit}


if __name__ == "__main__":
    main()
