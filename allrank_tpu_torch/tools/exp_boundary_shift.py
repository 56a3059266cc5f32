"""What a kernel boundary costs on the card, and whether its content
matters (X2): the counterpart of the JAX package's
``tools/exp_boundary_shift.py``.

Two synthetic kernels of the same work at the flagship shape (bf16,
B=64, L=240, d=128, d3=384; ``ops/boundary_shift.py``):

- plain:   k_i(x) = x + relu(LN(x) W1_i) W2_i (a bare residual at the
  boundary, the production layout);
- shifted: k_i(x, pre) = (out, LN(out) W1_{i+1}) with
  out = x + relu(pre) W2_i (every boundary ends in a fresh product for the
  next kernel).

Each runs as an isolated self-feeding loop and as an N-kernel chain with
distinct weights; the per-boundary tax is (T_chain - N T_isolated) / (N - 1).
The TPU's scan of 16 steps becomes 16 steps captured in one CUDA graph
(kernels back to back, the in-graph boundary); the same steps are also
launched one by one from Python (the host-launched boundary). If the
shifted tax is not below 0.7 of the plain one, the boundary cost does not
depend on what the boundary carries.

Usage: python -m allrank_tpu_torch.tools.exp_boundary_shift [B] [L] [N]
[--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from allrank_tpu_torch.ops.boundary_shift import boundary_plain, boundary_shift
from allrank_tpu_torch.tools.timing import clock_note, measure
from allrank_tpu_torch.utils.device import resolve_device

D, D3 = 128, 384
VERDICT_RATIO = 0.7  # the JAX probe's threshold


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("B", type=int, nargs="?", default=64)
    p.add_argument("L", type=int, nargs="?", default=240)
    p.add_argument("N", type=int, nargs="?", default=8)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu (the plain versions)")
    args = p.parse_args(argv)
    if args.N < 2:
        p.error("N must be at least 2 (the tax divides by N - 1)")
    return args


def inputs(b, l, n, device):
    """x0, W1 [n], W2 [n] and pre0 from ``RandomState(0)`` in the JAX
    probe's order, bf16 on ``device``."""
    rs = np.random.RandomState(0)

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)

    x0 = bf16(rs.randn(b, l, D) * 0.1)
    w1 = [bf16(rs.randn(D, D3) * 0.05) for _ in range(n)]
    w2 = [bf16(rs.randn(D3, D) * 0.05) for _ in range(n)]
    pre0 = bf16(rs.randn(b, l, D3) * 0.1)
    return x0, w1, w2, pre0


def verdict(tax_plain: float, tax_shift: float) -> str:
    """The JAX probe's rule, for a plain boundary that costs something: a
    tax at or below zero (within the timing's spread of nothing) leaves
    nothing for the shift to cut."""
    if tax_plain > 0 and tax_shift < VERDICT_RATIO * tax_plain:
        return "SHIFT HELPS — build the real kernels"
    return "NEGATIVE — boundary cost is invariant to boundary content"


def main(argv=None) -> dict:
    """Runs the probe and prints its lines; returns its numbers by launch
    mode ("graph", "eager"), in ms per step and us per boundary."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    n = args.N
    x0, w1, w2, pre0 = inputs(args.B, args.L, n, dev)
    print(clock_note(dev))
    print(f"B={args.B} L={args.L} d={D} d3={D3} N={n}")

    def iso_plain(xx):
        return boundary_plain(xx, w1[0], w2[0])

    def iso_shift(st):
        return boundary_shift(st[0], st[1], w2[0], w1[0])

    def chain_plain(xx):
        for i in range(n):
            xx = boundary_plain(xx, w1[i], w2[i])
        return xx

    def chain_shift(st):
        xx, pre = st
        for i in range(n):
            xx, pre = boundary_shift(xx, pre, w2[i], w1[(i + 1) % n])
        return (xx, pre)

    results = {}
    for mode in ("graph", "eager"):
        g = mode == "graph"
        kind = ("one CUDA graph" if g else "eager") if dev.type == "cuda" \
            else f"cpu, {mode} pass"
        r = {"iso_plain_ms": measure(iso_plain, x0,
                                     f"isolated plain kernel ({kind})", dev,
                                     graph=g),
             "iso_shift_ms": measure(iso_shift, (x0, pre0),
                                     f"isolated shifted kernel ({kind})",
                                     dev, graph=g),
             "chain_plain_ms": measure(chain_plain, x0,
                                       f"chained plain x{n} ({kind})", dev,
                                       graph=g),
             "chain_shift_ms": measure(chain_shift, (x0, pre0),
                                       f"chained shifted x{n} ({kind})", dev,
                                       graph=g)}
        r["tax_plain_us"] = ((r["chain_plain_ms"] - n * r["iso_plain_ms"])
                             / (n - 1) * 1e3)
        r["tax_shift_us"] = ((r["chain_shift_ms"] - n * r["iso_shift_ms"])
                             / (n - 1) * 1e3)
        r["verdict"] = verdict(r["tax_plain_us"], r["tax_shift_us"])
        print(f"\nper-boundary tax  plain   {r['tax_plain_us']:7.1f} us "
              f"({kind})")
        print(f"per-boundary tax  shifted {r['tax_shift_us']:7.1f} us "
              f"({kind})")
        print(f"verdict ({kind}): {r['verdict']}\n")
        results[mode] = r
    return results


if __name__ == "__main__":
    main()
