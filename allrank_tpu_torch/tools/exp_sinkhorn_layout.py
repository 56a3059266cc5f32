"""B8's Sinkhorn records on chip (X4): the counterpart of the JAX package's
``tools/exp_sinkhorn_layout.py``.

B8's main route "cluster" (``ops/neuralsort.py``,
``csrc/neuralsort_cluster.cu``) writes each iteration's scaling records to
device memory as its loop makes them, and its backward re-reads them and
keeps its U and V stacks in device memory. X4
(``ops/neuralsort_layout.py``) runs the same slate bodies at the same
cluster sizes with the records, and the backward's U and V, in shared
memory for the whole loop, written out and read back in one pass per
slate. The probe checks that both give the same outputs and gradients and
times both, forward and forward + backward, each step 8 times in one CUDA
graph (the TPU's scan of 8).

Usage: python -m allrank_tpu_torch.tools.exp_sinkhorn_layout [N] [L]
[--device cpu]   (defaults 2048 240: the stochastic n_samples=32 x B=64
flagship shape)
"""

from __future__ import annotations

import argparse
from functools import partial

import numpy as np
import torch

from allrank_tpu_torch.ops.neuralsort import (
    fused_soft_sort_contract,
    launch_bwd,
    launch_fwd,
)
from allrank_tpu_torch.ops.neuralsort_layout import (
    layout_soft_sort_bwd,
    layout_soft_sort_contract,
    layout_soft_sort_fwd,
)
from allrank_tpu_torch.tools.timing import clock_note, measure
from allrank_tpu_torch.utils.device import resolve_device

TAU, MAX_ITER, TAIL = 1.0, 50, 40
REPEAT = 8
SPREAD = 0.05  # a ratio within 5 % of 1 is no difference


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("N", type=int, nargs="?", default=2048)
    p.add_argument("L", type=int, nargs="?", default=240)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu (the plain versions)")
    return p.parse_args(argv)


def inputs(n, l, device):
    """Scores and gains from ``RandomState(0)`` and a padding tail of the
    last 40 documents of every slate, as the JAX probe makes them."""
    rng = np.random.RandomState(0)
    s0 = torch.from_numpy(rng.randn(n, l).astype(np.float32)).to(device)
    pad = torch.zeros(n, l, dtype=torch.float32, device=device)
    pad[:, -TAIL:] = 1.0
    vec = torch.from_numpy(rng.rand(n, l).astype(np.float32)).to(device)
    return s0, pad, vec


def b8_contract(scores, pad_mask, vec, *, tau, max_iter):
    """B8's contraction through route "cluster", the code X4 twins."""
    return fused_soft_sort_contract(scores, pad_mask, vec, tau=tau,
                                    max_iter=max_iter, way="cluster")


def _grad(fn, s0, pad, vec):
    leaf = s0.detach().requires_grad_()
    return torch.autograd.grad(
        fn(leaf, pad, vec, tau=TAU, max_iter=MAX_ITER).sum(), leaf)[0]


def _steps(fwd, bwd, pad, vec):
    """The probe's two self-feeding steps of one kernel pair: forward, and
    forward + backward of the sum (``jax.value_and_grad``)."""
    def step_fwd(s):
        return s + 1e-6 * fwd(s, pad, vec, TAU, MAX_ITER)[0]

    def step_vg(s):
        _, a_hist, b_hist = fwd(s, pad, vec, TAU, MAX_ITER)
        g = bwd(s, pad, vec, a_hist, b_hist, torch.ones_like(s), TAU,
                MAX_ITER)
        return s + 1e-6 * g

    return step_fwd, step_vg


def main(argv=None) -> dict:
    """Runs the probe and prints its lines; returns the two differences and
    the four times (ms per step)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    n, l = args.N, args.L
    s0, pad, vec = inputs(n, l, dev)
    print(clock_note(dev))

    out_b8 = b8_contract(s0, pad, vec, tau=TAU, max_iter=MAX_ITER)
    out_x4 = layout_soft_sort_contract(s0, pad, vec, tau=TAU,
                                       max_iter=MAX_ITER)
    g_b8 = _grad(b8_contract, s0, pad, vec)
    g_x4 = _grad(layout_soft_sort_contract, s0, pad, vec)
    res = {"max_abs_out": float((out_b8 - out_x4).abs().max()),
           "max_abs_grad": float((g_b8 - g_x4).abs().max())}
    print("max |out_B8-out_X4| =", res["max_abs_out"])
    print("max |g_B8-g_X4|     =", res["max_abs_grad"])

    arms = (("b8", f"B8 records in device memory N={n} L={l}",
             partial(launch_fwd, "cluster"),
             partial(launch_bwd, "cluster")),
            ("x4", f"X4 records on chip       N={n} L={l}",
             layout_soft_sort_fwd, layout_soft_sort_bwd))
    for key, label, fwd, bwd in arms:
        step_fwd, step_vg = _steps(fwd, bwd, pad, vec)
        res[f"{key}_fwd_ms"] = measure(step_fwd, s0, f"{label} fwd", dev,
                                       repeat=REPEAT)
        res[f"{key}_fwd_bwd_ms"] = measure(step_vg, s0, f"{label} fwd+bwd",
                                           dev, repeat=REPEAT)
    for what in ("fwd", "fwd_bwd"):
        res[f"ratio_{what}"] = res[f"x4_{what}_ms"] / res[f"b8_{what}_ms"]
    print(f"records on chip: X4 / B8 time {res['ratio_fwd']:.3f} forward, "
          f"{res['ratio_fwd_bwd']:.3f} forward + backward: "
          f"{verdict(res['ratio_fwd_bwd'])}")
    return res


def verdict(ratio: float) -> str:
    if ratio < 1.0 - SPREAD:
        return "records on chip pay"
    if ratio > 1.0 + SPREAD:
        return "records on chip cost"
    return f"no difference beyond {SPREAD:.0%}"


if __name__ == "__main__":
    main()
