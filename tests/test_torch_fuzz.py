"""The port's thirteen losses (allrank_tpu_torch/losses) against the
independent fp64 numpy references of ``tools/fuzz_losses.py``, over that
tool's own specs and seeded cases (every padding pattern, slate masks,
heavy ties, +-1e8 scores), at the tolerances
``tests/losses/test_fuzz_differential.py`` holds the JAX package to: the
value at the tool's per-loss fp32-vs-fp64 tolerances, the gradient against
central finite differences of the reference at rtol 5e-2 / atol 5e-4 of the
largest gradient. ``bce`` and ``ordinal`` have references in the tool but no
spec there; they get one here.
"""

import math

import numpy as np
import pytest
import torch

from allrank_tpu_torch.losses import get_loss
from tools.fuzz_losses import (
    DEFAULT_TOL,
    LOSS_SPECS,
    VALUE_TOLS,
    gen_case,
    ref_bce,
    ref_ordinal,
)

torch.set_num_threads(2)

LS = [1, 2, 7, 12]
PATTERNS = ["none", "random", "heavy", "one_real", "with_all_padded"]
B = 5
SPECS = [(name, kwargs, ref, needs, "scores")
         for name, kwargs, ref, needs in LOSS_SPECS] + [
    ("bce", {}, lambda yp, yt, sm: ref_bce(yp, yt, sm), {}, "probabilities"),
    ("ordinal", {"n": 4}, lambda yp, yt, sm: ref_ordinal(yp, yt, 4, sm), {},
     "ordinal probabilities")]


def _spec_id(spec):
    name, kwargs, _, needs, _ = spec
    return name + ("-" + needs["tag"] if "tag" in needs else "") + (
        "-k" if kwargs.get("k") else "")


def _inputs(spec, rng, l, pattern, **case):
    """A case of the tool, with the scores mapped into (0, 1) for the two
    losses that take a sigmoid head's output (fp32-exact, as the tool's)."""
    name, _, _, needs, kind = spec
    yp, yt, sm = gen_case(rng, B, l, pad_pattern=pattern,
                          unique_labels=needs.get("unique_labels", False),
                          **case)
    if kind != "scores":
        if kind == "ordinal probabilities":
            yp = yp[:, :, None] + rng.randn(B, l, 4)
        yp = 1.0 / (1.0 + np.exp(-np.clip(yp, -30, 30) / 3.0))
        yp = yp.astype(np.float32).astype(np.float64)
    if name == "bce":
        yt = np.where(yt < 0, yt, (yt > 1).astype(np.float64))
    return yp, yt, sm


def _port_value_and_grad(name, kwargs, yp, yt, sm):
    fn, _needs_rng = get_loss(name)  # no generator: the deterministic path
    p = torch.tensor(yp, dtype=torch.float32, requires_grad=True)
    loss = fn(p, torch.tensor(yt, dtype=torch.float32),
              slate_mask=None if sm is None else torch.tensor(sm), **kwargs)
    loss.backward()
    return loss.item(), p.grad.double().numpy()


def _grad_matches_fd(spec, yp, yt, sm, g, rng, n_coords=4, h=1e-3,
                     rtol=5e-2, atol=5e-4):
    """The tool's ``check_grad_fd`` with the port's gradient."""
    name, kwargs, ref, _, _ = spec
    scale = max(np.abs(g).max(), 1.0)
    for _ in range(n_coords):
        idx = tuple(rng.randint(n) for n in yp.shape)
        if name == "pointwise_rmse":  # the kink at y == n * p
            n_lv = kwargs["no_of_levels"]
            if abs(yt[idx] - n_lv * yp[idx]) < 4.0 * n_lv * h:
                continue
        e = np.zeros_like(yp)
        e[idx] = h
        fd = (ref(yp + e, yt, sm) - ref(yp - e, yt, sm)) / (2 * h)
        if abs(fd - g[idx]) > atol * scale + rtol * max(abs(fd),
                                                        abs(g[idx])):
            return f"coord {idx}: fd={fd:.6g} grad={g[idx]:.6g}"
    return ""


@pytest.mark.parametrize("spec", SPECS, ids=_spec_id)
def test_loss_matches_fp64_reference(spec):
    name, kwargs, ref, _, kind = spec
    rtol, atol = VALUE_TOLS.get(name, DEFAULT_TOL)
    rng = np.random.RandomState(0)
    failures, checked = [], 0
    for l in LS:
        for pattern in PATTERNS:
            if l == 1 and pattern == "one_real":
                continue
            yp, yt, sm = _inputs(spec, rng, l, pattern, min_gap=2e-3)
            got, g = _port_value_and_grad(name, kwargs, yp, yt, sm)
            want = ref(yp, yt, sm)
            checked += 1
            if not (math.isfinite(got)
                    and abs(got - want) <= atol + rtol * abs(want)):
                failures.append((l, pattern, got, want))
                continue
            assert np.isfinite(g).all(), (l, pattern)
            # the probability losses' scores sit away from the clamps, so
            # finite differences of the reference are valid there too
            msg = _grad_matches_fd(spec, yp, yt, sm, g, rng)
            if msg:
                failures.append((l, pattern, msg))
        # heavy score ties: both sides sort stably
        yp, yt, sm = _inputs(spec, rng, l, "random", ties=True)
        t_rtol, t_atol = ((4e-3, 4e-3) if name.startswith("neuralNDCG")
                          else (rtol, atol))
        got, _ = _port_value_and_grad(name, kwargs, yp, yt, sm)
        want = ref(yp, yt, sm)
        checked += 1
        if not (math.isfinite(got)
                and abs(got - want) <= t_atol + t_rtol * abs(want)):
            failures.append((l, "ties", got, want))
    assert checked == len(LS) * (len(PATTERNS) + 1) - 1
    assert not failures, failures[:5]


@pytest.mark.parametrize("spec", SPECS, ids=_spec_id)
def test_extreme_scores_stay_finite(spec):
    """+-1e8-scale scores must not put a NaN or an infinity into any loss
    value or gradient."""
    name, kwargs, _, _, kind = spec
    rng = np.random.RandomState(10_000)
    yp, yt, sm = _inputs(spec, rng, 12, "random", extreme=True)
    v, g = _port_value_and_grad(name, kwargs, yp, yt, sm)
    assert math.isfinite(v), v
    assert np.isfinite(g).all()
