"""Batch click models on tensors: the counterpart of the JAX package's
``click_models/jax_models.py``, on the ranking model's device.

The host models (``base.py``, ``cascade_models.py``) click one slate at a
time in numpy. These are their formulations over a batch of ranked labels
``y [B, L]`` (padded documents last, ``PADDED_Y_VALUE``), giving {1, 0, -1}
click masks with the host models' semantics, so that ``rank_and_click``
keeps ranking and clicking on the device. ``diverse_clicks`` also reads the
ranked features ``x [B, L, F]``; its greedy keep rule is a scan over
positions. The Multiple and Conditioned combinators evaluate every inner
model and select or reduce per slate.

``as_device_click_fn`` maps a configured host model to its batch function,
or to None where there is none (then ``rank_and_click`` clicks on the
host), by the JAX package's own rule.

Randomness: a GPU cannot reproduce ``jax.random``'s bits, so the random
models draw from the port's counter-based keyed hash
(``ops/dropout.random_bits``). A ``ClickKey`` is (seed, batch, stream); the
uniform at row ``b``, position ``l`` of a [B, L] draw is a pure function of
the key and ``b * L + l``, so the CPU and the card draw the same bits, and
the index-mode feed draws what the materialising feed does. Each random
function has a core that takes its uniforms as a tensor
(``base_cascade_from_uniforms``, ``random_from_uniforms``,
``multiple_from_uniforms``), which the tests feed ``jax.random``'s draws.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from allrank_tpu_torch.click_models.base import (
    ConditionedClickModel,
    FixedClickModel,
    MaxClicksModel,
    MultipleClickModel,
    OnlyRelevantClickModel,
    RandomClickModel,
)
from allrank_tpu_torch.click_models.cascade_models import (
    BaseCascadeModel,
    DiverseClicksModel,
)
from allrank_tpu_torch.constants import PADDED_Y_VALUE
from allrank_tpu_torch.ops.dropout import random_bits, stream_key

# elements of the [slates, L, L, F] difference tensor that
# ``pairwise_distances`` holds at once (256 MB of fp32)
_DIFF_ELEMENTS = 1 << 26


class ClickKey(NamedTuple):
    """The random stream of one click model on one ranking batch (the JAX
    package's ``fold_in(PRNGKey(seed), batch)`` and its splits)."""

    seed: int
    batch: int
    stream: int = 0

    def split(self, n: int) -> List["ClickKey"]:
        """``n`` independent child streams (``jax.random.split``)."""
        return [self._replace(stream=stream_key(self.stream, i)[0])
                for i in range(n)]

    def uniform(self, shape: Sequence[int], device=None) -> torch.Tensor:
        """fp32 uniforms in [0, 1) of a logical tensor of ``shape``: 24
        hashed bits of each row-major element index."""
        n = int(np.prod(shape))
        index = torch.arange(n, dtype=torch.int64, device=device)
        bits = random_bits(stream_key(self.seed, self.batch)[0], self.stream,
                           index)
        return ((bits >> 8).to(torch.float32) * 2.0 ** -24).reshape(
            tuple(shape))


def _finalize(clicks: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """int32 clicks, -1 restored at padding."""
    return torch.where(y == PADDED_Y_VALUE, PADDED_Y_VALUE,
                       clicks.to(torch.int32))


def _positive(clicks: torch.Tensor) -> torch.Tensor:
    """{-1, 0, 1} -> {0, 1} (``jnp.clip(clicks, 0, 1)``)."""
    return clicks.clamp(0, 1)


def only_relevant_clicks(key, y: torch.Tensor, relevancy_threshold: float):
    """Batch OnlyRelevantClickModel."""
    del key
    return _finalize(y >= relevancy_threshold, y)


def fixed_clicks(key, y: torch.Tensor, click_positions):
    """Batch FixedClickModel. Positions index the ranked slate, whose
    padding is last; negative positions count from the end of the padded
    row and positions outside it are dropped, as JAX's ``.at[].set``
    does."""
    del key
    ell = y.shape[-1]
    idx = torch.as_tensor(click_positions, dtype=torch.int64).reshape(-1)
    idx = torch.where(idx < 0, idx + ell, idx)
    idx = idx[(idx >= 0) & (idx < ell)]
    pos = torch.zeros(ell, dtype=torch.bool)
    pos[idx] = True
    return _finalize(pos.to(y.device).expand(y.shape), y)


def base_cascade_from_uniforms(u: torch.Tensor, y: torch.Tensor,
                               eta: float, threshold: float):
    """BaseCascadeModel given its uniforms ``u [B, L]``: rank r is observed
    iff (1/r)^eta >= u, and an observed document with y >= threshold is
    clicked. Ranked slates keep padding last, so the rank is the column
    index + 1."""
    ell = y.shape[-1]
    ranks = torch.arange(1, ell + 1, dtype=torch.float32,
                         device=y.device)[None, :]
    observed = (1.0 / ranks ** eta) >= u
    return _finalize((y * observed) >= threshold, y)


def base_cascade_clicks(key: ClickKey, y: torch.Tensor, eta: float,
                        threshold: float):
    """Batch BaseCascadeModel."""
    return base_cascade_from_uniforms(key.uniform(y.shape, y.device), y,
                                      eta, threshold)


def random_from_uniforms(u: torch.Tensor, y: torch.Tensor, n_clicks: int):
    """RandomClickModel given its uniforms ``u [B, L]``: the ``n_clicks``
    real documents of largest u in each slate are clicked."""
    real = y != PADDED_Y_VALUE
    scores = torch.where(real, u, -1.0)
    order = torch.argsort(scores, dim=-1, descending=True, stable=True)
    rank_of = torch.argsort(order, dim=-1, stable=True)
    return _finalize((rank_of < n_clicks) & real, y)


def random_clicks(key: ClickKey, y: torch.Tensor, n_clicks: int):
    """Batch RandomClickModel: ``n_clicks`` draws without replacement among
    each slate's real documents."""
    return random_from_uniforms(key.uniform(y.shape, y.device), y, n_clicks)


def max_clicks(inner: Callable, max_clicks_n: int):
    """Batch MaxClicksModel around the batch function ``inner``: the
    first ``max_clicks_n`` clicks of each slate are kept."""

    def fn(key, y, x=None):
        pos = _positive(inner(key, y, x))
        within = torch.cumsum(pos, dim=-1) <= max_clicks_n
        return _finalize(pos * within, y)

    fn.needs_x = getattr(inner, "needs_x", False)
    return fn


def multiple_from_uniforms(u: torch.Tensor, outs: torch.Tensor,
                           cumulative, y: torch.Tensor):
    """MultipleClickModel given each slate's uniform ``u [B]`` and every
    inner model's clicks ``outs [M, B, L]``: slate b takes the first inner
    model i with u < cumulative[i] (the last where there is none)."""
    cum = torch.as_tensor(np.asarray(cumulative, dtype=np.float32),
                          device=u.device)
    idx = torch.searchsorted(cum, u, right=True).clamp(0, len(cum) - 1)
    sel = outs.gather(0, idx[None, :, None].expand(1, *outs.shape[1:]))[0]
    return _finalize(_positive(sel), y)


def multiple_clicks(key: ClickKey, y: torch.Tensor, inner_fns, cumulative,
                    x=None):
    """Batch MultipleClickModel: each slate draws one uniform and takes the
    inner model whose cumulative-probability bucket it falls in. Every
    inner model is evaluated and a per-slate gather selects."""
    sel_key, *keys = key.split(len(inner_fns) + 1)
    outs = torch.stack([fn(k, y, x) for fn, k in zip(inner_fns, keys)])
    return multiple_from_uniforms(sel_key.uniform((y.shape[0],), y.device),
                                  outs, cumulative, y)


def conditioned_from_clicks(outs: torch.Tensor, combiner: str,
                            y: torch.Tensor):
    """ConditionedClickModel given the inner models' clicks ``outs
    [M, B, L]``: the ``combiner`` ("all" or "any") of their clicks."""
    clicked = _positive(outs) > 0
    merged = clicked.all(dim=0) if combiner == "all" else clicked.any(dim=0)
    return _finalize(merged, y)


def conditioned_clicks(key: ClickKey, y: torch.Tensor, inner_fns,
                       combiner: str, x=None):
    """Batch ConditionedClickModel: logical all/any of the inner models'
    clicks."""
    keys = key.split(len(inner_fns))
    outs = torch.stack([fn(k, y, x) for fn, k in zip(inner_fns, keys)])
    return conditioned_from_clicks(outs, combiner, y)


def pairwise_distances(x: torch.Tensor) -> torch.Tensor:
    """[B, L, F] -> [B, L, L] fp32 ``sqrt(max(sum((x_i - x_j)^2), 0))``,
    the JAX package's formulation, a few slates at a time. Symmetric bit
    for bit."""
    b, ell, f = x.shape
    x = x.float()
    out = torch.empty((b, ell, ell), dtype=torch.float32, device=x.device)
    step = max(1, _DIFF_ELEMENTS // max(1, ell * ell * f))
    for s in range(0, b, step):
        xs = x[s:s + step]
        diff = xs[:, :, None, :] - xs[:, None, :, :]
        out[s:s + step] = torch.sqrt(
            torch.clamp((diff * diff).sum(dim=-1), min=0.0))
    return out


def diverse_margin(dist: torch.Tensor, y: torch.Tensor,
                   q_percentile: float) -> torch.Tensor:
    """Each slate's q-quantile [B] of the distances between its real
    documents (the upper triangle), by linear interpolation as numpy's;
    0 for a slate with fewer than two."""
    b, ell, _ = dist.shape
    real = y != PADDED_Y_VALUE
    upper = torch.ones((ell, ell), dtype=torch.bool,
                       device=dist.device).triu(diagonal=1)
    pair_ok = upper & real[:, :, None] & real[:, None, :]
    vals = torch.sort(torch.where(pair_ok, dist, float("inf")).reshape(b, -1),
                      dim=-1).values
    m = pair_ok.sum(dim=(1, 2))
    h = (m - 1).clamp(min=0).to(torch.float32) * q_percentile
    lo = torch.floor(h).long()
    hi = torch.ceil(h).long()
    frac = h - lo.to(torch.float32)
    qv = (vals.gather(1, lo[:, None])[:, 0] * (1.0 - frac)
          + vals.gather(1, hi[:, None])[:, 0] * frac)
    return torch.where(m > 0, qv, 0.0)


def diverse_from_clicks(clicks: torch.Tensor, y: torch.Tensor,
                        x: torch.Tensor, q_percentile: float):
    """DiverseClicksModel given its inner model's clicks: going down the
    ranking, a click is kept unless the document lies within the margin
    (``diverse_margin``) of a click kept before it."""
    pos = _positive(clicks)
    dist = pairwise_distances(x)
    margin = diverse_margin(dist, y, q_percentile)
    b, ell = y.shape
    kept = torch.zeros((b, ell), dtype=torch.bool, device=y.device)
    any_kept = torch.zeros((b,), dtype=torch.bool, device=y.device)
    for j in range(ell):
        # dist is symmetric: row j holds column j's distances
        d = torch.where(kept, dist[:, j, :], float("inf")).amin(dim=-1)
        keep = (pos[:, j] == 1) & ~(any_kept & (d <= margin))
        kept[:, j] = keep
        any_kept |= keep
    return _finalize(pos * kept, y)


def diverse_clicks(key: ClickKey, y: torch.Tensor, x: torch.Tensor,
                   inner_fn: Callable, q_percentile: float):
    """Batch DiverseClicksModel over the inner model's clicks (drawn from
    the same key)."""
    return diverse_from_clicks(inner_fn(key, y, x), y, x, q_percentile)


def as_device_click_fn(click_model) -> Optional[Callable]:
    """Map a host click model to a batch function ``(key, y, x=None) ->
    clicks``, or None where it has no batch formulation: an
    EverythingButDuplicatesClickModel, a ConditionedClickModel whose
    combiner is neither ``np.all`` nor ``np.any``, and any combination
    holding one. Functions that read the ranked features set ``needs_x``."""
    if isinstance(click_model, OnlyRelevantClickModel):
        thr = click_model.relevancy_threshold
        return lambda key, y, x=None: only_relevant_clicks(key, y, thr)
    if isinstance(click_model, FixedClickModel):
        positions = click_model.click_positions
        return lambda key, y, x=None: fixed_clicks(key, y, positions)
    if isinstance(click_model, DiverseClicksModel):
        inner = as_device_click_fn(click_model.inner_click_model)
        if inner is None:
            return None
        q = click_model.q_percentile

        def diverse_fn(key, y, x=None):
            if x is None:
                raise ValueError(
                    "device DiverseClicksModel needs the ranked features")
            return diverse_clicks(key, y, x, inner, q)

        diverse_fn.needs_x = True
        return diverse_fn
    if isinstance(click_model, BaseCascadeModel):
        eta, thr = click_model.eta, click_model.threshold
        return lambda key, y, x=None: base_cascade_clicks(key, y, eta, thr)
    if isinstance(click_model, RandomClickModel):
        n = click_model.n_clicks
        return lambda key, y, x=None: random_clicks(key, y, n)
    if isinstance(click_model, MultipleClickModel):
        inners = [as_device_click_fn(m)
                  for m in click_model.inner_click_models]
        if any(f is None for f in inners):
            return None
        cum = np.asarray(click_model.cumulative, dtype=np.float32)

        def multi_fn(key, y, x=None):
            return multiple_clicks(key, y, inners, cum, x)

        multi_fn.needs_x = any(getattr(f, "needs_x", False) for f in inners)
        return multi_fn
    if isinstance(click_model, ConditionedClickModel):
        inners = [as_device_click_fn(m)
                  for m in click_model.inner_click_models]
        if any(f is None for f in inners):
            return None
        combiner = {np.all: "all", np.any: "any"}.get(click_model.combiner)
        if combiner is None:
            return None  # an arbitrary host callable stays on the host

        def cond_fn(key, y, x=None):
            return conditioned_clicks(key, y, inners, combiner, x)

        cond_fn.needs_x = any(getattr(f, "needs_x", False) for f in inners)
        return cond_fn
    if isinstance(click_model, MaxClicksModel):
        inner = as_device_click_fn(click_model.inner_click_model)
        if inner is None:
            return None
        if click_model.max_clicks is None:
            return inner
        return max_clicks(inner, click_model.max_clicks)
    return None
