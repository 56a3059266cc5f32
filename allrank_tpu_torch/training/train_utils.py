"""The train step, the evaluation step and the epoch loop (the JAX package's
``training/train_utils.py``: ``make_train_step``, ``make_eval_fns``,
``compute_metrics``, ``fit``).

The train step: forward with dropout, loss, backward, global-norm clip and
the optimizer update.

On CUDA every sublayer of the encoder runs its hand-written kernels in both
directions (autograd Functions in ``ops/``) and lambdaLoss its pair-chain
kernels; on the CPU the same step runs their plain versions. The step
queues its work on the device and returns device scalars, with no host
synchronisation of its own.

``scan_steps`` is a JAX dispatch device (several steps in one compiled
program) and has no counterpart here; a CUDA graph per step is later work.

``fit`` is host-side only: epoch iteration, learning-rate scheduling (with
plateau scheduling on the validation metric), early stopping, logging,
partial and final checkpoints, and a ``torch.profiler`` trace of one epoch.
It reads the device once per epoch for the loss and once per evaluation
pass for the metrics. Over a device feature store (``data.device_cache``)
the batches carry row indices that both steps gather into features on the
device.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from allrank_tpu_torch.constants import PADDED_Y_VALUE
from allrank_tpu_torch.data.batching import DevicePrefetcher
from allrank_tpu_torch.data.feature_store import table_gather
from allrank_tpu_torch.metrics import get_metric
from allrank_tpu_torch.models.factory import LTRModel, as_dtype
from allrank_tpu_torch.training.checkpoint import (
    load_opt_state,
    load_params,
    save_opt_state,
    save_params,
)
from allrank_tpu_torch.training.early_stop import EarlyStop
from allrank_tpu_torch.training.optimizers import (
    get_learning_rate,
    set_learning_rate,
)
from allrank_tpu_torch.utils.ltr_logging import get_logger

logger = get_logger()


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax's
    ``global_norm``)."""
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def make_train_step(model: LTRModel, loss_fn: Callable,
                    loss_kwargs: Optional[Dict[str, Any]], needs_rng: bool,
                    optimizer: torch.optim.Optimizer,
                    gradient_clipping_norm: Optional[float],
                    compute_dtype="float32", accumulation_steps: int = 1,
                    accum_weighting=None,
                    generator: Optional[torch.Generator] = None):
    """Build ``step(x, y, indices, slate_mask=None, table=None) -> (loss,
    n_real)``.

    The batch is a slate batch as the JAX package's ``SlateBatch``: x
    [B, L, F], y [B, L] with ``PADDED_Y_VALUE`` at padded documents,
    indices [B, L] and slate_mask [B] (True at real slates; None: all),
    numpy arrays or tensors; it is moved to the model's device. With a
    device feature store's ``table``, x holds [B, L] row indices that one
    gather on the device turns into features, as the JAX package's
    ``one_batch`` does. One call is one optimizer step on ``optimizer``
    (built over ``model.parameters()``).

    Dropout draws its seeds from ``generator``, a CPU ``torch.Generator``
    (default: seeded with 0): the same generator state gives the same step.
    With ``accumulation_steps = A > 1`` the batch runs as A sequential
    micro-batches whose gradients combine under ``accum_weighting``
    (``losses.accumulation_weighting(name, args)``; default valid-slate
    weighting) before the one step, as in the JAX package. With
    ``gradient_clipping_norm`` c the gradients are scaled by
    ``min(1, c / (global_norm + 1e-6))``.
    """
    dtype = as_dtype(compute_dtype)
    loss_kwargs = dict(loss_kwargs or {})
    a_steps = max(1, int(accumulation_steps or 1))
    if accum_weighting is None:
        weight_fn, normalize = (lambda y, sm: sm.float().sum()), True
    else:
        weight_fn, normalize = accum_weighting
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = [p for p in model.parameters() if p.requires_grad]
    dev = next(model.parameters()).device

    def loss_of(x, mask, indices, y, slate_mask):
        preds = model(x, mask, indices, compute_dtype=dtype, train=True,
                      generator=generator)
        kw = dict(loss_kwargs)
        if needs_rng:
            kw["generator"] = generator
        return loss_fn(preds, y, slate_mask=slate_mask, **kw)

    def step(x, y, indices, slate_mask=None, table=None):
        if table is not None:
            x = table_gather(table, torch.as_tensor(x, device=dev))
        else:
            x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        y = torch.as_tensor(y, dtype=torch.float32, device=dev)
        indices = torch.as_tensor(indices, device=dev).long()
        if slate_mask is None:
            slate_mask = torch.ones(y.shape[0], dtype=torch.bool, device=dev)
        slate_mask = torch.as_tensor(slate_mask, device=dev).bool()
        mask = y == PADDED_Y_VALUE
        optimizer.zero_grad(set_to_none=True)

        if a_steps == 1:
            loss = loss_of(x, mask, indices, y, slate_mask)
            loss.backward()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            loss = loss.detach()
        else:
            b = x.shape[0]
            if b % a_steps:
                raise ValueError(f"batch_size {b} not divisible by "
                                 f"accumulation_steps {a_steps}")
            size = b // a_steps
            grads = [torch.zeros_like(p) for p in params]
            loss = torch.zeros((), device=dev)
            w_sum = torch.zeros((), device=dev)
            for i in range(a_steps):
                part = slice(i * size, (i + 1) * size)
                for p in params:
                    p.grad = None
                micro = loss_of(x[part], mask[part], indices[part], y[part],
                                slate_mask[part])
                micro.backward()
                w = weight_fn(y[part], slate_mask[part])
                for acc, p in zip(grads, params):
                    if p.grad is not None:
                        acc.add_(p.grad * w)
                loss = loss + micro.detach() * w
                w_sum = w_sum + w
            if normalize:
                denom = torch.clamp(w_sum, min=1.0)
                loss = loss / denom
                grads = [g / denom for g in grads]

        if gradient_clipping_norm:
            scale = torch.clamp(
                gradient_clipping_norm / (global_norm(grads) + 1e-6), max=1.0)
            grads = [g * scale for g in grads]
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        return loss, slate_mask.float().sum()

    return step


def make_eval_fns(model: LTRModel, loss_fn: Callable,
                  loss_kwargs: Optional[Dict[str, Any]], needs_rng: bool,
                  metrics: Dict[str, Sequence[int]],
                  compute_dtype="float32", forward_fn=None):
    """Build the evaluation step ``(generator, batch, table=None) ->
    ({metric_at: sum}, loss_sum, n_real)``, all device tensors, without
    autograd; ``batch`` is a ``SlateBatch`` (arrays or tensors). With a
    device feature store's ``table``, ``batch.x`` holds [B, L] row indices
    that one gather on the device turns into features
    (``data/feature_store.py``). ``forward_fn(x, mask, indices)`` replaces
    the model's forward (the int8 tower of ``quant.py`` for an offline
    evaluation of quantized serving); batches go to ``model``'s device."""
    dtype = as_dtype(compute_dtype)
    loss_kwargs = dict(loss_kwargs or {})
    metric_fns = {name: (get_metric(name), tuple(ats))
                  for name, ats in metrics.items()}
    dev = next(model.parameters()).device
    if forward_fn is None:
        def forward_fn(x, mask, indices):
            return model(x, mask, indices, compute_dtype=dtype)

    @torch.inference_mode()
    def step(generator, batch, table=None):
        x, y, indices, slate_mask = batch
        if table is not None:
            x = table_gather(table, torch.as_tensor(x, device=dev))
        else:
            x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        y = torch.as_tensor(y, dtype=torch.float32, device=dev)
        indices = torch.as_tensor(indices, device=dev).long()
        slate_mask = torch.as_tensor(slate_mask, device=dev).bool()
        preds = forward_fn(x, y == PADDED_Y_VALUE, indices)
        kw = dict(loss_kwargs)
        if needs_rng:
            kw["generator"] = generator
        loss = loss_fn(preds, y, slate_mask=slate_mask, **kw)
        # multi-output heads score by the sum over d_output
        scores = preds.sum(dim=-1) if preds.dim() == 3 else preds
        sw = slate_mask.float()
        n_real = sw.sum()
        sums = {}
        for name, (fn, ats) in metric_fns.items():
            weighted = (fn(scores, y, ats=ats) * sw[:, None]).sum(dim=0)
            for i, at in enumerate(ats):
                sums[f"{name}_{at}"] = weighted[i]
        return sums, loss * n_real, n_real

    return step


def compute_metrics(eval_step, batches, generator, table=None
                    ) -> Tuple[Dict[str, float], float]:
    """Run the evaluation step over a batch stream (index batches over a
    feature store's ``table`` where one is given); returns (per-slate mean
    of each metric, mean loss). The one device-to-host read happens here."""
    names, totals = [], None
    for batch in batches:
        sums, loss_sum, n_real = eval_step(generator, batch, table)
        names = list(sums)
        row = torch.stack([*sums.values(), loss_sum, n_real])
        totals = row if totals is None else totals + row
    if totals is None:
        raise ValueError(
            "empty batch stream: the evaluation split has no batches")
    *metric_sums, loss_total, n = totals.tolist()
    if n == 0.0:
        raise ValueError("evaluation split contains zero real slates")
    return {k: v / n for k, v in zip(names, metric_sums)}, loss_total / n


def epoch_summary(epoch, train_loss, train_metrics, val_loss,
                  val_metrics) -> str:
    s = f"Epoch : {epoch} Train loss: {train_loss} Val loss: {val_loss} "
    s += " ".join(f"Train {k} {v}" for k, v in train_metrics.items())
    s += " "
    s += " ".join(f"Val {k} {v}" for k, v in val_metrics.items())
    return s


def _json_safe(d: dict) -> dict:
    """The resumable fields of a scheduler's state: callables (a LambdaLR's
    ``lr_lambda``, rebuilt from the config on restart) are dropped."""
    return {k: v for k, v in d.items()
            if isinstance(v, (int, float, str, bool, list, type(None)))}


@contextlib.contextmanager
def _epoch_trace(trace_dir: Optional[str], dev: torch.device, epoch: int):
    """A ``torch.profiler`` trace of the block, CPU and (on a GPU) CUDA
    activities, exported as a Chrome trace into ``trace_dir``; no trace when
    ``trace_dir`` is None. A profiler that fails to start raises."""
    if trace_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"epoch_{epoch}.pt.trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace of epoch %d written to %s", epoch, path)


def fit(*, epochs: int, model: LTRModel, loss_fn: Callable,
        loss_kwargs: Dict[str, Any], needs_rng: bool,
        optimizer: torch.optim.Optimizer, scheduler, train_batcher,
        val_batcher, metrics: Dict[str, Sequence[int]],
        val_metric: Optional[str], early_stopping_patience: int,
        gradient_clipping_norm: Optional[float],
        output_dir: Optional[str] = None, tensorboard_summary_writer=None,
        compute_dtype: str = "float32", seed: int = 42,
        checkpoint_name: str = "model.npz",
        checkpoint_every: Optional[int] = None,
        checkpoint_backend: str = "npz", resume: bool = False,
        profiler_trace_dir: Optional[str] = None,
        metrics_on_train: bool = True, scan_steps: int = 1,
        accumulation_steps: int = 1, accum_weighting=None,
        train_feature_table: Optional[torch.Tensor] = None,
        val_feature_table: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """The epoch loop. Trains ``model`` in place on its own device and
    returns ``{"epochs", "train_metrics", "val_metrics", "num_params",
    "model"}``.

    ``checkpoint_every=N`` writes parameters, optimizer state and loop state
    (epoch, scheduler, early stop, both generators' states) under
    ``<output_dir>/partial/`` every N epochs; ``resume=True`` restores them
    and continues from the next epoch to the same weights as an
    uninterrupted run. ``train_feature_table`` / ``val_feature_table`` are
    device feature stores' tables (``DeviceFeatureStore.table``) for
    batchers that emit row indices. ``profiler_trace_dir`` writes a
    ``torch.profiler`` trace (CPU and, on a GPU, CUDA activities) of epoch
    1, the first epoch without the one-time costs of the first, or of epoch
    0 in a run of one epoch, as a Chrome trace ``epoch_<n>.pt.trace.json``
    in that directory; a profiler that fails to start raises. Not yet
    ported, and raising when asked for: the Orbax checkpoint backend and
    ``scan_steps`` > 1."""
    for asked, what in ((checkpoint_backend == "orbax",
                         "checkpoint_backend='orbax'"),
                        (int(scan_steps or 1) > 1, "scan_steps > 1")):
        if asked:
            raise NotImplementedError(
                f"{what} is not yet ported to allrank_tpu_torch")
    if checkpoint_backend != "npz":
        raise ValueError(f"unknown checkpoint_backend '{checkpoint_backend}'"
                         " (expected 'npz' or 'orbax')")
    dev = next(model.parameters()).device
    # two host generators: the train step's (dropout seeds, a stochastic
    # loss's noise) and the evaluation's
    step_gen = torch.Generator().manual_seed(seed)
    eval_gen = torch.Generator().manual_seed(seed + 1)
    train_step = make_train_step(
        model, loss_fn, loss_kwargs, needs_rng, optimizer,
        gradient_clipping_norm, compute_dtype,
        accumulation_steps=accumulation_steps,
        accum_weighting=accum_weighting, generator=step_gen)
    eval_step = make_eval_fns(model, loss_fn, loss_kwargs, needs_rng, metrics,
                              compute_dtype)
    if val_metric is None:
        first_name = next(iter(metrics))
        val_metric = f"{first_name}_{metrics[first_name][0]}"
    early_stop = EarlyStop(early_stopping_patience)
    train_metrics: Dict[str, float] = {}
    val_metrics: Dict[str, float] = {}

    def prefetch(batcher):
        return DevicePrefetcher(batcher, device=dev)

    partial_dir = os.path.join(output_dir, "partial") if output_dir else None
    start_epoch = 0
    if resume and partial_dir and os.path.exists(
            os.path.join(partial_dir, "loop_state.json")):
        load_params(model, os.path.join(partial_dir, "params.npz"))
        load_opt_state(optimizer, os.path.join(partial_dir, "opt_state.npz"))
        with open(os.path.join(partial_dir, "loop_state.json")) as f:
            loop_state = json.load(f)
        start_epoch = loop_state["epoch"] + 1
        if scheduler is not None:
            scheduler.__dict__.update(loop_state["scheduler"])
        early_stop.__dict__.update(loop_state["early_stop"])
        step_gen.set_state(torch.tensor(loop_state["step_rng"],
                                        dtype=torch.uint8))
        eval_gen.set_state(torch.tensor(loop_state["rng"],
                                        dtype=torch.uint8))
        logger.info("resumed from %s at epoch %d", partial_dir, start_epoch)

    def save_partial(epoch: int) -> None:
        os.makedirs(partial_dir, exist_ok=True)
        save_params(model, os.path.join(partial_dir, "params.npz"))
        save_opt_state(optimizer, os.path.join(partial_dir, "opt_state.npz"))
        with open(os.path.join(partial_dir, "loop_state.json"), "w") as f:
            json.dump({
                "epoch": epoch,
                "scheduler": (_json_safe(scheduler.__dict__)
                              if scheduler else {}),
                "early_stop": dict(early_stop.__dict__),
                "step_rng": step_gen.get_state().tolist(),
                "rng": eval_gen.get_state().tolist(),
            }, f)

    num_epochs_run = start_epoch
    trace_epoch = min(1, epochs - 1)
    for epoch in range(start_epoch, epochs):
        traced = epoch == trace_epoch and profiler_trace_dir is not None
        with _epoch_trace(profiler_trace_dir if traced else None, dev,
                          epoch):
            t0 = time.time()
            logger.info("Current learning rate: %s",
                        get_learning_rate(optimizer))
            train_batcher.set_epoch(epoch)
            totals = None
            for batch in prefetch(train_batcher):
                loss, n_real = train_step(*batch, table=train_feature_table)
                row = torch.stack([loss * n_real, n_real])
                totals = row if totals is None else totals + row
            loss_total, n_total = totals.tolist()
            train_loss = loss_total / n_total
            t_train = time.time() - t0

            if metrics_on_train:
                train_metrics, _ = compute_metrics(
                    eval_step, prefetch(train_batcher), eval_gen,
                    train_feature_table)
            t_eval0 = time.time()
            val_metrics, val_loss = compute_metrics(
                eval_step, prefetch(val_batcher), eval_gen, val_feature_table)
            logger.info("epoch %d phases: train %.1fs, val eval %.1fs", epoch,
                        t_train, time.time() - t_eval0)
            logger.info("%s [%.1fs]", epoch_summary(
                epoch, train_loss, train_metrics, val_loss, val_metrics),
                time.time() - t0)

            if tensorboard_summary_writer is not None:
                tb = {("train", "loss"): train_loss, ("val", "loss"): val_loss}
                tb.update({("train", k): v for k, v in train_metrics.items()})
                tb.update({("val", k): v for k, v in val_metrics.items()})
                tensorboard_summary_writer.save_to_tensorboard(tb, epoch)

            current_val = val_metrics[val_metric]
            if scheduler is not None:
                set_learning_rate(optimizer, scheduler.step(
                    current_val if scheduler.needs_metric else None))
        early_stop.step(current_val, epoch)
        num_epochs_run = epoch + 1
        if (checkpoint_every and partial_dir
                and (epoch + 1) % checkpoint_every == 0):
            save_partial(epoch)
        if early_stop.stop_training(epoch):
            logger.info(
                "early stopping at epoch %d since %s didn't improve from "
                "epoch %d. Best value %s", epoch, val_metric,
                early_stop.best_epoch, early_stop.best_value)
            break

    if tensorboard_summary_writer is not None:
        tensorboard_summary_writer.close_all_writers()
    if output_dir is not None:
        path = save_params(model, os.path.join(output_dir, checkpoint_name))
        logger.info("saved final model to %s", path)
    return {
        "epochs": num_epochs_run,
        "train_metrics": train_metrics,
        "val_metrics": val_metrics,
        "num_params": sum(p.numel() for p in model.parameters()),
        "model": model,
    }
