"""Serving path: ``(x, lengths) -> scores`` and ``-> order`` over a model,
compiled for fixed serve shapes and exported to one file.

  * ``make_scorer`` / ``make_ranker`` — padding comes from per-slate
    document counts (the natural serve-time input; labels do not exist at
    serving time) and padded positions score -inf, so they sort last under
    any ordering. As in the reference's inference path, positional
    encodings see rank index 1 for every document (true ranks are unknown
    at serve time). ``compute_dtype="bfloat16"`` runs the tower in bf16;
    scores stay fp32. ``quantize="int8"`` or ``"int8_static"`` serves the
    int8 tower of ``quant.py`` (the latter with ``act_scales`` from
    ``quant.calibrate_activations``).
  * ``aot_compile`` — one CUDA graph per fixed serve shape: the scorer's
    kernels are built, loaded and captured once, and each call replays
    them with none of the host's Python or launches between them.
  * ``export_scorer`` / ``load_scorer`` — the scorer (model definition,
    weights, serve shape, dtype; int8 weights for the int8 towers) in one
    file, loaded back as a compiled scorer.

The JAX package's ``load_scorer`` runs its StableHLO artifact without the
package's model code. Here the kernels are ctypes launches, which
``torch.export`` cannot trace, so the artifact holds what the scorer needs
to be rebuilt: loading it needs this package, and captures its graph
again. The sharded scorer (``make_sharded_scorer``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import threading
from typing import Dict, Optional

import numpy as np
import torch

from allrank_tpu_torch.models.factory import (
    FCDef,
    LTRModel,
    LTRModelDef,
    OutputDef,
    as_dtype,
)
from allrank_tpu_torch.models.transformer import TransformerDef
from allrank_tpu_torch.utils.device import resolve_device

# the version of export_scorer's file; load_scorer reads this one only
FORMAT_VERSION = 1
_WEIGHTS = "weights/"


def _mask_from_lengths(lengths: torch.Tensor, slate_length: int
                       ) -> torch.Tensor:
    positions = torch.arange(slate_length, device=lengths.device)[None, :]
    return positions >= lengths[:, None]


def _check_quantize(quantize, act_scales) -> None:
    if quantize not in ("int8", "int8_static"):
        raise ValueError(f"unknown quantize mode '{quantize}' "
                         "(supported: 'int8', 'int8_static')")
    if quantize == "int8_static" and act_scales is None:
        raise ValueError(
            "quantize='int8_static' needs act_scales from "
            "quant.calibrate_activations (run N representative batches "
            "through the fp32 tower first)")


def _scorer_over(model, dtype: torch.dtype, dev: torch.device):
    """The scorer closure over ``model`` (an ``LTRModel`` or an int8 tower)
    on ``dev``; ``scorer.device`` names the device for ``aot_compile``."""

    def scorer(x, lengths) -> torch.Tensor:
        with torch.inference_mode():
            # on inputs already on the device, as aot_compile's buffers,
            # both conversions are no-ops
            x = torch.as_tensor(x, dtype=torch.float32, device=dev)
            lengths = torch.as_tensor(lengths, device=dev).long()
            mask = _mask_from_lengths(lengths, x.shape[1])
            indices = torch.ones(x.shape[:2], dtype=torch.long, device=dev)
            scores = model.score(x, mask, indices, compute_dtype=dtype)
            return torch.where(mask, float("-inf"), scores.float())

    scorer.device = dev
    return scorer


def make_scorer(model: LTRModel, compute_dtype="float32", device=None,
                quantize=None, act_scales=None):
    """``(x [B, L, F], lengths [B]) -> scores [B, L]`` fp32 on ``device``
    (default: the GPU; the model is moved there). Inputs may be numpy
    arrays or tensors.

    ``quantize="int8"`` serves the int8 tower with dynamic activation
    scales, ``"int8_static"`` with the calibrated ``act_scales``; the
    weights are quantized once, here. On both, ``compute_dtype`` is the
    flow between the int8 layers (LayerNorms, residuals)."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    if quantize is not None:
        _check_quantize(quantize, act_scales)
        from allrank_tpu_torch.quant import quantize_model

        model = quantize_model(
            model, act_scales if quantize == "int8_static" else None)
    return _scorer_over(model, as_dtype(compute_dtype), dev)


def make_ranker(model: LTRModel, compute_dtype="float32", device=None,
                quantize=None, act_scales=None):
    """``(x, lengths) -> order [B, L]``: document indices in descending
    score order (a stable sort), padded positions last."""
    scorer = make_scorer(model, compute_dtype, device, quantize=quantize,
                         act_scales=act_scales)

    def ranker(x, lengths) -> torch.Tensor:
        with torch.inference_mode():
            return torch.argsort(scorer(x, lengths), dim=-1,
                                 descending=True, stable=True)

    ranker.device = scorer.device
    return ranker


# -- ahead-of-time compilation: one CUDA graph per serve shape ---------------

@functools.lru_cache(maxsize=None)
def _kernel_wrappers() -> tuple:
    """Every kernel wrapper of ``ops`` (a function that counts its
    launches), as (name, function) pairs."""
    import importlib
    import pkgutil

    from allrank_tpu_torch import ops

    found = []
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"{ops.__name__}.{info.name}")
        found += [(name, obj) for name, obj in vars(mod).items()
                  if callable(obj)
                  and getattr(obj, "__module__", None) == mod.__name__
                  and isinstance(getattr(obj, "launches", None), int)]
    return tuple(found)


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count by name, and by route as
    ``name[route]`` where the wrapper counts its routes."""
    counts = {}
    for name, fn in _kernel_wrappers():
        counts[name] = fn.launches
        for way, n in getattr(fn, "route_launches", {}).items():
            counts[f"{name}[{way}]"] = n
    return counts


def _pool_bytes(handle) -> int:
    """The device bytes of the segments of graph memory pool ``handle``."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(handle))


class GraphPool:
    """One memory pool for the CUDA graphs of several compiled scorers and
    the lock that serialises their replays. Graphs of one pool share their
    scratch, so no two of them may run at once; each call clones its
    output before the next replay, and the next replay waits for that
    clone on the device (``done``), whichever stream it runs on."""

    def __init__(self):
        self.handle = None
        self.lock = threading.Lock()
        self.done: Optional[torch.cuda.Event] = None


def aot_compile(fn, batch_size: int, slate_length: int, n_features: int,
                pool: Optional[GraphPool] = None):
    """A scorer or ranker of ``make_scorer`` / ``make_ranker`` compiled for
    one serve shape: ``(compiled, info)``.

    On a CUDA device, static input buffers (x [b, L, F] fp32, lengths [b]
    int64) are allocated on the scorer's device, the scorer is warmed on a
    side stream (which builds and loads its kernels and opts each into its
    shared memory) and one call is captured as a CUDA graph.
    ``compiled(x, lengths)`` raises on any other shape (as a compiled JAX
    executable does), copies the inputs into the buffers, replays the graph
    and returns a clone of the output, which the next replay leaves intact.
    A failed capture raises: nothing falls back to the eager scorer. On the
    CPU, where the caller asked for it, ``compiled`` is the eager scorer
    behind the same shape check.

    ``compiled.replays`` counts its calls and ``compiled.captured_launches``
    holds the launches each kernel wrapper counted during the capture
    (``launch_counts``; empty on the CPU): a replay runs the same kernels
    again without counting. Compiled scorers that share ``pool`` share one
    graph memory pool and one lock, so one of them replays at a time, from
    any thread.

    ``info`` holds the shape (``batch_size``, ``slate_length``,
    ``n_features``) and the byte counts that the JAX package reads from
    ``memory_analysis``: ``argument_size_in_bytes`` (the input buffers),
    ``output_size_in_bytes`` and ``temp_size_in_bytes`` (the bytes the
    capture added to the graph memory pool, the output among them; with a
    shared pool, what this shape added to it; 0 on the CPU). XLA's ``flops``
    and ``bytes_accessed`` have no counterpart without a cost analysis and
    are left out."""
    dev = getattr(fn, "device", None)
    if dev is None:
        raise TypeError("aot_compile takes a scorer or ranker of "
                        "make_scorer / make_ranker (it reads their .device)")
    shape = (int(batch_size), int(slate_length), int(n_features))
    pool = pool if pool is not None else GraphPool()
    x_static = torch.zeros(shape, dtype=torch.float32, device=dev)
    len_static = torch.full(shape[:1], shape[1], dtype=torch.long,
                            device=dev)
    info = {"batch_size": shape[0], "slate_length": shape[1],
            "n_features": shape[2],
            "argument_size_in_bytes": x_static.nbytes + len_static.nbytes}

    def check(x, lengths):
        x, lengths = torch.as_tensor(x), torch.as_tensor(lengths)
        if tuple(x.shape) != shape or tuple(lengths.shape) != shape[:1]:
            raise ValueError(
                f"compiled for x {shape} and lengths {shape[:1]}, got "
                f"{tuple(x.shape)} and {tuple(lengths.shape)}")
        return x, lengths

    if dev.type == "cpu":
        out = fn(x_static, len_static)
        info["output_size_in_bytes"] = out.nbytes
        info["temp_size_in_bytes"] = 0

        def compiled(x, lengths):
            x, lengths = check(x, lengths)
            with pool.lock:
                compiled.replays += 1
            return fn(x, lengths)

        captured: Dict[str, int] = {}
    else:
        with torch.cuda.device(dev):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(x_static, len_static)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            if pool.handle is None:
                pool.handle = torch.cuda.graph_pool_handle()
                pool.done = torch.cuda.Event()
                pool.done.record()
            graph = torch.cuda.CUDAGraph()
            before, pooled = launch_counts(), _pool_bytes(pool.handle)
            # thread_local: another thread's CUDA work (a service that is
            # serving) does not break this capture
            with torch.cuda.graph(graph, pool=pool.handle,
                                  capture_error_mode="thread_local"):
                out_static = fn(x_static, len_static)
            captured = {k: n - before.get(k, 0)
                        for k, n in launch_counts().items()
                        if n != before.get(k, 0)}
            info["output_size_in_bytes"] = out_static.nbytes
            info["temp_size_in_bytes"] = (_pool_bytes(pool.handle)
                                          - pooled)

        def compiled(x, lengths):
            x, lengths = check(x, lengths)
            with pool.lock, torch.inference_mode():
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(pool.done)
                x_static.copy_(x)
                len_static.copy_(lengths)
                graph.replay()
                out = out_static.clone()
                pool.done.record(stream)
                compiled.replays += 1
            return out

    compiled.replays = 0
    compiled.captured_launches = captured
    # the graph reads the weights by address: the scorer holds them alive
    compiled.scorer = fn
    compiled.device = dev
    compiled.info = info
    return compiled, info


# -- export ------------------------------------------------------------------

def _mdef_from_dict(d: dict) -> LTRModelDef:
    fc = (FCDef(**{**d["fc"], "sizes": tuple(d["fc"]["sizes"])})
          if d["fc"] else None)
    transformer = TransformerDef(**d["transformer"]) if d["transformer"] \
        else None
    return LTRModelDef(fc=fc, transformer=transformer,
                       output=OutputDef(**d["output"]),
                       n_features=int(d["n_features"]))


def export_scorer(model: LTRModel, slate_length: int, n_features: int,
                  path: str, batch_size: int = 64, compute_dtype="float32",
                  quantize=None, act_scales=None) -> str:
    """Writes the scorer of ``make_scorer(model, compute_dtype,
    quantize=..., act_scales=...)`` to ``path`` as one npz that
    ``load_scorer`` reads with ``allow_pickle=False``: the format version,
    the model definition (``model.mdef``, its ``n_features`` among it), the
    serve shape [batch_size, slate_length, n_features], the dtype, the
    quantize mode, ``act_scales`` and the weights. ``quantize="int8"`` or
    ``"int8_static"`` stores the int8 tower: the int8 weights and their
    scales (4x smaller than fp32), not the float weights. Returns ``path``.
    """
    from allrank_tpu_torch.interop import export_params

    if int(n_features) != model.mdef.n_features:
        raise ValueError(f"the model takes {model.mdef.n_features} features, "
                         f"not {n_features}")
    if quantize is not None:
        _check_quantize(quantize, act_scales)
        from allrank_tpu_torch.quant import QuantizedLTRModel

        with torch.no_grad():
            tower = QuantizedLTRModel(
                model, act_scales if quantize == "int8_static" else None)
        weights = {k: t.detach().cpu().numpy()
                   for k, t in tower.state_dict().items()}
    else:
        weights = export_params(model)
    arrays = {
        "format_version": np.asarray(FORMAT_VERSION),
        "model_definition": np.asarray(
            json.dumps(dataclasses.asdict(model.mdef))),
        "serve_shape": np.asarray([batch_size, slate_length, n_features],
                                  dtype=np.int64),
        "compute_dtype": np.asarray(
            str(as_dtype(compute_dtype)).replace("torch.", "")),
        "quantize": np.asarray(quantize or ""),
        "act_scales": np.asarray(json.dumps(act_scales)),
        **{_WEIGHTS + k: v for k, v in weights.items()},
    }
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    return path


def load_scorer(path: str, device=None):
    """The scorer that ``export_scorer`` wrote to ``path``, rebuilt on
    ``device`` (default: the GPU) and compiled by ``aot_compile`` at the
    stored serve shape: ``compiled(x, lengths) -> scores``. A file of
    another format version raises."""
    with np.load(path, allow_pickle=False) as data:
        version = (int(data["format_version"])
                   if "format_version" in data.files else None)
        if version != FORMAT_VERSION:
            raise ValueError(
                f"{path} is a scorer of format version {version}; this "
                f"package reads version {FORMAT_VERSION}")
        mdef = _mdef_from_dict(json.loads(str(data["model_definition"])))
        batch_size, slate_length, n_features = (
            int(v) for v in data["serve_shape"])
        dtype = as_dtype(str(data["compute_dtype"]))
        quantize = str(data["quantize"]) or None
        weights = {k[len(_WEIGHTS):]: data[k] for k in data.files
                   if k.startswith(_WEIGHTS)}
    dev = resolve_device(device)
    if quantize is not None:
        from allrank_tpu_torch.quant import QuantizedLTRModel

        module = QuantizedLTRModel.from_state_dict(mdef, weights)
    else:
        from allrank_tpu_torch.interop import load_jax_params

        module = load_jax_params(LTRModel(mdef, device="cpu"), weights)
    scorer = _scorer_over(module.to(dev).eval(), dtype, dev)
    compiled, _ = aot_compile(scorer, batch_size, slate_length, n_features)
    return compiled
