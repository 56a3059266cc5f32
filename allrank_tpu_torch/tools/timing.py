"""Clocks of the probe CLIs: the counterparts of the JAX package's
``tools/bench_util.py:15`` (``time_steps``) and
``tools/exp_chain_sweep.py:42-64`` (``measure`` and ``fit``).

On the card a step function is timed by CUDA events: either ``repeat``
steps captured in one CUDA graph and replayed (the TPU's ``lax.scan`` of
``repeat`` steps: the kernels run back to back with none of the host's time
between them), or the same steps launched one by one from Python (eager:
each boundary also carries the host's launch). On the CPU (``--device
cpu``, the tests) the host clock times the plain versions; those numbers
are the CPU's and say nothing of the card.
"""

from __future__ import annotations

import collections
import statistics
import time
from typing import Callable, Sequence

import numpy as np
import torch


def _median_event_ms(fn: Callable[[], object], iters: int,
                     warmup: int) -> float:
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


def _median_host_ms(fn: Callable[[], object], iters: int,
                    warmup: int) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def graph_ms(fn: Callable[[], object], calls: int = 20, iters: int = 20,
             warmup: int = 3) -> float:
    """The device's own time for one call of ``fn``: ``calls`` calls
    captured into one CUDA graph, which the host launches as a whole, so
    the kernels run back to back with none of the host's time between them
    (allocation, checks, the launch: several times a kernel of 10-100 us);
    the median event-timed replay, divided by ``calls``."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = _median_event_ms(graph.replay, iters, warmup) / calls
    del graph
    return ms


# torch.profiler loses the first device events of a trace once CUDA graphs
# have run in the process (on an H100 5 in a short process, all of a trace
# late in chip_smoke.py's; PERF.md section 6, profiler traces): this many
# spin kernels lead each trace to take that loss and are left out of it
LEAD_KERNELS = 64
LEAD_KERNEL_NAME = "spin"  # torch.cuda._sleep's kernel, at::cuda::spin_kernel
TRACE_ATTEMPTS = 3


class IncompleteTrace(RuntimeError):
    """A torch.profiler trace that lost device events."""


def _trace(fn: Callable[[], object], calls: int) -> tuple:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_KERNELS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    return ([(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and LEAD_KERNEL_NAME not in e.name], window_us)


def trace_complete(spans, one_call, calls: int) -> bool:
    """Whether ``spans``, the device events of ``calls`` calls, hold each
    kernel of ``one_call`` (those of a trace of one call) ``calls`` times
    as often, and no other; an empty trace is never complete."""
    want = collections.Counter(name for name, _, _ in one_call)
    got = collections.Counter(name for name, _, _ in spans)
    return bool(want) and got == {n: c * calls for n, c in want.items()}


def trace_kernels(fn: Callable[[], object], calls: int) -> tuple:
    """Every kernel of ``calls`` calls of ``fn`` in a torch.profiler trace,
    after one call outside it: a list of (name, start us, end us) and the
    host's window in us. Where the profiler loses more device events than
    the ``LEAD_KERNELS`` that open each trace, a trace would read low; so
    it is held against a trace of one call (``trace_complete``) and taken
    again, ``TRACE_ATTEMPTS`` times in all, before ``IncompleteTrace`` is
    raised.
    ``trace_kernels.lost`` counts the incomplete traces of the process."""
    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_ATTEMPTS):
        one_call, _ = _trace(fn, 1)
        spans, window_us = _trace(fn, calls)
        if trace_complete(spans, one_call, calls):
            return spans, window_us
        trace_kernels.lost += 1
    raise IncompleteTrace(
        f"{TRACE_ATTEMPTS} torch.profiler traces of {calls} calls lost device "
        f"events: {len(spans)} kernels, one call's trace {len(one_call)}")


trace_kernels.lost = 0


def busy_us(spans) -> float:
    """The device's busy time in a trace: the union of the (name, start us,
    end us) spans of ``trace_kernels``, overlaps counted once."""
    ordered = sorted((start, end) for _, start, end in spans)
    busy, (lo, hi) = 0.0, ordered[0]
    for start, end in ordered[1:]:
        if start > hi:
            busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    return busy + hi - lo


def kernel_ms(fn: Callable[[], object], calls: int = 10) -> dict:
    """Device time of one call by kernel name, ms: each kernel's durations
    in a trace of ``calls`` calls (``trace_kernels``, which raises
    ``IncompleteTrace`` where the profiler lost events), divided by
    ``calls``. Their sum is the yardstick of a library backward, whose
    autograd engine refuses CUDA-graph capture (it makes the legacy stream
    wait on the capturing one)."""
    spans, _ = trace_kernels(fn, calls)
    by_name: dict = {}
    for name, start, end in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / calls / 1e3
    return by_name


def _chain(step, state, repeat):
    for _ in range(repeat):
        state = step(state)
    return state


def step_ms(step: Callable, state, device: torch.device, repeat: int = 16,
            graph: bool = True, iters: int = 5) -> float:
    """Milliseconds per step of ``repeat`` self-feeding steps
    ``state = step(state)``: on the card captured in one CUDA graph and
    replayed (``graph``), or launched eagerly; the median over ``iters``
    runs. On the CPU the host clock of one eager chain."""
    def run():
        return _chain(step, state, repeat)

    if device.type != "cuda":  # the tests' run: one pass is enough
        return _median_host_ms(run, iters=1, warmup=0) / repeat
    if not graph:
        return _median_event_ms(run, iters=iters, warmup=1) / repeat
    step(state)  # builds and loads the kernels outside the capture
    torch.cuda.synchronize()
    cuda_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cuda_graph):
        run()
    ms = _median_event_ms(cuda_graph.replay, iters=iters, warmup=1) / repeat
    del cuda_graph
    torch.cuda.empty_cache()
    return ms


def measure(step: Callable, state, label: str, device: torch.device,
            repeat: int = 16, graph: bool = True) -> float:
    """``step_ms`` printed as the JAX probes print it; returns ms per
    step."""
    ms = step_ms(step, state, device, repeat=repeat, graph=graph)
    print(f"{label:<52} {ms:8.3f} ms", flush=True)
    return ms


def fit(ks: Sequence[int], ts: Sequence[float], label: str) -> tuple:
    """``t(K) = intercept + slope K`` by least squares over a K-sweep of
    ms per step; prints both in us and returns (slope, intercept) in ms."""
    slope, intercept = np.polyfit(np.asarray(ks, dtype=float),
                                  np.asarray(ts, dtype=float), 1)
    print(f"{label:<36} slope {slope * 1e3:7.1f} us/unit   "
          f"intercept {intercept * 1e3:7.1f} us/iter")
    return float(slope), float(intercept)


def clock_note(device: torch.device) -> str:
    """The line that says whose clock the numbers are."""
    if device.type == "cuda":
        return (f"device: {torch.cuda.get_device_name(device)}; CUDA events, "
                f"device time")
    return ("device: cpu; the plain PyTorch versions on the host clock, "
            "no number of the card")
