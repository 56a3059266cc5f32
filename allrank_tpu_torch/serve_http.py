"""Scoring service: dynamic batching + HTTP front (stdlib only).

  * ``SlateScoringService`` — a dynamic batcher: concurrent requests queue
    up, a worker thread packs up to ``batch_size`` slates (padding each to
    the serve slate length) into ONE device call per wave, waiting at most
    ``max_wait_ms`` after the first request of a wave. The GPU wants big
    batches; request threads want latency — this trades between them.
  * ``run_server`` / ``python -m allrank_tpu_torch.serve_http`` — a threaded
    HTTP endpoint: ``POST /score`` with ``{"slate": [[f...], ...]}`` (or an
    ``application/octet-stream`` ``.npy`` body) returns the scores;
    ``GET /healthz`` for probes; ``GET /statz`` for operational counters
    (requests, waves per bucket, rejections, queue depth, wave latency).
  * backpressure: ``max_queue`` bounds the pending-request queue — past it
    ``submit`` raises ``ServiceOverloaded`` and the HTTP front answers 503
    with ``Retry-After``.

The worker thread is the one thread that uses the card. Each bucket is
warmed with one call at startup, so the first request pays no kernel build
or load.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from allrank_tpu_torch.serving import make_scorer
from allrank_tpu_torch.utils.device import resolve_device


class ServiceOverloaded(RuntimeError):
    """Raised by ``submit`` when the pending queue is at ``max_queue``."""


class SlateScoringService:
    """Thread-safe dynamic batcher over a scorer.

    ``submit(x [n_docs, F]) -> Future[np.ndarray [n_docs]]``; slates longer
    than ``slate_length`` are rejected (rank the top-L upstream or raise the
    serve shape — truncation would silently change results).
    """

    def __init__(self, model, slate_length: int, n_features: int,
                 batch_size: int = 64, max_wait_ms: float = 5.0,
                 compute_dtype: str = "bfloat16", batch_buckets=None,
                 max_queue: Optional[int] = None, device=None):
        """``batch_buckets`` (e.g. ``(1, 8, 64)``) routes each wave to the
        smallest bucket that fits — a 1-request wave at low QPS costs a B=1
        call, not a padded B=64 one. Default: a single bucket of
        ``batch_size``. ``device`` defaults to the GPU."""
        if compute_dtype in ("int8", "int8_static"):
            raise NotImplementedError(
                f"{compute_dtype} serving is not yet ported")
        self.slate_length = int(slate_length)
        self.n_features = int(n_features)
        if batch_buckets:
            self.buckets = tuple(sorted(int(b) for b in batch_buckets))
            if int(batch_size) != self.buckets[-1]:
                raise ValueError(
                    f"batch_size {batch_size} must equal the largest bucket "
                    f"{self.buckets[-1]}")
        else:
            self.buckets = (int(batch_size),)
        self.batch_size = int(batch_size)
        self.max_wait_s = float(max_wait_ms) / 1e3
        if max_queue is not None and int(max_queue) <= 0:
            # queue.Queue treats maxsize<=0 as UNBOUNDED — the opposite of
            # what an operator bounding the queue at 0 means; refuse loudly
            raise ValueError(f"max_queue must be positive, got {max_queue}")
        self.device = resolve_device(device)
        scorer = make_scorer(model, compute_dtype, device=self.device)
        self._scorer_by_bucket = {}
        for b in self.buckets:
            # warm each bucket shape: builds and loads the kernels once
            scorer(np.zeros((b, self.slate_length, self.n_features),
                            dtype=np.float32), np.ones(b, dtype=np.int64))
            self._scorer_by_bucket[b] = scorer
        self.executable_info = {"buckets": self.buckets,
                                "device": str(self.device),
                                "compute_dtype": str(compute_dtype)}
        self._queue: "queue.Queue" = queue.Queue(
            maxsize=int(max_queue) if max_queue is not None else 0)
        self._stop = threading.Event()
        self._stats_lock = threading.Lock()
        self._stats = {
            "requests_total": 0,
            "rejected_total": 0,
            "waves_total": 0,
            "waves_by_bucket": {int(b): 0 for b in self.buckets},
            "wave_errors_total": 0,
        }
        self._wave_ms: list = []  # ring buffer of recent wave latencies
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def stats(self) -> dict:
        """Operational counters + recent wave-latency quantiles (served at
        ``GET /statz``)."""
        with self._stats_lock:
            out = dict(self._stats)
            out["waves_by_bucket"] = dict(self._stats["waves_by_bucket"])
            lat = np.asarray(self._wave_ms, dtype=np.float64)
        out["queue_depth"] = self._queue.qsize()
        if lat.size:
            out["wave_ms"] = {
                "p50": round(float(np.percentile(lat, 50)), 3),
                "p90": round(float(np.percentile(lat, 90)), 3),
                "p99": round(float(np.percentile(lat, 99)), 3),
                "n": int(lat.size),
            }
        return out

    def submit(self, x: np.ndarray) -> Future:
        if self._stop.is_set():
            raise RuntimeError("scoring service is closed")
        x = np.asarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.n_features:
            raise ValueError(
                f"slate must be [n_docs, {self.n_features}], got {x.shape}")
        if x.shape[0] > self.slate_length:
            raise ValueError(
                f"slate of {x.shape[0]} docs exceeds serve length "
                f"{self.slate_length}")
        if x.shape[0] == 0:
            raise ValueError("empty slate")
        fut: Future = Future()
        try:
            self._queue.put_nowait((x, fut))
        except queue.Full:
            with self._stats_lock:
                self._stats["rejected_total"] += 1
            raise ServiceOverloaded(
                f"pending queue at capacity ({self._queue.maxsize})")
        with self._stats_lock:
            self._stats["requests_total"] += 1
        return fut

    def score(self, x: np.ndarray, timeout: Optional[float] = None):
        """Blocking convenience wrapper around ``submit``."""
        return self.submit(x).result(timeout=timeout)

    def close(self) -> None:
        """Stop the worker; pending (and any racing) requests are failed
        promptly rather than left with never-resolving futures."""
        self._stop.set()
        self._worker.join(timeout=5)
        while True:
            try:
                _, fut = self._queue.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("scoring service is closed"))

    # -- worker ------------------------------------------------------------

    def _collect_wave(self):
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        wave = [first]
        t0 = time.perf_counter()
        while len(wave) < self.batch_size:
            remaining = self.max_wait_s - (time.perf_counter() - t0)
            if remaining <= 0:
                break
            try:
                wave.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return wave

    def _loop(self) -> None:
        # grad mode and the current device are per thread: set both here,
        # where the card is used
        torch.set_grad_enabled(False)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        L, F = self.slate_length, self.n_features
        while not self._stop.is_set():
            wave = self._collect_wave()
            if not wave:
                continue
            # smallest bucket that fits this wave; rows past the wave keep
            # lengths=0 and score -inf
            B = next(b for b in self.buckets if b >= len(wave))
            xb = np.zeros((B, L, F), dtype=np.float32)
            lengths = np.zeros(B, dtype=np.int64)
            for i, (x, _) in enumerate(wave):
                n = x.shape[0]
                xb[i, :n] = x
                lengths[i] = n
            t0 = time.perf_counter()
            try:
                scores = self._scorer_by_bucket[B](xb, lengths).cpu().numpy()
                for i, (x, fut) in enumerate(wave):
                    fut.set_result(scores[i, : x.shape[0]].copy())
                with self._stats_lock:
                    self._stats["waves_total"] += 1
                    self._stats["waves_by_bucket"][B] += 1
                    self._wave_ms.append((time.perf_counter() - t0) * 1e3)
                    if len(self._wave_ms) > 1024:
                        del self._wave_ms[:512]
            except Exception as exc:  # device failure -> fail the wave
                with self._stats_lock:
                    self._stats["wave_errors_total"] += 1
                for _, fut in wave:
                    if not fut.done():
                        fut.set_exception(exc)


def run_server(service: SlateScoringService, port: int, host: str = ""):
    """Serve ``POST /score`` / ``GET /healthz`` / ``GET /statz``; returns
    the threaded HTTPServer (caller runs ``serve_forever``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _safe_reply(self, code: int, payload: dict) -> None:
            # a client that disconnected mid-reply leaves no socket to
            # answer on — drop, never attempt a second write
            try:
                self._reply(code, payload)
            except OSError:
                self.close_connection = True

        def do_GET(self):
            if self.path == "/healthz":
                self._safe_reply(200, {"status": "ok",
                                       "slate_length": service.slate_length,
                                       "n_features": service.n_features})
            elif self.path == "/statz":
                self._safe_reply(200, service.stats())
            else:
                self._safe_reply(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/score":
                self._safe_reply(404, {"error": "not found"})
                return
            from concurrent.futures import TimeoutError as FutureTimeout
            import io

            # the OSError/EOFError catch covers ONLY the body read+decode,
            # where they mean a truncated or empty upload (400)
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                ctype = (self.headers.get("Content-Type") or "").split(";")[0]
                binary = ctype == "application/octet-stream"
                if binary:
                    # an .npy [n_docs, F] float32 payload; allow_pickle=False
                    # keeps it data-only
                    slate = np.asarray(
                        np.load(io.BytesIO(body), allow_pickle=False),
                        dtype=np.float32)
                else:
                    slate = np.asarray(json.loads(body)["slate"],
                                       dtype=np.float32)
            except (KeyError, TypeError, ValueError, EOFError, OSError,
                    json.JSONDecodeError) as exc:
                self._safe_reply(400, {"error": str(exc)})
                return

            try:
                scores = service.score(slate, timeout=30.0)
            except ValueError as exc:  # shape/empty-slate validation
                self._safe_reply(400, {"error": str(exc)})
                return
            except FutureTimeout:
                self._safe_reply(503, {"error": "scoring timed out"})
                return
            except ServiceOverloaded as exc:  # load-shed at admission
                try:
                    self.send_response_only(503)
                    self.send_header("Retry-After", "1")
                    body = json.dumps({"error": str(exc)}).encode()
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except OSError:
                    self.close_connection = True
                return
            except RuntimeError as exc:  # service closed mid-request
                self._safe_reply(503, {"error": str(exc)})
                return

            try:
                if binary:
                    out = io.BytesIO()
                    np.save(out, np.asarray(scores, dtype=np.float32))
                    raw = out.getvalue()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/octet-stream")
                    self.send_header("Content-Length", str(len(raw)))
                    self.end_headers()
                    self.wfile.write(raw)
                else:
                    self._reply(200, {"scores": [float(s) for s in scores]})
            except OSError:
                self.close_connection = True  # client gone mid-reply

    class Server(ThreadingHTTPServer):
        # the stdlib listen backlog of 5 drops connections once a few dozen
        # clients post concurrently
        request_queue_size = 128
        daemon_threads = True

    return Server((host, port), Handler)


def main(argv=None) -> None:
    from argparse import ArgumentParser

    from allrank_tpu_torch.config import Config
    from allrank_tpu_torch.interop import load_npz
    from allrank_tpu_torch.models.factory import LTRModel, make_model
    from allrank_tpu_torch.utils.ltr_logging import get_logger

    ap = ArgumentParser("allRank-tpu-torch scoring service")
    ap.add_argument("--config-file-name", required=True)
    ap.add_argument("--input-model-path", required=True,
                    help="a model.npz written by the JAX package's "
                         "training.checkpoint.save_params")
    ap.add_argument("--n-features", type=int, required=True,
                    help="feature dimension the model was trained with")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--host", default="")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--batch-buckets", default=None,
                    help="comma-separated wave buckets, e.g. 1,8,64; the "
                         "largest must equal --batch-size")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound the pending-request queue; past it requests "
                         "are rejected with 503 (load-shedding)")
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--compute-dtype", default="bfloat16",
                    choices=["float32", "bfloat16", "int8", "int8_static"],
                    help="int8 and int8_static are not yet ported")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    config = Config.from_json(args.config_file_name)
    mdef = make_model(config.model, args.n_features)
    model = load_npz(LTRModel(mdef, device="cpu"), args.input_model_path)
    service = SlateScoringService(
        model, config.data.slate_length, args.n_features,
        batch_size=args.batch_size, max_wait_ms=args.max_wait_ms,
        compute_dtype=args.compute_dtype,
        batch_buckets=([int(b) for b in args.batch_buckets.split(",")]
                       if args.batch_buckets else None),
        max_queue=args.max_queue, device=args.device,
    )
    logger = get_logger()
    logger.info("scoring service on :%d (batch %d, wait %.1f ms, %s): %s",
                args.port, args.batch_size, args.max_wait_ms,
                args.compute_dtype, service.executable_info)
    run_server(service, args.port, args.host).serve_forever()


if __name__ == "__main__":
    main()
