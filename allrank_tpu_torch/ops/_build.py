"""Builds ``csrc/<name>.cu`` with nvcc into a shared library with a plain C
interface, at first use, and loads it with ctypes.

Each library is named after a digest of its sources and flags, so an edited
source is rebuilt and a stale one is never loaded. A file lock keeps two
processes from building at once; ``build`` starts one nvcc per missing
library, all together. Nothing here runs at import time: this module is
imported on machines without nvcc or a GPU.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

import torch

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build",
                         "allrank_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_loaded_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels are "
            "built from allrank_tpu_torch/csrc at first use")
    return path


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, name + ".cu")


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source_path(name)] + sorted(
            glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def log_path(name: str) -> str:
    """nvcc's output for ``name`` (with ``-Xptxas=-v``: registers, shared
    memory and spills of every kernel)."""
    return os.path.join(BUILD_DIR, name + ".log")


def build(names: Iterable[str]) -> None:
    """Compile the libraries of ``names`` that are not built yet, one nvcc
    process each, all started together; raises with nvcc's output if one
    fails. ``build.seconds`` holds each library's wall seconds from the
    start of its call to its nvcc's exit."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [n for n in names if not os.path.exists(library_path(n))]
        procs = []
        try:
            for name in todo:
                out = library_path(name)
                tmp = f"{out}.tmp{os.getpid()}"
                with open(log_path(name), "w") as log:
                    procs.append((name, tmp, out, subprocess.Popen(
                        [_nvcc(), *NVCC_FLAGS, "-o", tmp, source_path(name)],
                        stdout=log, stderr=subprocess.STDOUT)))
            failed = []
            t0, pending = time.perf_counter(), list(procs)
            while pending:
                for item in [p for p in pending if p[3].poll() is not None]:
                    name, tmp, out, proc = item
                    build.seconds[name] = time.perf_counter() - t0
                    pending.remove(item)
                    if proc.returncode == 0:
                        os.replace(tmp, out)
                    else:
                        failed.append(name)
                time.sleep(0.05)
        finally:
            for _, _, _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if failed:
            logs = []
            for name in failed:
                with open(log_path(name)) as f:
                    logs.append(f"--- nvcc {name} ---\n{f.read()}")
            raise RuntimeError("kernel build failed:\n" + "\n".join(logs))


build.seconds = {}


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed;
    ``signatures`` maps each launch function to its ``argtypes`` (each
    returns a CUDA error code as an int)."""
    with _loaded_lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            for fn_name, argtypes in signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


_occupancy: Dict[tuple, int] = {}


def cluster_occupancy(lib: ctypes.CDLL, fn: str, dev, *args: int) -> int:
    """The clusters that the card holds at once, by ``lib``'s ``fn`` (a
    ``cudaOccupancyMaxActiveClusters`` query whose last two ``args`` are the
    blocks a cluster and the shared-memory bytes a block, returning the count
    or minus the CUDA error), once a device and arguments; raises if the
    query fails or the card holds none."""
    key = (fn, dev, args)
    if key not in _occupancy:
        with torch.cuda.device(dev):
            got = getattr(lib, fn)(*args)
        check_launch(lib, max(-got, 0), fn)
        if got == 0:
            raise RuntimeError(f"the card holds no cluster of {args[-2]} "
                               f"blocks of {args[-1]} bytes ({fn})")
        _occupancy[key] = got
    return _occupancy[key]


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    """Validates one kernel argument before its pointer goes to C."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
