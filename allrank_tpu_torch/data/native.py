"""ctypes bindings of the host C++ libraries in ``allrank_tpu_torch/native``:
the libsvm parser, the slate batch assembler and the libsvm writer (the JAX
package's ``data/native.py``).

Each library is built with g++ at first use, from the port's own
``native/<name>.cpp``, into ``build/allrank_tpu_torch/``, named after a digest
of its source and flags, so an edited source is rebuilt and a stale one is
never loaded. A file lock keeps two processes from building at once; the
library is published by an atomic rename. A build that fails, or cannot run
for want of g++, raises with g++'s output: there is no fallback to the numpy
parser or the Python row loop. Those stay as the plain versions, chosen by
name (``parse_svmlight(..., backend="numpy")``, ``SlateBatcher(...,
assembly="python")``, ``write_to_libsvm_without_masked(..., writer=
"python")``). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from allrank_tpu_torch.ops._build import BUILD_DIR, PACKAGE_DIR

NATIVE_DIR = os.path.join(PACKAGE_DIR, "native")
# the JAX package's flags: no -march=native, so a library built on one host
# runs on another
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-Wall")

_loaded: Dict[str, ctypes.CDLL] = {}
_loaded_lock = threading.Lock()


def source_path(name: str) -> str:
    return os.path.join(NATIVE_DIR, name + ".cpp")


def library_path(name: str, build_dir: str = BUILD_DIR) -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(source_path(name), "rb") as f:
        digest.update(f.read())
    return os.path.join(build_dir, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(name: str, build_dir: str = BUILD_DIR) -> str:
    """Compile ``native/<name>.cpp`` with g++ unless its library is built;
    returns the library's path. Raises ``RuntimeError`` with g++'s output
    when the build fails, or when there is no g++ on ``PATH``."""
    out = library_path(name, build_dir)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):  # another process built it meanwhile
            return out
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(
                f"g++ not found on PATH: the host library {name} is built "
                f"from {source_path(name)} at first use")
        tmp = f"{out}.tmp{os.getpid()}"
        proc = subprocess.run([gxx, *CXX_FLAGS, "-o", tmp, source_path(name)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise RuntimeError(f"g++ build of {name} failed "
                               f"({proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    return out


_F32 = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_I64 = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_SIGNATURES = {
    "libsvm_parser": {
        "parse_svmlight_count": [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_int64),
                                 ctypes.POINTER(ctypes.c_int64)],
        "parse_svmlight_fill": [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.c_int64, _F32, _F32, _I64],
    },
    "slate_assembler": {
        "assemble_rows": [
            _F32, _F32, _I64, _I64, _I64, _I64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64, ctypes.c_int64,
            _F32, _F32,
            np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")],
    },
    "libsvm_writer": {
        "write_svmlight": [_F32, _F32, _I64, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_char_p, ctypes.c_int64],
    },
}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed; every function
    of it returns an int64 status."""
    with _loaded_lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            for fn_name, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int64
            _loaded[name] = lib
        return lib


def parse_svmlight_native(
        path: str, x_alloc: Optional[Callable[[int, int], np.ndarray]] = None
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(X dense [N, F] float32, y [N] float32, qids [N] int64) of a libsvm
    file by the C++ parser, or None where the parser declines the file by
    its return code (unreadable, malformed, no row, or no feature at all):
    the caller then reads it with the numpy parser, as the JAX package's
    goes to scikit-learn's.

    ``x_alloc(n_rows, n_features)`` optionally supplies the zero-filled
    C-contiguous float32 buffer that the fill pass writes into (the binary
    cache passes a writable ``np.memmap`` over its future ``.npy`` file)."""
    lib = load("libsvm_parser")
    n_rows, n_features = ctypes.c_int64(), ctypes.c_int64()
    if lib.parse_svmlight_count(os.fsencode(path), ctypes.byref(n_rows),
                                ctypes.byref(n_features)) != 0:
        return None
    shape = (n_rows.value, n_features.value)
    X = (np.zeros(shape, dtype=np.float32) if x_alloc is None
         else x_alloc(*shape))
    if X.shape != shape:
        raise ValueError(f"x_alloc gave {X.shape}, the file needs {shape}")
    y = np.zeros((n_rows.value,), dtype=np.float32)
    qids = np.zeros((n_rows.value,), dtype=np.int64)
    if lib.parse_svmlight_fill(os.fsencode(path), n_rows.value,
                               n_features.value, X, y, qids) != 0:
        return None
    return X, y, qids


def assemble_rows_native(X, y, offsets, rows, slates, rng_ids, n_features,
                         slate_length, seed_base, n_threads, out_x, out_y,
                         out_idx, out_mask) -> None:
    """Fill rows ``rows`` of a batch with slates ``slates`` of the flat
    buffers (X, y, offsets) by the C++ assembler, slate fixing drawn from
    the splitmix64 stream of (``seed_base``, ``rng_ids``), on ``n_threads``
    threads (the rows split evenly; the bytes do not depend on it). The
    output buffers arrive filled with zeros and padding values."""
    load("slate_assembler").assemble_rows(
        X, y, offsets, rows, slates, rng_ids, len(rows), n_features,
        slate_length, seed_base & 0xFFFFFFFFFFFFFFFF, max(1, int(n_threads)),
        out_x, out_y, out_idx, out_mask.view(np.uint8))


def write_svmlight_native(X: np.ndarray, y: np.ndarray, qid: np.ndarray,
                          path: str, n_threads: int = 0) -> None:
    """Write ``label qid:Q i:v ...`` lines by the C++ writer: zero-based
    indices, zeros omitted, each float in its shortest round-trip form, an
    explicit ``0:0`` on the first line where column 0 is zero in every row
    (base pinning). Raises ``OSError`` when the file cannot be written."""
    X = np.ascontiguousarray(X, dtype=np.float32)
    y = np.ascontiguousarray(y, dtype=np.float32)
    qid = np.ascontiguousarray(qid, dtype=np.int64)
    if X.ndim != 2 or y.shape != (X.shape[0],) or qid.shape != y.shape:
        raise ValueError(f"X [N, F], y [N] and qid [N] expected, got "
                         f"{X.shape}, {y.shape}, {qid.shape}")
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    rc = load("libsvm_writer").write_svmlight(
        X, y, qid, X.shape[0], X.shape[1], os.fsencode(path), n_threads)
    if rc != 0:
        raise OSError(f"the libsvm writer failed on {path} (code {rc}: 1 "
                      f"no feature column, 2 cannot open, 3 write error)")
