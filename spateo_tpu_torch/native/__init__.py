"""The host C++ MRF solver `Mesh_correction` calls (counterpart of
`spateo_tpu.native`; the reference links a compiled `libfastpd`,
morpho_mesh_correction.py:32).

`fastpd.cpp` is a copy of the JAX package's source. It is compiled with
`g++` on its first use in a process into
`spateo_tpu_torch/_build/libfastpd-<hash>.so` (the hash covers the source
and the flags; an unchanged source loads the library already built) and
loaded with ctypes. A missing compiler or a failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "fastpd.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def build() -> Path:
    """Compile `fastpd.cpp` unless a library of the same source and flags
    exists; return the library's path."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libfastpd-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.fastpd_solve.restype = ctypes.c_double
    lib.fastpd_solve.argtypes = [
        ctypes.c_int,
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_int,
        ctypes.c_uint64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    return lib


def fastpd(unaries: np.ndarray, binaries, pairs: np.ndarray, n_iter: int = 100, seed: int = 0) -> np.ndarray:
    """Solve a pairwise MRF: argmin_x sum_v u[x_v, v] + sum_p b_p[x_i, x_j].

    Signature-compatible with the reference's `libfastpd.fastpd`
    (morpho_mesh_correction.py:319): `unaries` is [L, N], `binaries` a list
    of [L, L] tables (one per pair), `pairs` an [P, 2] int array. Returns the
    [N] label assignment. Exact for small problems, ICM-with-restarts beyond.
    """
    u = np.ascontiguousarray(np.asarray(unaries, np.float32))
    L, N = u.shape
    p = np.ascontiguousarray(np.asarray(pairs, np.int32))
    b = np.ascontiguousarray(np.stack([np.asarray(t, np.float32) for t in binaries]))
    if b.shape != (len(p), L, L):
        raise ValueError(f"binaries must be [n_pairs, L, L]; got {b.shape}")
    out = np.zeros(N, np.int32)
    _lib().fastpd_solve(N, L, u, len(p), p.reshape(-1), b.reshape(-1), int(n_iter), int(seed), out)
    return out
