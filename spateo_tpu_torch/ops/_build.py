"""Build the port's CUDA sources at first use and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
into `spateo_tpu_torch/_build/lib<name>-<hash>.so`, where the hash covers
the source, every file beside it that it includes with `#include "..."`
(recursively), and the flags: an edited source or header builds anew, an
unchanged one loads the library already built. Nothing is compiled while a
module is imported; `load(name)` compiles on its first call in a process. A
missing `nvcc` or a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(f"nvcc not found on PATH or under {cuda_home}; the CUDA kernels cannot be built")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_digest(src: Path, flags=NVCC_FLAGS) -> str:
    """Hash of `src`, of each file it includes with quotes (looked up beside
    the including file, recursively, each once; a name not found there is a
    header of the toolkit's include path) and of `flags`."""
    h = hashlib.sha256(" ".join(flags).encode())
    Path(src).stat()  # a missing source raises here
    seen, todo = set(), [Path(src)]
    while todo:
        path = todo.pop(0).resolve()
        if path in seen or not path.is_file():
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(str(path.name).encode() + b"\0" + text)
        todo.extend(path.parent / inc.decode() for inc in _LOCAL_INCLUDE.findall(text))
    return h.hexdigest()[:16]


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless a library of the same source,
    headers and flags exists; return the library's path."""
    src = CSRC / f"{name}.cu"
    digest = source_digest(src)
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name and rename: a concurrent build of the same
    # source never sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library built from `csrc/<name>.cu`, built on first use."""
    return ctypes.CDLL(str(build(name)))
