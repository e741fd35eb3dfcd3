"""Builds the CUDA kernels of this package at first use and binds them with
ctypes.

Each `csrc/*.cu` file has a plain C interface (no PyTorch headers), so one
`nvcc -shared` per file takes seconds; all files are compiled in parallel
into `kernels/_build/` (listed in .gitignore) and each shared library is
loaded with `ctypes.CDLL`. Nothing is built or probed at import time: a
machine without `nvcc` can import this module, and only `library()` raises
there.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Optional, Sequence

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
SOURCES = ("paged_decode.cu", "paged_prefill.cu")
HEADERS = ("paged_attend.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}


class KernelCompileError(RuntimeError):
    pass


def find_nvcc() -> Optional[str]:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    return shutil.which("nvcc")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for f in (name,) + HEADERS:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _target(name: str) -> str:
    stem = os.path.splitext(name)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{_digest(name)}.so")


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every source in `names` that has no up-to-date library yet:
    one nvcc process per source, all started together. Returns
    {source: library path}. Raises KernelCompileError with the compiler's
    output if nvcc is missing or any compile fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = [n for n in names if not os.path.exists(_target(n))]
    if todo:
        nvcc = find_nvcc()
        if nvcc is None:
            raise KernelCompileError(
                "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/"
                "bin and PATH): the CUDA kernels cannot be built here")
        procs = []
        for n in todo:
            tmp = _target(n) + f".tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
                   os.path.join(CSRC, n)]
            procs.append((n, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for n, tmp, p in procs:
            out, _ = p.communicate()
            _logs[n] = out
            if p.returncode != 0:
                failed.append(f"--- {n} (exit {p.returncode})\n{out}")
            else:
                os.replace(tmp, _target(n))
        if failed:
            raise KernelCompileError("nvcc failed:\n" + "\n".join(failed))
    return {n: _target(n) for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of source `name`, building every kernel of
    the package first if this one is not built yet."""
    lib = _libs.get(name)
    if lib is None:
        paths = build_all(SOURCES)
        lib = _libs[name] = ctypes.CDLL(paths[name])
    return lib


def build_log(name: str) -> str:
    """nvcc's output (register and shared-memory use per kernel, from
    -Xptxas -v) for `name`; empty if it was not compiled in this process."""
    return _logs.get(name, "")


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer as a ctypes argument (None -> NULL)."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())
