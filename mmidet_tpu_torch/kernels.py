"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with ``ctypes``.  The build
happens at first use, into ``_build/`` beside this file (git-ignored); the
library name carries a hash of its source, so an edited source is rebuilt
and a stale library is never loaded.  All sources build in parallel, one
``nvcc`` each.

Nothing is built or loaded on import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of each library's entry point: (name, argtypes); every entry
# point returns the cudaError_t of its launches (0 = success)
SIGNATURES = {
    "token_transformer": ("tt_forward", [_P] * 18 + [_I] * 4 + [_P]),
    "nms_greedy": ("nms_greedy_forward", [_P] * 4 + [_I] * 3 + [_F, _P]),
}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def build_all() -> float:
    """Compile every source whose library is missing, all at once.
    Returns the wall seconds taken; raises with nvcc's output on failure."""
    t0 = time.perf_counter()
    todo = [n for n in SIGNATURES if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD.mkdir(exist_ok=True)
    procs = {}
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name}:\n{(BUILD / f'{name}.log').read_text()}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (with ``-Xptxas -v``: registers, shared memory,
    spills) from the last build of ``name`` in this checkout."""
    p = BUILD / f"{name}.log"
    return p.read_text() if p.exists() else ""


def load(name: str):
    """The C entry point of kernel library ``name``, built if needed."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"kernel {name!r} needs a CUDA device")
    if name not in _loaded:
        if not _lib_path(name).exists():
            build_all()
        _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
    fn_name, argtypes = SIGNATURES[name]
    fn = getattr(_loaded[name], fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError`` after
    each launch, inside the C entry point)."""
    if err:
        msg = _loaded[name].error_string
        msg.argtypes, msg.restype = [_I], ctypes.c_char_p
        raise RuntimeError(f"kernel {name!r} launch failed: cudaError {err} "
                           f"({msg(err).decode()})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
