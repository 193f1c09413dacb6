"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with ``ctypes``.  The build
happens at first use, into ``_build/`` beside this file (git-ignored); the
library name carries a hash of its source and of the shared ``csrc/*.cuh``
headers, so an edited source is rebuilt and a stale library is never
loaded.  All sources build in parallel, one
``nvcc`` each.

Nothing is built or loaded on import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
# Each entry point: (library, C function, argtypes).  A library is built from
# ``csrc/<library>.cu``; every entry point returns the error of its launches
# (0 = success), which ``check`` turns into an exception.
SIGNATURES = {
    "token_transformer": ("token_transformer", "tt_forward",
                          [_P] * 18 + [_I] * 4 + [_P]),
    "layer_gemm": ("token_transformer", "tt_gemm", [_P] * 5 + [_I] * 4 + [_P]),
    # the same on a tile named by its index (measurement: chip_profile.py)
    "layer_gemm_tile": ("token_transformer", "tt_gemm_tile",
                        [_P] * 5 + [_I] * 5 + [_P]),
    "nms_greedy": ("nms_greedy", "nms_greedy_forward",
                   [_P] * 6 + [_I] * 3 + [_F, _P]),
    "cem": ("cem", "cem_forward", [_P] * 3 + [_I] * 4 + [_P]),
    "gpt_merge": ("gpt_merge", "gpt_merge_forward", [_P] * 26 + [_I] * 7 + [_P]),
    # the ports of the TPU probes under tools/ (mmidet_tpu_torch/tools/)
    "conv_chain": ("conv_chain", "conv_chain_forward",
                   [_P] * 4 + [_I] * 4 + [_P]),
    # P1's launch shape: persistent blocks, tiles, shared memory, ring
    "conv_chain_config": ("conv_chain", "conv_chain_config",
                          [_I] * 4 + [_P]),
    "halo_sum": ("cem_probes", "halo_sum_forward", [_P] * 2 + [_I] * 3 + [_P]),
    "lane_matmul": ("cem_probes", "lane_matmul_forward",
                    [_P] * 3 + [_I] * 2 + [_P]),
}
LIBRARIES = tuple(sorted({lib for lib, _, _ in SIGNATURES.values()}))

_loaded: dict[str, ctypes.CDLL] = {}  # by library
_entry: dict[str, object] = {}  # C functions, argtypes set, by entry point


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _lib_path(name: str) -> Path:
    # the shared headers count for every library that may include them
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha1(b"".join(p.read_bytes() for p in sources)
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def build_all() -> float:
    """Compile every source whose library is missing, all at once.
    Returns the wall seconds taken; raises with nvcc's output on failure."""
    t0 = time.perf_counter()
    todo = [n for n in LIBRARIES if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD.mkdir(exist_ok=True)
    procs = {}
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(_log_path(name), "w")
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
            failed.append(f"{name}:\n{_log_path(name).read_text()}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def _log_path(name: str) -> Path:
    # named after the library it built, so a kept library keeps its report
    return _lib_path(name).with_suffix(".log")


def build_log(name: str) -> str:
    """nvcc's output (with ``-Xptxas -v``: registers, shared memory,
    spills) from the build of library ``name`` as its sources stand now
    ("" when that library was not built in this checkout)."""
    p = _log_path(name)
    return p.read_text() if p.exists() else ""


def ptxas_report(name: str) -> list[dict]:
    """Per kernel of library ``name``'s last build: ptxas's registers, spill
    bytes (stores, loads) and whether it serialised the kernel's wgmma
    instructions (its performance warning C7520), from ``build_log``."""
    log = build_log(name)
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"kernel": m.group(1), "wgmma_serialized": any(
                "C7520" in ln and m.group(1) in ln
                for ln in log.splitlines())}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def load(name: str):
    """The C function of entry point ``name``, its library built if
    needed."""
    fn = _entry.get(name)
    if fn is not None:
        return fn
    if not torch.cuda.is_available():
        raise RuntimeError(f"kernel {name!r} needs a CUDA device")
    lib, fn_name, argtypes = SIGNATURES[name]
    if lib not in _loaded:
        if not _lib_path(lib).exists():
            build_all()
        _loaded[lib] = ctypes.CDLL(str(_lib_path(lib)))
    fn = getattr(_loaded[lib], fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _entry[name] = fn
    return fn


def check(name: str, err: int) -> None:
    """Raise if entry point ``name`` returned an error (``cudaGetLastError``
    after each launch, or one of the C code's own, inside the C function)."""
    if err:
        msg = _loaded[SIGNATURES[name][0]].error_string
        msg.argtypes, msg.restype = [_I], ctypes.c_char_p
        raise RuntimeError(f"kernel {name!r} launch failed: error {err} "
                           f"({msg(err).decode()})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def stamp(tensors) -> tuple:
    """What tells two states of ``tensors`` apart between calls: each one's
    storage address, dtype and in-place version.  A caller that keeps
    kernel-ready copies of its parameters rebuilds them when this changes
    (``.to()`` moves the storage; ``copy_``, ``load_state_dict`` and an
    optimiser step raise the version).  Inference tensors count no
    versions: they cannot be written outside inference mode."""
    return tuple((t.data_ptr(), t.dtype,
                  None if t.is_inference() else t._version) for t in tensors)
