"""ctypes bindings for the native C++ batched decode+letterbox loader
(``native/fastloader.cpp``) with a PIL fallback.

Counterpart of ``mmidet_tpu/data/native.py``.  One C call decodes and
letterboxes a whole batch into a preallocated buffer on a GIL-free
``std::thread`` pool.  The resize is cv2-style non-antialiased half-pixel
bilinear, so this leg and the PIL one (``letterbox_np``) differ at edges.

The library is built at first use from ``native/fastloader.cpp`` (read
only) with ``native/build.sh``'s flags into ``_build/`` beside this
package (git-ignored), under a name that carries a hash of the source and
the flags.  When it cannot be built (no ``g++``, ``libjpeg`` or
``libpng``), ``load_library`` returns None and the loaders decode with PIL:
the choice of decoder, not of device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from mmidet_tpu_torch.data.datasets import letterbox_np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "fastloader.cpp"
BUILD = Path(__file__).resolve().parents[1] / "_build"
# native/build.sh's command line
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]
LINK_FLAGS = ["-ljpeg", "-lpng", "-lpthread"]

_LIB = None
_TRIED = False


def lib_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(
        CXX_FLAGS + LINK_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"libfastloader-{digest}.so"


def _build(path: Path) -> bool:
    BUILD.mkdir(exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp),
                        *LINK_FLAGS], check=True, capture_output=True,
                       timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    return True


def load_library(build_if_missing: bool = True):
    """Load (building on first use if needed) the shared library; returns
    None when it is unavailable: callers decode with PIL."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not SOURCE.is_file():
        return None
    path = lib_path()
    if not path.is_file() and not (build_if_missing and _build(path)):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.fl_batch_decode.restype = ctypes.c_int
    lib.fl_batch_decode.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int]
    _LIB = lib
    return _LIB


def available() -> bool:
    return load_library() is not None


def batch_decode_letterbox(paths: list[str], img_size: int,
                           n_threads: int = 0, scaleup: bool = True):
    """Decode + letterbox a batch natively.

    Returns (images (N, S, S, 3) uint8, meta (N, 3) float32 [r, dw, dh]).
    ``scaleup=False`` clamps the resize ratio to <=1 (reference VAL-time
    letterbox).  Decodes with PIL per image when the library is
    unavailable."""
    lib = load_library()
    n = len(paths)
    out = np.empty((n, img_size, img_size, 3), np.uint8)
    meta = np.empty((n, 3), np.float32)
    if lib is not None:
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        lib.fl_batch_decode(
            arr, n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), img_size,
            meta.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads,
            int(scaleup))
        return out, meta
    from PIL import Image
    for i, p in enumerate(paths):
        im0 = np.asarray(Image.open(p).convert("RGB"))
        lb, r, (dw, dh) = letterbox_np(im0, (img_size, img_size),
                                       scaleup=scaleup)
        out[i] = lb
        meta[i] = (r, dw, dh)
    return out, meta
