"""ctypes bindings for the native (C++) ingestion kernels.

Built lazily with g++ on first use from the committed ``repack.cpp`` into a
build directory outside the package source (``build/native`` beside the
package, listed in .gitignore).  The library's file name carries a hash of
the source, the compile command and the machine architecture, so a library
built from other sources, flags or for another architecture is never
loaded.  All callers fall back to the numpy path when no compiler is
available (`repack_bed` returns None)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "repack.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "native")
# portable code generation: no -march=native, so the library runs on any
# CPU of the architecture it was built for
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lock = threading.Lock()
_lib = None
_tried = False


def library_path(src: str = _SRC, flags=_FLAGS) -> str:
    """Build-directory path of the library for this source text, these
    flags and this machine architecture."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(("g++",) + tuple(flags)).encode())
    h.update(platform.machine().encode())
    return os.path.join(BUILD_DIR, f"_repack-{h.hexdigest()[:16]}.so")


def _build() -> str | None:
    lib = library_path()
    if os.path.isfile(lib):
        return lib
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, _SRC, "-o", tmp]
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return lib
    except (subprocess.SubprocessError, OSError):
        return None


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.mendeliht_repack_bed.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
        lib.mendeliht_repack_bed.restype = None
        lib.mendeliht_pack_codes_bed.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int32]
        lib.mendeliht_pack_codes_bed.restype = None
        lib.mendeliht_quad_words.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int32]
        lib.mendeliht_quad_words.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def repack_bed(bed: np.ndarray, n: int, p: int, n4: int,
               n_threads: int | None = None):
    """.bed payload -> (packed (p, n4) uint8 crumb-transposed,
    counts (p, 3) int64 [het, alt, missing]); None if native lib unavailable."""
    lib = _load()
    if lib is None:
        return None
    bed = np.ascontiguousarray(bed, dtype=np.uint8)
    out = np.empty((p, n4), np.uint8)
    counts = np.empty((p, 3), np.int64)
    nt = n_threads or min(os.cpu_count() or 1, 32)
    lib.mendeliht_repack_bed(
        bed.ctypes.data, n, p, n4, out.ctypes.data, counts.ctypes.data, nt)
    return out, counts


def quad_words(packed: np.ndarray, n_threads: int | None = None):
    """(p, n4) crumb-transposed bytes -> (ceil(p/4), n4) int32 SNP-quad
    words (the canonical device layout); None if native lib unavailable."""
    lib = _load()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    p, n4 = packed.shape
    out = np.empty((-(-p // 4), n4), np.dtype("<i4"))
    nt = n_threads or min(os.cpu_count() or 1, 32)
    lib.mendeliht_quad_words(packed.ctypes.data, p, n4, out.ctypes.data, nt)
    return out


def pack_codes_bed(codes: np.ndarray, n_threads: int | None = None):
    """(n, p) code matrix -> .bed payload bytes; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n, p = codes.shape
    bpr = -(-n // 4)
    bed = np.empty(p * bpr, np.uint8)
    nt = n_threads or min(os.cpu_count() or 1, 32)
    lib.mendeliht_pack_codes_bed(codes.ctypes.data, n, p, bed.ctypes.data, nt)
    return bed
