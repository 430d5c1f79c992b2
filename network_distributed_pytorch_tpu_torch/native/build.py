"""Compile and load the native runtime (``g++`` to a shared object, ctypes).

Built once per source hash into the package's ``_build/`` directory (the
CUDA kernels' too, ``ops/_build.py``). Processes that build at once (such
as parallel test workers) race benignly: each compiles to a temporary name
and renames it atomically into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dataloader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False

# Portable flags: -march=native would bake this host's instruction set into
# a cached object that another machine may load. -O3 vectorises for the
# baseline set; the gathers are bound by memory anyway.
_CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]


def so_path() -> str:
    """Where the library of this source and these flags is (or will be) built."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_CXX_FLAGS).encode())  # a change of flags is a new build
    return os.path.join(BUILD_DIR, f"ndp_native_{h.hexdigest()[:16]}.so")


def _compile(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *_CXX_FLAGS, _SRC, "-o", tmp], check=True, capture_output=True, text=True)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_library() -> Optional[ctypes.CDLL]:
    """The loaded native library, built if needed; None when disabled
    (``NDP_TPU_NO_NATIVE=1``) or when ``g++`` or the build fails. One
    attempt a process."""
    global _lib, _load_attempted
    if _lib is not None:
        return _lib
    if _load_attempted:
        return None
    _load_attempted = True
    if os.environ.get("NDP_TPU_NO_NATIVE") == "1":
        return None
    try:
        path = so_path()
        if not os.path.exists(path):
            _compile(path)
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            # a build left by another machine (a copied tree) that this one
            # cannot load: build it here, once
            _compile(path)
            lib = ctypes.CDLL(path)
        _declare(lib)
        _lib = lib
    except (OSError, subprocess.CalledProcessError):
        return None
    return _lib


def native_available() -> bool:
    return load_library() is not None


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.ndp_decode_cifar10_bin.argtypes = [c.c_void_p, c.c_int64, c.c_float, c.c_float, c.c_void_p, c.c_void_p, c.c_int]
    lib.ndp_decode_cifar10_bin.restype = None
    lib.ndp_gather_normalize_u8.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int64, c.c_int64, c.c_float, c.c_float, c.c_void_p, c.c_int,
    ]
    lib.ndp_gather_normalize_u8.restype = None
    lib.ndp_gather_f32.argtypes = [c.c_void_p, c.c_void_p, c.c_int64, c.c_int64, c.c_void_p, c.c_int]
    lib.ndp_gather_f32.restype = None
    lib.ndp_gather_i32.argtypes = list(lib.ndp_gather_f32.argtypes)
    lib.ndp_gather_i32.restype = None
    lib.ndp_loader_create.argtypes = [
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64, c.c_int64, c.c_float, c.c_float, c.c_void_p, c.c_int64,
        c.c_int64, c.c_int64, c.c_int,
    ]
    lib.ndp_loader_create.restype = c.c_void_p
    lib.ndp_loader_next.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p]
    lib.ndp_loader_next.restype = c.c_int
    lib.ndp_loader_destroy.argtypes = [c.c_void_p]
    lib.ndp_loader_destroy.restype = None
    lib.ndp_loader_stats.argtypes = [c.c_void_p, c.POINTER(c.c_longlong)]
    lib.ndp_loader_stats.restype = None
    lib.ndp_tokenize_hash.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int64, c.c_int32, c.c_int32, c.c_int, c.c_void_p, c.c_void_p,
    ]
    lib.ndp_tokenize_hash.restype = None
    lib.ndp_wordpiece_build.argtypes = [c.c_void_p, c.c_void_p, c.c_int64]
    lib.ndp_wordpiece_build.restype = c.c_void_p
    lib.ndp_wordpiece_free.argtypes = [c.c_void_p]
    lib.ndp_wordpiece_free.restype = None
    lib.ndp_wordpiece_encode.argtypes = [
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64, c.c_int32, c.c_int32, c.c_int32, c.c_int32,
        c.c_int32, c.c_int, c.c_void_p, c.c_void_p,
    ]
    lib.ndp_wordpiece_encode.restype = None
    lib.ndp_wordpiece_encode_ascii.argtypes = [
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64, c.c_int32, c.c_int32, c.c_int32, c.c_int32, c.c_int32,
        c.c_int32, c.c_int, c.c_void_p, c.c_void_p,
    ]
    lib.ndp_wordpiece_encode_ascii.restype = None
