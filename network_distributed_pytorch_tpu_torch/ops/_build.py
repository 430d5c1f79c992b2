"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each library compiles from its ``csrc/*.cu`` sources (plain C interfaces)
into a shared object under the package's ``_build/`` directory
(git-ignored), named by a hash of those sources and of the headers they
include, so an edited kernel or header is never served from a stale build.
The fused PowerSGD library links K1's source too: K3's two-launch route
launches K1 itself, and K3's one-launch route runs K1's per-CTA code from
the shared header ``gram_schmidt_cta.cuh``. Flash attention's forward and
backward are two libraries sharing ``flash_attention_mma.cuh``. Nothing
here runs at import time: a wrapper calls :func:`load` (through
:class:`Kernel`) the first time it launches its kernel, and
``chip_smoke.py`` calls :func:`build_all` to compile every library in
parallel up front.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from typing import Dict, List, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# the kernel sources of each library of the port, by library name: the
# ``.cu`` files go to nvcc, and every file (headers too) enters the hash
SOURCES = {
    "gram_schmidt": ("gram_schmidt.cu", "gram_schmidt_cta.cuh"),
    "powersgd": ("powersgd.cu", "gram_schmidt.cu", "gram_schmidt_cta.cuh"),
    "flash_attention": ("flash_attention.cu", "flash_attention_mma.cuh"),
    "flash_attention_bwd": (
        "flash_attention_bwd.cu", "flash_attention_mma.cuh", "wgmma_bf16.cuh", "wgmma_tf32.cuh",
    ),
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES[name]:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def _start_build(name: str) -> "subprocess.Popen | None":
    """Start ``nvcc`` for one library unless it already exists.
    The output goes to a per-process temporary name and is renamed into
    place, so concurrent ranks never load a half-written library."""
    out = library_path(name)
    if os.path.isfile(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(os.path.join(CSRC, src) for src in SOURCES[name] if src.endswith(".cu"))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.out_path, proc.tmp_path = out, tmp  # type: ignore[attr-defined]
    return proc


def _finish_build(proc: "subprocess.Popen | None") -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(proc.tmp_path, proc.out_path)  # type: ignore[attr-defined]


def build_all() -> List[str]:
    """Compile every kernel library, one ``nvcc`` each, all started together.
    Returns the library paths."""
    procs = [_start_build(name) for name in SOURCES]
    for p in procs:
        _finish_build(p)
    return [library_path(name) for name in SOURCES]


_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            _finish_build(_start_build(name))
            lib = ctypes.CDLL(library_path(name))
            _LOADED[name] = lib
        return lib


class Kernel:
    """One C entry point of a kernel library, loaded on first use, and a
    count of its launches, so a run can show that its main path went
    through the kernel; ``by_kind`` splits the count by what the wrapper
    says of each launch (e.g. causal or masked). ``argtypes`` lists the
    entry's arguments before the stream, which :meth:`launch` appends."""

    def __init__(self, name: str, library: str, symbol: str, argtypes):
        self.name = name
        self.launches = 0
        self.by_kind: Counter = Counter()
        self._library, self._symbol = library, symbol
        self._argtypes = [*argtypes, ctypes.c_void_p]
        self._fn = None

    def reset(self) -> None:
        self.launches = 0
        self.by_kind.clear()

    def launch(self, device, *args, kind: Optional[str] = None) -> None:
        """Call the entry on ``device``'s current stream and count the
        launch (under ``kind`` too, where given); raise if CUDA refused it."""
        if self._fn is None:
            fn = getattr(load(self._library), self._symbol)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            err = self._fn(*args, torch.cuda.current_stream(device).cuda_stream)
        self.launches += 1
        if kind is not None:
            self.by_kind[kind] += 1
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with error {err}")
