"""The native (C++) host data runtime: its build and its ctypes bindings.

The port's own copy of the JAX package's ``native/`` runtime
(``dataloader.cpp``: the CIFAR-10 binary decoder, the fused gather and
normalise, the prefetching batch loader, the hash tokenizer and the
WordPiece matcher). ``build.py`` compiles it with ``g++`` at first use
into the package's ``_build/`` directory, keyed by the source's hash; a
plain C ABI bound through ctypes. ``NDP_TPU_NO_NATIVE=1``, or a toolchain
that fails, selects the numpy fallbacks, which give the same bytes.
"""

from .build import load_library, native_available
from .loader import (
    NativeBatchLoader,
    NativeWordPiece,
    decode_cifar10_bin,
    gather_normalize_u8,
    tokenize_hash,
)

__all__ = [
    "load_library",
    "native_available",
    "NativeBatchLoader",
    "NativeWordPiece",
    "decode_cifar10_bin",
    "gather_normalize_u8",
    "tokenize_hash",
]
