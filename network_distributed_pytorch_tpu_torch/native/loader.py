"""Python face of the native data runtime, the port's copy of the JAX
package's ``native/loader.py``.

Every entry point has a numpy fallback with the same semantics, so the
port runs where ``g++`` does not; the native path is the fast one
(multithreaded fused gather and normalise, the prefetching loader). The
fallback runs when the library cannot build or ``NDP_TPU_NO_NATIVE=1``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from .build import load_library

_N_THREADS = max(1, min(8, os.cpu_count() or 1))


def _pack_strings(chunks) -> Tuple[np.ndarray, np.ndarray]:
    """(byte buffer, int64 offsets[n+1]) for a list of byte strings — the
    flat layout every native string-consuming entry point takes. The buffer
    is 1 dummy byte when empty (ctypes needs a valid pointer)."""
    offsets = np.zeros(len(chunks) + 1, np.int64)
    if chunks:
        np.cumsum([len(b) for b in chunks], out=offsets[1:])
    blob = b"".join(chunks)
    buf = np.frombuffer(blob, np.uint8) if blob else np.zeros(1, np.uint8)
    return buf, offsets


def decode_cifar10_bin(
    records: np.ndarray,
    mean: float = 0.5,
    std: float = 0.5,
    out_images: Optional[np.ndarray] = None,
    out_labels: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode cifar-10-batches-bin records (n×3073 uint8: label byte + CHW
    pixels) to (NHWC float32 normalized, int32 labels). Pass ``out_images``
    / ``out_labels`` (C-contiguous, matching shape/dtype — e.g. slices of a
    larger preallocated dataset array) to decode IN PLACE with zero extra
    allocation; both are also the return value then."""
    records = np.ascontiguousarray(records, dtype=np.uint8)
    if records.ndim != 2 or records.shape[1] != 3073:
        raise ValueError(f"records must be (n, 3073) uint8, got {records.shape}")
    n = records.shape[0]
    if out_images is None:
        out_images = np.empty((n, 32, 32, 3), np.float32)
    if out_labels is None:
        out_labels = np.empty((n,), np.int32)
    # raise, don't assert (the _check_bounds convention): the native call
    # writes through raw pointers, so a wrong shape/dtype/layout under
    # ``python -O`` would be silent heap corruption, not a Python error
    if out_images.shape != (n, 32, 32, 3) or out_images.dtype != np.float32:
        raise ValueError(
            f"out_images must be float32 {(n, 32, 32, 3)}, got "
            f"{out_images.dtype} {out_images.shape}"
        )
    if out_labels.shape != (n,) or out_labels.dtype != np.int32:
        raise ValueError(
            f"out_labels must be int32 ({n},), got "
            f"{out_labels.dtype} {out_labels.shape}"
        )
    if not (out_images.flags.c_contiguous and out_labels.flags.c_contiguous):
        raise ValueError("out arrays must be C-contiguous")
    lib = load_library()
    if lib is not None:
        lib.ndp_decode_cifar10_bin(
            records.ctypes.data, n, mean, std, out_images.ctypes.data,
            out_labels.ctypes.data, _N_THREADS,
        )
        return out_images, out_labels
    out_labels[:] = records[:, 0].astype(np.int32)
    chw = records[:, 1:].reshape(n, 3, 32, 32).transpose(0, 2, 3, 1)
    out_images[:] = ((chw.astype(np.float32) / 255.0) - mean) / std
    return out_images, out_labels


def _check_bounds(idx: np.ndarray, n: int) -> None:
    # The native gathers do raw pointer arithmetic; an out-of-range index
    # would read OOB where the numpy fallback raises. Validate up front so
    # both paths fail identically.
    if len(idx) and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(f"index out of range for axis of size {n}")


def gather_normalize_u8(
    src: np.ndarray, idx: np.ndarray, mean: float = 0.5, std: float = 0.5
) -> np.ndarray:
    """``((src[idx]/255) - mean)/std`` as float32, fused in one native pass."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    _check_bounds(idx, len(src))
    row_elems = int(np.prod(src.shape[1:], dtype=np.int64))
    lib = load_library()
    if lib is not None:
        out = np.empty((len(idx),) + src.shape[1:], np.float32)
        lib.ndp_gather_normalize_u8(
            src.ctypes.data, idx.ctypes.data, len(idx), row_elems, mean, std,
            out.ctypes.data, _N_THREADS,
        )
        return out
    return ((src[idx].astype(np.float32) / 255.0) - mean) / std


def tokenize_hash(texts, vocab_size: int, max_len: int) -> Optional[dict]:
    """Native hash tokenization (``data.imdb.HashTokenizer``'s hot loop in
    multithreaded C++). Lowercasing AND whitespace splitting stay in Python
    (both Unicode-aware and C-speed in CPython — ``" ".join(t.split())``
    canonicalizes NBSP/NEL/etc to single spaces); the C++ side re-splits on
    the now-guaranteed ASCII spaces and FNV-1a-hashes the word bytes, which
    is the actually-hot loop. Token-for-token equal to the Python path for
    ALL input. Returns None when the native library is unavailable (caller
    falls back to the Python loop)."""
    lib = load_library()
    if lib is None:
        return None
    enc = [" ".join(t.lower().split()).encode("utf-8") for t in texts]
    buf, offsets = _pack_strings(enc)
    ids = np.zeros((len(enc), max_len), np.int32)
    mask = np.zeros((len(enc), max_len), np.int32)
    if enc:
        lib.ndp_tokenize_hash(
            buf.ctypes.data, offsets.ctypes.data, len(enc), vocab_size,
            max_len, _N_THREADS, ids.ctypes.data, mask.ctypes.data,
        )
    return {"input_ids": ids, "attention_mask": mask}


def _check_max_len(max_len: int) -> None:
    # the C encoders compute ``cap = max_len - 2`` ([CLS]/[SEP] slots); a
    # negative cap cast to size_t would be a multi-exabyte resize plus OOB
    # writes — reject before anything crosses the ctypes boundary
    if max_len < 2:
        raise ValueError(f"max_len must be >= 2 ([CLS] + [SEP]), got {max_len}")


class NativeWordPiece:
    """Native greedy longest-match WordPiece matcher over a built vocab
    hash table (``data.wordpiece.WordPieceTokenizer``'s hot loop in
    multithreaded C++). The Unicode normalization that PRODUCES the words
    stays in Python (``WordPieceTokenizer.basic_tokenize``); this matches
    pre-normalized words against the vocab. ``None``-returning factory when
    the native library is unavailable."""

    def __init__(self, lib, handle):
        import weakref

        self._lib = lib
        self._handle = handle
        # free the C-side table when the Python object dies
        self._finalizer = weakref.finalize(
            self, lib.ndp_wordpiece_free, handle
        )

    @classmethod
    def build(cls, vocab_tokens) -> Optional["NativeWordPiece"]:
        """``vocab_tokens``: token strings in id order (line order)."""
        lib = load_library()
        if lib is None:
            return None
        buf, offsets = _pack_strings([t.encode("utf-8") for t in vocab_tokens])
        handle = lib.ndp_wordpiece_build(
            buf.ctypes.data, offsets.ctypes.data, len(vocab_tokens)
        )
        return cls(lib, handle) if handle else None

    def encode(
        self,
        words_per_text,
        unk_id: int,
        cls_id: int,
        sep_id: int,
        pad_id: int,
        max_len: int,
        max_word_chars: int = 100,
    ) -> dict:
        """HF-style (input_ids, attention_mask) for pre-normalized words.
        Words over ``max_word_chars`` become a lone 0xff byte — invalid
        UTF-8, never in a vocab — so the C side's no-tiling rule emits the
        same whole-word [UNK] the Python matcher does."""
        _check_max_len(max_len)
        flat = []
        counts = np.zeros(len(words_per_text), np.int64)
        for i, words in enumerate(words_per_text):
            counts[i] = len(words)
            flat += [
                w.encode("utf-8") if len(w) <= max_word_chars else b"\xff"
                for w in words
            ]
        buf, offsets = _pack_strings(flat)
        n = len(words_per_text)
        ids = np.zeros((n, max_len), np.int32)
        mask = np.zeros((n, max_len), np.int32)
        if n:
            self._lib.ndp_wordpiece_encode(
                self._handle, buf.ctypes.data, offsets.ctypes.data,
                counts.ctypes.data, n, unk_id, cls_id, sep_id, pad_id,
                max_len, _N_THREADS, ids.ctypes.data, mask.ctypes.data,
            )
        return {"input_ids": ids, "attention_mask": mask}

    def encode_ascii(
        self,
        texts,
        unk_id: int,
        cls_id: int,
        sep_id: int,
        pad_id: int,
        max_len: int,
        max_word_chars: int = 100,
    ) -> dict:
        """One-pass normalize + match for RAW ASCII texts — normalization is
        the real hot loop (measured ~16× the match time in Python), and for
        ASCII input the BERT rules reduce to byte rules done in C++
        (``ndp_wordpiece_encode_ascii``). Callers must route non-ASCII rows
        to the Python normalizer (``WordPieceTokenizer.__call__`` does)."""
        _check_max_len(max_len)
        enc = [t.encode("ascii") for t in texts]
        buf, offsets = _pack_strings(enc)
        n = len(texts)
        ids = np.zeros((n, max_len), np.int32)
        mask = np.zeros((n, max_len), np.int32)
        if n:
            self._lib.ndp_wordpiece_encode_ascii(
                self._handle, buf.ctypes.data, offsets.ctypes.data, n,
                unk_id, cls_id, sep_id, pad_id, max_len, max_word_chars,
                _N_THREADS, ids.ctypes.data, mask.ctypes.data,
            )
        return {"input_ids": ids, "attention_mask": mask}


class NativeBatchLoader:
    """Prefetching batch loader over an in-memory (x, y) dataset.

    Same batch semantics as ``data.loader.iterate_batches`` (seeded epoch
    shuffle, static shapes, drop-last) — asserted equal in
    ``tests/test_torch_native_loader.py`` — but batch
    assembly runs on a C++ worker thread that stays one-to-``depth`` batches
    ahead of the training loop. ``x`` may be uint8 (normalize fused into the
    native gather — the dataset then lives in memory at 1 byte/elem instead
    of 4) or float32 (plain gather).
    """

    def __init__(
        self,
        x: np.ndarray,
        y: np.ndarray,
        batch_size: int,
        seed: int = 0,
        shuffle: bool = True,
        mean: float = 0.5,
        std: float = 0.5,
        depth: int = 2,
    ):
        if len(x) != len(y):
            raise ValueError("batch arrays must be aligned")
        if x.dtype not in (np.uint8, np.float32):
            raise ValueError(f"x must be uint8 or float32, got {x.dtype}")
        if not np.issubdtype(y.dtype, np.integer):
            raise ValueError(f"labels must be integer (classification targets), got {y.dtype}")
        self._x = np.ascontiguousarray(x)
        self._y = np.ascontiguousarray(
            y.reshape(len(y), -1) if y.ndim > 1 else y[:, None], np.int32
        )
        self._y_shape = y.shape[1:]
        self._batch = batch_size
        self._seed = seed
        self._shuffle = shuffle
        self._mean, self._std = mean, std
        self._depth = depth
        self._lib = load_library()
        # pipeline counters of the most recently exhausted epoch (see epoch())
        self.last_stats: Optional[dict] = None

    @classmethod
    def maybe_create(
        cls, arrays, batch_size: int, seed: int = 0
    ) -> Optional["NativeBatchLoader"]:
        """The eligibility contract, next to the semantics it encodes: a
        plain ``(x, y)`` pair with float32 features and integer labels is
        byte-identical between this loader and ``iterate_batches`` (u8
        features are NOT eligible here — the loader's fused normalize would
        change what raw-u8 callers see). Returns None when ineligible, so
        call sites need no condition block of their own."""
        if len(arrays) != 2:
            return None
        x, y = arrays
        if getattr(x, "dtype", None) != np.float32:
            return None
        if not np.issubdtype(getattr(y, "dtype", np.float64), np.integer):
            return None
        return cls(x, y, batch_size, seed=seed)

    def _order(self, epoch: int) -> np.ndarray:
        from ..data.loader import epoch_order  # the one source of semantics

        return epoch_order(
            len(self._x), self._batch, self._seed, epoch, self._shuffle
        ).astype(np.int64)

    def epoch(
        self, epoch: int = 0, order: Optional[np.ndarray] = None
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (x_f32, y) batches for one epoch, prefetched natively.

        ``order`` overrides the seeded-shuffle permutation with an explicit
        index sequence — the streamed-elastic-index hook: a rank hands the
        loader exactly the ``data.partition.ElasticIndexStream`` window it
        owns (already cursor-resumed, already resharded), and the native
        assembly pipeline runs unchanged. Truncated to whole batches,
        matching ``epoch_order``'s ``drop_last`` semantics.

        After exhaustion (or when the generator is closed early: the worker
        thread is joined then too), :attr:`last_stats` carries the pipeline counters
        (batches emitted, time the consumer spent blocked on assembly,
        which path ran) for :class:`observe.events.LoaderEvent`.
        """
        if order is None:
            order = self._order(epoch)
        else:
            order = np.ascontiguousarray(np.asarray(order, np.int64))
            if order.size and (
                order.min() < 0 or int(order.max()) >= len(self._x)
            ):
                raise ValueError("explicit order index out of range")
            order = order[: (len(order) // self._batch) * self._batch]
        if self._lib is None:
            yield from self._epoch_fallback(order)
            return
        is_u8 = self._x.dtype == np.uint8
        row_elems = int(np.prod(self._x.shape[1:], dtype=np.int64))
        y_elems = self._y.shape[1]
        handle = self._lib.ndp_loader_create(
            self._x.ctypes.data if is_u8 else None,
            None if is_u8 else self._x.ctypes.data,
            self._y.ctypes.data, row_elems, y_elems, self._mean, self._std,
            order.ctypes.data, len(order), self._batch, self._depth,
            _N_THREADS,
        )
        try:
            while True:
                bx = np.empty((self._batch,) + self._x.shape[1:], np.float32)
                by = np.empty((self._batch, y_elems), np.int32)
                if not self._lib.ndp_loader_next(
                    handle, bx.ctypes.data, by.ctypes.data
                ):
                    break
                yield bx, by.reshape((self._batch,) + self._y_shape)
        finally:
            stats = (ctypes.c_longlong * 3)()
            self._lib.ndp_loader_stats(handle, stats)
            self.last_stats = {
                "native": True,
                "batches": int(stats[0]),
                "consumer_wait_s": stats[1] / 1e9,
                "n_batches": int(stats[2]),
            }
            self._lib.ndp_loader_destroy(handle)

    def _epoch_fallback(
        self, order: np.ndarray
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        emitted = 0
        for start in range(0, len(order), self._batch):
            sel = order[start : start + self._batch]
            bx = (
                gather_normalize_u8(self._x, sel, self._mean, self._std)
                if self._x.dtype == np.uint8
                else self._x[sel]
            )
            yield bx, self._y[sel].reshape((len(sel),) + self._y_shape)
            emitted += 1
        self.last_stats = {
            "native": False,
            "batches": emitted,
            "consumer_wait_s": 0.0,
            "n_batches": len(order) // self._batch,
        }

    def steps_per_epoch(self) -> int:
        return len(self._x) // self._batch
