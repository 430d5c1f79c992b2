"""WordPiece tokenizer (BERT/DistilBERT scheme), the port's own copy of the
JAX package's ``data/wordpiece.py``.

The reference tokenizes IMDb with ``DistilBertTokenizerFast(truncation=True,
padding=True)``, which needs the HuggingFace runtime and a downloaded
tokenizer. Given only a ``vocab.txt`` on disk (the one file that defines
``distilbert-base-uncased``'s tokenizer), this module runs the whole
pipeline: clean and whitespace normalisation, lowercase and accent
stripping, punctuation splitting, CJK spacing, then greedy longest-match
WordPiece, token for token the HF fast tokenizer's and the JAX package's
(``tests/test_torch_wordpiece.py``).

As in :class:`~.imdb.HashTokenizer`, the output is padded to a fixed
``max_len``. Only the Python matcher is kept (the JAX package's native
matcher gives the same ids).
"""

from __future__ import annotations

import collections
import hashlib
import os
import tempfile
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np

_MAX_WORD_CHARS = 100  # words longer than this become [UNK] (BERT behavior)

# BERT convention: [PAD] id 0, then the other specials ahead of real tokens
VOCAB_SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False  # treated as whitespace, not control
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges treated as punctuation even where Unicode disagrees
    # (e.g. ``$``, ``^``, ``` ` ```), matching the BERT basic tokenizer
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def _clean_text(text: str) -> str:
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        out.append(" " if _is_whitespace(ch) else ch)
    return "".join(out)


def _space_cjk_text(text: str) -> str:
    out = []
    for ch in text:
        if _is_cjk(ord(ch)):
            out += [" ", ch, " "]
        else:
            out.append(ch)
    return "".join(out)


def _strip_accent_marks(word: str) -> str:
    return "".join(
        ch
        for ch in unicodedata.normalize("NFD", word)
        if unicodedata.category(ch) != "Mn"
    )


def _split_punct_word(word: str) -> List[str]:
    pieces: List[List[str]] = []
    new_word = True
    for ch in word:
        if _is_punctuation(ch):
            pieces.append([ch])
            new_word = True
        else:
            if new_word:
                pieces.append([])
                new_word = False
            pieces[-1].append(ch)
    return ["".join(p) for p in pieces]


def basic_tokenize(
    text: str, lower_case: bool = True, strip_accents: bool = True
) -> List[str]:
    """The BERT "basic tokenizer" as a free function — shared by the
    encoder (via :meth:`WordPieceTokenizer.basic_tokenize`) and by
    :func:`build_vocab`, which must normalize the corpus IDENTICALLY to
    the tokenizer that will later consume its vocab."""
    text = _space_cjk_text(_clean_text(text))
    words: List[str] = []
    for word in text.split():
        if lower_case:
            word = word.lower()
        if strip_accents:
            word = _strip_accent_marks(word)
        words += _split_punct_word(word)
    return [w for w in words if w]


def load_vocab(vocab_file: str) -> Dict[str, int]:
    """``vocab.txt`` → {token: id}, ids = line numbers (the HF convention)."""
    vocab: Dict[str, int] = {}
    with open(vocab_file, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab


class WordPieceTokenizer:
    """Greedy longest-match WordPiece over an on-disk ``vocab.txt``, with the
    ``distilbert-base-uncased`` text normalization (lowercase + NFD
    accent-stripping + punctuation splitting + CJK spacing).

    HF-style callable: ``tok(texts) -> {'input_ids', 'attention_mask'}`` as
    fixed-shape int32 arrays — a drop-in for :class:`~.imdb.HashTokenizer`
    where ``prepare_imdb`` constructs the default tokenizer.
    """

    def __init__(
        self,
        vocab_file: str,
        max_len: int = 256,
        lower_case: bool = True,
        strip_accents: bool = True,
        unk_token: str = "[UNK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
    ):
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2 ([CLS] + [SEP]), got {max_len}")
        self.vocab = load_vocab(vocab_file)
        self.max_len = max_len
        self.lower_case = lower_case
        self.strip_accents = strip_accents
        for tok in (unk_token, cls_token, sep_token, pad_token):
            if tok not in self.vocab:
                raise ValueError(f"special token {tok!r} missing from {vocab_file}")
        self.unk_id = self.vocab[unk_token]
        self.cls_id = self.vocab[cls_token]
        self.sep_id = self.vocab[sep_token]
        self.pad_id = self.vocab[pad_token]
        self.unk_token = unk_token

    # ---- text normalization (the BERT "basic tokenizer") -----------------

    def _clean(self, text: str) -> str:
        return _clean_text(text)

    def _space_cjk(self, text: str) -> str:
        return _space_cjk_text(text)

    def _strip_accents(self, word: str) -> str:
        return _strip_accent_marks(word)

    def _split_punct(self, word: str) -> List[str]:
        return _split_punct_word(word)

    def basic_tokenize(self, text: str) -> List[str]:
        return basic_tokenize(text, self.lower_case, self.strip_accents)

    # ---- WordPiece (greedy longest-match) --------------------------------

    def wordpiece(self, word: str) -> List[str]:
        if len(word) > _MAX_WORD_CHARS:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]  # whole word is UNK (BERT behavior)
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic_tokenize(text):
            out += self.wordpiece(word)
        return out

    # ---- HF-style batch encoding -----------------------------------------

    def __call__(self, texts: Sequence[str]) -> dict:
        return self.python_encode([self.basic_tokenize(t) for t in texts])

    def encode_shard(
        self, texts: Sequence[str], world_size: int, rank: int
    ) -> dict:
        """Encode only this rank's contiguous shard of ``texts`` (see
        :func:`shard_rows`): each rank pays ``1/world_size`` of the
        tokenization cost instead of every rank re-encoding the full
        corpus. The shards are contiguous row blocks in rank order, so their
        rank-order concatenation is the full corpus's row order."""
        start, stop = shard_rows(len(texts), world_size, rank)
        return self(list(texts[start:stop]))

    def python_encode(self, words_per_text: Sequence[List[str]]) -> dict:
        """The greedy matcher over basic-tokenized words, padded to
        ``max_len``."""
        ids = np.full((len(words_per_text), self.max_len), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(words_per_text), self.max_len), dtype=np.int32)
        for row, words in enumerate(words_per_text):
            pieces: List[str] = []
            for word in words:
                pieces += self.wordpiece(word)
            toks = [self.vocab[t] for t in pieces][: self.max_len - 2]
            toks = [self.cls_id] + toks + [self.sep_id]
            ids[row, : len(toks)] = toks
            mask[row, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


# ---- corpus sharding + vocab building/caching -----------------------------


def shard_rows(n: int, world_size: int, rank: int) -> Tuple[int, int]:
    """Contiguous balanced row range ``[start, stop)`` for ``rank`` of
    ``world_size``: shard sizes differ by at most one and the rank-order
    concatenation of all shards is exactly ``range(n)``."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside [0, {world_size})")
    return rank * n // world_size, (rank + 1) * n // world_size


def build_vocab(
    texts: Sequence[str],
    max_size: int = 8192,
    lower_case: bool = True,
    strip_accents: bool = True,
) -> List[str]:
    """Deterministic corpus-driven ``vocab.txt`` contents (token per line,
    id = line number): the five BERT specials, every character seen in the
    normalized corpus plus its ``##`` continuation form (so any word made
    of seen characters always tokenizes instead of collapsing to [UNK]),
    then whole words by descending frequency (ties alphabetical) up to
    ``max_size``. Normalization is the SAME :func:`basic_tokenize` the
    encoder applies — a vocab built under different flags would silently
    mis-tokenize."""
    counts: collections.Counter = collections.Counter()
    chars = set()
    for t in texts:
        for w in basic_tokenize(t, lower_case, strip_accents):
            counts[w] += 1
            chars.update(w)
    tokens: List[str] = list(VOCAB_SPECIALS)
    seen = set(tokens)
    for ch in sorted(chars):
        for tok in (ch, "##" + ch):
            if tok not in seen:
                tokens.append(tok)
                seen.add(tok)
    for w, _ in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
        if len(tokens) >= max_size:
            break
        if w not in seen:
            tokens.append(w)
            seen.add(w)
    # specials + character coverage are never truncated, even past max_size
    return tokens


def corpus_fingerprint(
    texts: Sequence[str],
    max_size: int = 8192,
    lower_case: bool = True,
    strip_accents: bool = True,
) -> str:
    """Content hash of (corpus, build params) — the vocab cache key."""
    h = hashlib.sha256()
    h.update(
        f"ndp-wordpiece-vocab:1:{max_size}:{int(lower_case)}:"
        f"{int(strip_accents)}".encode()
    )
    for t in texts:
        b = t.encode("utf-8")
        h.update(len(b).to_bytes(8, "little"))
        h.update(b)
    return h.hexdigest()[:16]


def cached_vocab_file(
    texts: Sequence[str],
    cache_dir: str,
    max_size: int = 8192,
    lower_case: bool = True,
    strip_accents: bool = True,
) -> str:
    """Path to a ``vocab.txt`` for this corpus, built AT MOST ONCE per
    (corpus, params) fingerprint: every rank and every restart/incarnation
    that sees the same corpus reuses the on-disk file instead of
    re-counting it (the rebuild used to dominate small-run startup).
    Concurrent builders race benignly — both derive identical content and
    the write is build-to-temp + atomic rename."""
    fp = corpus_fingerprint(texts, max_size, lower_case, strip_accents)
    path = os.path.join(cache_dir, f"vocab_{fp}.txt")
    if os.path.exists(path):
        return path
    os.makedirs(cache_dir, exist_ok=True)
    tokens = build_vocab(texts, max_size, lower_case, strip_accents)
    fd, tmp = tempfile.mkstemp(suffix=".txt", dir=cache_dir)
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write("\n".join(tokens) + "\n")
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path
