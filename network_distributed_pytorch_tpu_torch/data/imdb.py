"""IMDb sentiment data, as in the JAX package's ``data/imdb.py``: the
reference's ``read_imdb_split`` over ``aclImdb/{train,test}/{pos,neg}``, a
seeded 80/20 train/val split, a deterministic hash tokenizer padding to a
fixed ``max_len``, and class-separable synthetic reviews where the dataset
is not on disk.

The arrays are the JAX package's, value for value, from the same seed.
``HashTokenizer``'s hot loop runs in the native runtime
(``native.tokenize_hash``) where it is built, else in Python; both give the
same ids. A ``vocab.txt`` beside the dataset selects
the WordPiece tokenizer (``data/wordpiece.py``), as in the JAX package.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


def read_imdb_split(split_dir: str) -> Tuple[List[str], List[int]]:
    """Texts and 0/1 labels from ``{split_dir}/{pos,neg}/*.txt``."""
    split = Path(split_dir)
    texts: List[str] = []
    labels: List[int] = []
    for label_dir in ["pos", "neg"]:
        for text_file in sorted((split / label_dir).iterdir()):
            texts.append(text_file.read_text(encoding="utf-8"))
            labels.append(0 if label_dir == "neg" else 1)
    return texts, labels


def train_val_split(
    texts: Sequence[str], labels: Sequence[int], test_size: float = 0.2, seed: int = 714
) -> Tuple[List[str], List[str], List[int], List[int]]:
    """Deterministic shuffle-split (the reference's sklearn
    ``train_test_split(test_size=.2)``)."""
    n = len(texts)
    idx = np.arange(n)
    np.random.RandomState(seed).shuffle(idx)
    n_val = int(n * test_size)
    val, train = idx[:n_val], idx[n_val:]
    return (
        [texts[i] for i in train],
        [texts[i] for i in val],
        [labels[i] for i in train],
        [labels[i] for i in val],
    )


class HashTokenizer:
    """Deterministic whitespace + hashing tokenizer with HF-style output
    (``input_ids``, ``attention_mask``), padded or truncated to ``max_len``.
    id 0 = [PAD], 1 = [CLS], 2 = [SEP]; words hash (FNV-1a) into
    [3, vocab)."""

    def __init__(self, vocab_size: int = 30522, max_len: int = 256):
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2 ([CLS] + [SEP]), got {max_len}")
        self.vocab_size = vocab_size
        self.max_len = max_len

    def _word_id(self, word: str) -> int:
        h = 2166136261
        for ch in word.encode("utf-8"):
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        return 3 + h % (self.vocab_size - 3)

    def __call__(self, texts: Sequence[str]) -> dict:
        from ..native.loader import tokenize_hash

        out = tokenize_hash(texts, self.vocab_size, self.max_len)
        if out is not None:
            return out
        return self.python_call(texts)

    def python_call(self, texts: Sequence[str]) -> dict:
        """The Python loop (also the native path's oracle)."""
        ids = np.zeros((len(texts), self.max_len), dtype=np.int32)
        mask = np.zeros((len(texts), self.max_len), dtype=np.int32)
        for row, text in enumerate(texts):
            words = text.lower().split()[: self.max_len - 2]
            toks = [1] + [self._word_id(w) for w in words] + [2]
            ids[row, : len(toks)] = toks
            mask[row, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def synthetic_imdb(
    n: int = 2048,
    seed: int = 0,
    num_words: int = 40,
    class_word_rate: float = 0.4,
    label_noise: float = 0.0,
) -> Tuple[List[str], List[int]]:
    """Class-separable synthetic reviews: each class draws words from a
    distinct vocabulary region. ``class_word_rate`` is the chance that a
    word carries the class; ``label_noise`` flips that share of labels after
    the text is drawn."""
    rng = np.random.RandomState(seed)
    pos_vocab = [f"good{i}" for i in range(50)] + ["great", "excellent", "wonderful"]
    neg_vocab = [f"bad{i}" for i in range(50)] + ["awful", "terrible", "boring"]
    common = [f"word{i}" for i in range(100)]
    texts, labels = [], []
    for _ in range(n):
        label = int(rng.randint(0, 2))
        vocab = pos_vocab if label else neg_vocab
        words = [
            vocab[rng.randint(len(vocab))]
            if rng.rand() < class_word_rate
            else common[rng.randint(len(common))]
            for _ in range(num_words)
        ]
        texts.append(" ".join(words))
        labels.append(label)
    if label_noise > 0.0:
        flips = rng.rand(n) < label_noise
        labels = [1 - y if f else y for y, f in zip(labels, flips)]
    return texts, labels


def prepare_imdb(
    data_dir: Optional[str] = None,
    tokenizer: Optional[Callable] = None,
    max_len: int = 256,
    vocab_size: int = 30522,
    synthetic_n: int = 2048,
    seed: int = 714,
    synthetic_kwargs: Optional[dict] = None,
) -> Tuple[dict, dict, bool]:
    """``(train, val, is_real)``, each split ``{'input_ids',
    'attention_mask', 'labels'}`` as fixed-shape int32 numpy arrays. The
    dataset under ``{data_dir}/train`` when it is there, else
    :func:`synthetic_imdb`. Without a ``tokenizer``: the
    :class:`~.wordpiece.WordPieceTokenizer` of ``{data_dir}/vocab.txt``
    where that file exists (refused if its ids reach past ``vocab_size``,
    the model's table), else the :class:`HashTokenizer`."""
    if data_dir is not None and os.path.isdir(os.path.join(data_dir, "train")):
        texts, labels = read_imdb_split(os.path.join(data_dir, "train"))
        is_real = True
    else:
        texts, labels = synthetic_imdb(synthetic_n, seed=seed, **(synthetic_kwargs or {}))
        is_real = False
    train_texts, val_texts, train_labels, val_labels = train_val_split(
        texts, labels, test_size=0.2, seed=seed
    )
    if tokenizer is None:
        vocab_file = os.path.join(data_dir, "vocab.txt") if data_dir is not None else ""
        if vocab_file and os.path.isfile(vocab_file):
            from .wordpiece import WordPieceTokenizer

            tokenizer = WordPieceTokenizer(vocab_file, max_len=max_len)
            # max id + 1, not len(): blank or repeated lines leave ids unused
            vocab_span = max(tokenizer.vocab.values()) + 1
            if vocab_span > vocab_size:
                # an id past the embedding table would fail in the gather (or
                # read another row): size the model to the vocabulary
                raise ValueError(
                    f"{vocab_file} spans token ids up to {vocab_span - 1} but the model vocab_size is"
                    f" {vocab_size}; pass vocab_size={vocab_span} (and size the model to match) or pass an"
                    " explicit tokenizer"
                )
        else:
            tokenizer = HashTokenizer(vocab_size=vocab_size, max_len=max_len)

    def encode(ts, ls):
        enc = tokenizer(ts)
        return {
            "input_ids": np.asarray(enc["input_ids"], dtype=np.int32),
            "attention_mask": np.asarray(enc["attention_mask"], dtype=np.int32),
            "labels": np.asarray(ls, dtype=np.int32),
        }

    return encode(train_texts, train_labels), encode(val_texts, val_labels), is_real
