"""The port's WordPiece tokenizer (``data/wordpiece.py``) token for token
against the JAX package's and against HuggingFace's
``DistilBertTokenizerFast``, all three built from one ``vocab.txt`` written
inside the test (the vocabulary and texts of ``tests/test_wordpiece.py``:
multi-piece words, greedy longest-match ties, punctuation, digits, accent
folding, CJK, unknown words, an empty text, truncation), and
``prepare_imdb`` selecting it where ``{data_dir}/vocab.txt`` exists."""

import importlib

import numpy as np
import pytest

from network_distributed_pytorch_tpu_torch.data import imdb, wordpiece
from test_wordpiece import TEXTS, VOCAB

jax_wordpiece = importlib.import_module("network_distributed_pytorch_tpu.data.wordpiece")
jax_imdb = importlib.import_module("network_distributed_pytorch_tpu.data.imdb")
transformers = pytest.importorskip("transformers")


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("wp") / "vocab.txt"
    p.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    return str(p)


@pytest.mark.parametrize("max_len", [16, 64])
def test_ids_match_the_jax_tokenizer_and_hf_fast(vocab_file, max_len):
    got = wordpiece.WordPieceTokenizer(vocab_file, max_len=max_len)(TEXTS)
    want = jax_wordpiece.WordPieceTokenizer(vocab_file, max_len=max_len)(TEXTS)
    hf = transformers.DistilBertTokenizerFast(vocab_file=vocab_file, do_lower_case=True)(
        TEXTS, truncation=True, padding="max_length", max_length=max_len
    )
    for key in ("input_ids", "attention_mask"):
        assert got[key].dtype == np.int32 and got[key].shape == (len(TEXTS), max_len)
        np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_array_equal(got[key], np.asarray(hf[key], np.int32))


def test_pieces_match_the_jax_tokenizer_and_hf_fast(vocab_file):
    ours = wordpiece.WordPieceTokenizer(vocab_file)
    theirs = jax_wordpiece.WordPieceTokenizer(vocab_file)
    hf = transformers.DistilBertTokenizerFast(vocab_file=vocab_file, do_lower_case=True)
    for text in TEXTS:
        assert ours.tokenize(text) == theirs.tokenize(text) == hf.tokenize(text), text
    assert ours.wordpiece("unbelievable") == ["unbeliev", "##able"]
    assert ours.wordpiece("x" * 200) == ["[UNK]"]
    with pytest.raises(ValueError, match="max_len"):
        wordpiece.WordPieceTokenizer(vocab_file, max_len=1)


def test_vocab_building_and_sharding_match_jax(tmp_path):
    texts = TEXTS[:8]
    assert wordpiece.build_vocab(texts, max_size=64) == jax_wordpiece.build_vocab(texts, max_size=64)
    assert wordpiece.corpus_fingerprint(texts) == jax_wordpiece.corpus_fingerprint(texts)
    path = wordpiece.cached_vocab_file(texts, str(tmp_path), max_size=64)
    assert path == wordpiece.cached_vocab_file(texts, str(tmp_path), max_size=64)
    assert wordpiece.load_vocab(path) == jax_wordpiece.load_vocab(path)
    for n, world in ((10, 3), (7, 4)):
        for rank in range(world):
            assert wordpiece.shard_rows(n, world, rank) == jax_wordpiece.shard_rows(n, world, rank)


def test_prepare_imdb_picks_up_vocab_txt_as_jax_does(tmp_path):
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    kw = dict(data_dir=str(tmp_path), max_len=32, synthetic_n=16, vocab_size=1024)
    got, want = imdb.prepare_imdb(**kw), jax_imdb.prepare_imdb(**kw)
    for split_got, split_want in zip(got[:2], want[:2]):
        for key in ("input_ids", "attention_mask", "labels"):
            np.testing.assert_array_equal(split_got[key], split_want[key])
    assert (got[0]["input_ids"][:, 0] == 2).all()  # [CLS]: the WordPiece path
    with pytest.raises(ValueError, match="vocab_size"):
        imdb.prepare_imdb(**{**kw, "vocab_size": 16})
