"""The port's native (C++) data runtime against the JAX package's.

The port builds its own copy of ``dataloader.cpp`` with ``g++`` (here as on
the card's machine); its decoder, fused gather, prefetching loader, hash
tokenizer and WordPiece matcher must give the JAX package's bytes and
tokens on the same seeded inputs, and its numpy fallbacks the native
path's.
"""

import os

import numpy as np
import pytest

import network_distributed_pytorch_tpu.native as jax_native
import network_distributed_pytorch_tpu.native.build as jax_build
from network_distributed_pytorch_tpu.data.imdb import HashTokenizer as JaxHashTokenizer
from network_distributed_pytorch_tpu.data.wordpiece import WordPieceTokenizer as JaxWordPiece
from network_distributed_pytorch_tpu_torch import native
from network_distributed_pytorch_tpu_torch.data.imdb import HashTokenizer
from network_distributed_pytorch_tpu_torch.data.loader import iterate_batches
from network_distributed_pytorch_tpu_torch.data.wordpiece import WordPieceTokenizer
from network_distributed_pytorch_tpu_torch.native import build
from network_distributed_pytorch_tpu_torch.native.loader import NativeBatchLoader, NativeWordPiece

PORT_PKG = os.path.dirname(os.path.dirname(build.__file__))


@pytest.fixture
def fallback(monkeypatch):
    """The port's runtime with its library off, as ``NDP_TPU_NO_NATIVE=1``
    or a failed build leave it."""
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_load_attempted", True)
    yield
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_load_attempted", False)


def test_the_port_builds_its_own_source_into_its_build_dir():
    assert native.native_available() and jax_native.native_available()
    lib = build.load_library()
    assert os.path.dirname(lib._name) == os.path.join(PORT_PKG, "_build") == build.BUILD_DIR
    assert build._SRC == os.path.join(PORT_PKG, "native", "dataloader.cpp")
    assert os.path.basename(lib._name).startswith("ndp_native_") and lib._name == build.so_path()
    assert os.path.realpath(lib._name) != os.path.realpath(jax_build.load_library()._name)


def test_a_fresh_build_is_renamed_into_place_with_no_temporary_left(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    path = build.so_path()
    build._compile(path)
    assert os.path.isfile(path) and os.listdir(tmp_path) == [os.path.basename(path)]  # no temporary left


def test_no_native_env_selects_the_fallback(monkeypatch):
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_load_attempted", False)
    monkeypatch.setenv("NDP_TPU_NO_NATIVE", "1")
    assert build.load_library() is None and not native.native_available()
    assert native.tokenize_hash(["hello world"], 100, 8) is None
    out = HashTokenizer(vocab_size=100, max_len=8)(["hello world"])
    assert out["input_ids"][0, 0] == 1 and out["attention_mask"][0].sum() == 4
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_load_attempted", False)


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_cifar10_bin_is_the_jax_packages(seed):
    records = np.random.RandomState(seed).randint(0, 256, size=(64, 3073), dtype=np.uint8)
    images, labels = native.decode_cifar10_bin(records, mean=0.4, std=0.3)
    jimages, jlabels = jax_native.decode_cifar10_bin(records, mean=0.4, std=0.3)
    assert images.tobytes() == jimages.tobytes() and labels.tobytes() == jlabels.tobytes()
    chw = records[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    assert images.tobytes() == (((chw.astype(np.float32) / 255.0) - 0.4) / 0.3).tobytes()


@pytest.mark.parametrize("use_fallback", [False, True])
def test_decode_cifar10_bin_into_out_arrays(use_fallback, monkeypatch):
    records = np.random.RandomState(4).randint(0, 256, size=(12, 3073), dtype=np.uint8)
    want_x, want_y = jax_native.decode_cifar10_bin(records)
    if use_fallback:
        monkeypatch.setattr(build, "_lib", None)
        monkeypatch.setattr(build, "_load_attempted", True)
    big_x = np.zeros((20, 32, 32, 3), np.float32)
    big_y = np.zeros((20,), np.int32)
    rx, ry = native.decode_cifar10_bin(records, out_images=big_x[5:17], out_labels=big_y[5:17])
    assert rx.base is big_x and ry.base is big_y
    assert big_x[5:17].tobytes() == want_x.tobytes() and big_y[5:17].tobytes() == want_y.tobytes()
    assert not big_x[:5].any() and not big_x[17:].any()
    for bad in (
        dict(out_images=np.zeros((12, 32, 32, 3), np.float64)),
        dict(out_labels=np.zeros((11,), np.int32)),
        dict(out_images=np.zeros((12, 32, 32, 6), np.float32)[..., ::2]),
    ):
        with pytest.raises(ValueError):
            native.decode_cifar10_bin(records, **bad)
        with pytest.raises(ValueError):
            jax_native.decode_cifar10_bin(records, **bad)
    with pytest.raises(ValueError):
        native.decode_cifar10_bin(np.zeros((2, 3072), np.uint8))
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_load_attempted", False)


def test_cifar10_binary_files_decode_as_the_jax_package_decodes_them(tmp_path):
    from network_distributed_pytorch_tpu.data.cifar10 import load_cifar10 as jax_load
    from network_distributed_pytorch_tpu_torch.data.cifar10 import load_cifar10

    base = tmp_path / "cifar-10-batches-bin"
    base.mkdir()
    rng = np.random.RandomState(7)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]:
        rng.randint(0, 256, size=(3 + len(name) % 4, 3073), dtype=np.uint8).tofile(base / name)
    for train in (True, False):
        (x, y), (jx, jy) = load_cifar10(str(tmp_path), train=train), jax_load(str(tmp_path), train=train)
        assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes() and x.flags.c_contiguous


@pytest.mark.parametrize("mean,std", [(0.5, 0.5), (0.4, 0.25)])
def test_gather_normalize_u8_is_the_jax_packages(mean, std):
    rng = np.random.RandomState(1)
    src = rng.randint(0, 256, size=(100, 7, 3), dtype=np.uint8)
    idx = rng.randint(0, 100, size=33)
    out = native.gather_normalize_u8(src, idx, mean=mean, std=std)
    assert out.tobytes() == jax_native.gather_normalize_u8(src, idx, mean=mean, std=std).tobytes()
    assert out.tobytes() == (((src[idx].astype(np.float32) / 255.0) - mean) / std).tobytes()


@pytest.mark.parametrize("use_fallback", [False, True])
@pytest.mark.parametrize("idx", [[0, 10], [-1], [3, 11, 2]])
def test_gather_bounds_raise_as_the_jax_packages(idx, use_fallback, monkeypatch):
    if use_fallback:
        monkeypatch.setattr(build, "_lib", None)
        monkeypatch.setattr(build, "_load_attempted", True)
    src = np.zeros((10, 3), np.uint8)
    with pytest.raises(IndexError):
        native.gather_normalize_u8(src, np.array(idx))
    with pytest.raises(IndexError):
        jax_native.gather_normalize_u8(src, np.array(idx))
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_load_attempted", False)


def _dataset(dtype, n=70, seed=2):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        store = rng.randint(0, 256, size=(n, 4, 4, 3), dtype=np.uint8)
        ref = ((store.astype(np.float32) / 255.0) - 0.5) / 0.5
    else:
        store = rng.randn(n, 4, 4, 3).astype(np.float32)
        ref = store
    return store, ref, rng.randint(0, 10, size=n).astype(np.int32)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("seed", [5, 11])
def test_loader_epochs_are_iterate_batches_and_the_jax_loaders(dtype, seed):
    store, ref, y = _dataset(dtype)  # 70 rows, batches of 16: a ragged tail of 6 dropped
    loader = NativeBatchLoader(store, y, 16, seed=seed)
    jloader = jax_native.NativeBatchLoader(store, y, 16, seed=seed)
    for epoch in range(2):
        got = list(loader.epoch(epoch))
        want = list(iterate_batches([ref, y], 16, seed=seed, epoch=epoch))
        jgot = list(jloader.epoch(epoch))
        assert len(got) == len(want) == len(jgot) == loader.steps_per_epoch() == 4
        for (gx, gy), (wx, wy), (jx, jy) in zip(got, want, jgot):
            assert gx.dtype == np.float32 and gy.dtype == np.int32
            assert gx.tobytes() == wx.tobytes() == np.asarray(jx).tobytes()
            assert gy.tobytes() == wy.tobytes() == np.asarray(jy).tobytes()
        assert loader.last_stats == {**loader.last_stats, "native": True, "batches": 4, "n_batches": 4}
        assert loader.last_stats["consumer_wait_s"] >= 0.0


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_loader_explicit_order_is_the_jax_loaders(dtype):
    store, ref, y = _dataset(dtype, n=40, seed=3)
    order = np.random.RandomState(9).permutation(40)[:27]  # 3 batches of 8, a tail of 3 dropped
    got = list(NativeBatchLoader(store, y, 8).epoch(order=order))
    jgot = list(jax_native.NativeBatchLoader(store, y, 8).epoch(order=order))
    assert len(got) == len(jgot) == 3
    for b, ((gx, gy), (jx, jy)) in enumerate(zip(got, jgot)):
        sel = order[8 * b : 8 * b + 8]
        assert gx.tobytes() == jx.tobytes() == ref[sel].tobytes() and gy.tobytes() == jy.tobytes() == y[sel].tobytes()
    for bad in (np.array([0, 40]), np.array([-1, 2])):
        with pytest.raises(ValueError, match="out of range"):
            list(NativeBatchLoader(store, y, 8).epoch(order=bad))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_fallback_loader_is_the_native_loader(dtype, fallback):
    store, _, y = _dataset(dtype, n=40, seed=3)
    native_batches = list(jax_native.NativeBatchLoader(store, y, 8, seed=9).epoch(0))
    loader = NativeBatchLoader(store, y, 8, seed=9)
    got = list(loader.epoch(0))
    assert len(got) == len(native_batches) == 5
    for (gx, gy), (nx, ny) in zip(got, native_batches):
        assert gx.tobytes() == nx.tobytes() and gy.tobytes() == ny.tobytes()
    assert loader.last_stats == {"native": False, "batches": 5, "consumer_wait_s": 0.0, "n_batches": 5}


def test_an_abandoned_epoch_joins_its_worker_and_records_its_stats():
    store, _, y = _dataset(np.float32, n=64)
    loader = NativeBatchLoader(store, y, 4, seed=1)
    it = loader.epoch(0)
    next(it), next(it)
    it.close()  # the worker is blocked on a full queue: destroy must wake and join it
    assert loader.last_stats["native"] and loader.last_stats["batches"] == 2 and loader.last_stats["n_batches"] == 16
    assert len(list(loader.epoch(1))) == 16


@pytest.mark.parametrize(
    "arrays,eligible",
    [
        ((np.zeros((8, 2), np.float32), np.zeros(8, np.int32)), True),
        ((np.zeros((8, 2), np.float32), np.zeros(8, np.int64)), True),
        ((np.zeros((8, 2), np.uint8), np.zeros(8, np.int32)), False),
        ((np.zeros((8, 2), np.float64), np.zeros(8, np.int32)), False),
        ((np.zeros((8, 2), np.float32), np.zeros(8, np.float32)), False),
        ((np.zeros((8, 2), np.float32), np.zeros(8, np.int32), np.zeros(8, np.int32)), False),
    ],
)
def test_maybe_create_is_eligible_where_the_jax_loaders_is(arrays, eligible):
    got = NativeBatchLoader.maybe_create(arrays, 4)
    assert (got is not None) == (jax_native.NativeBatchLoader.maybe_create(arrays, 4) is not None) == eligible


_HASH_TEXTS = [
    "This movie was GREAT, truly great!",
    "awful.\tJust awful...\n\nnever  again",
    "",
    "  leading and trailing   ",
    "Café au lait — très bon, naïve résumé",
    "good movie with unicode\u0085whitespace",
    "x" * 5000,
    " ".join(f"word{i}" for i in range(500)),
]


@pytest.mark.parametrize("vocab,max_len", [(1000, 32), (30522, 256), (7, 2)])
def test_tokenize_hash_is_the_jax_packages(vocab, max_len):
    got = native.tokenize_hash(_HASH_TEXTS, vocab, max_len)
    want = jax_native.loader.tokenize_hash(_HASH_TEXTS, vocab, max_len)
    python = HashTokenizer(vocab_size=vocab, max_len=max_len).python_call(_HASH_TEXTS)
    for k in ("input_ids", "attention_mask"):
        assert got[k].tobytes() == want[k].tobytes() == python[k].tobytes()
    out = HashTokenizer(vocab_size=vocab, max_len=max_len)(_HASH_TEXTS)
    jout = JaxHashTokenizer(vocab_size=vocab, max_len=max_len)(_HASH_TEXTS)
    assert out["input_ids"].tobytes() == jout["input_ids"].tobytes()


def _vocab(tmp_path, tokens):
    vf = tmp_path / "vocab.txt"
    vf.write_text("\n".join(tokens) + "\n", encoding="utf-8")
    return str(vf)


_WP_VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "movie", "un", "##believ", "##able", "unbeliev", "watch", "##ed",
    "!", ",", "café", "ca", "##fé", "电", "影", "a", "##b", "##c", "abc", "was", "great", ".", "-", "x", "##x",
]
_WP_TEXTS = [
    "the movie was unbelievable!",
    "watched, watch abc ab",
    "café 电影 cafe",
    "",
    "x" * 500,
    "the " * 50,
    "The MOVIE was GREAT!",
    "a\x00b\x01c",
    "the\x0bmovie\x0cwas",
    "--..!!,,",
    " \t\n\r ",
    "xxxx",
]


@pytest.mark.parametrize("max_len", [16, 2, 64])
def test_wordpiece_encode_is_the_jax_matchers(tmp_path, max_len):
    vf = _vocab(tmp_path, _WP_VOCAB)
    tok, jtok = WordPieceTokenizer(vf, max_len=max_len), JaxWordPiece(vf, max_len=max_len)
    words = [tok.basic_tokenize(t) for t in _WP_TEXTS]
    special = (tok.unk_id, tok.cls_id, tok.sep_id, tok.pad_id, tok.max_len)
    got = tok._native_matcher().encode(words, *special)
    want = jtok._native_matcher().encode(words, *special)
    python = tok.python_encode(words)
    for k in ("input_ids", "attention_mask"):
        assert got[k].tobytes() == want[k].tobytes() == python[k].tobytes()


@pytest.mark.parametrize("max_len", [12, 3])
def test_wordpiece_encode_ascii_is_the_jax_matchers(tmp_path, max_len):
    vf = _vocab(tmp_path, _WP_VOCAB)
    tok, jtok = WordPieceTokenizer(vf, max_len=max_len), JaxWordPiece(vf, max_len=max_len)
    texts = [t for t in _WP_TEXTS if t.isascii()] + ["x" * 150, "the great movie ! " * 20]
    special = (tok.unk_id, tok.cls_id, tok.sep_id, tok.pad_id, tok.max_len)
    got = tok._native_matcher().encode_ascii(texts, *special)
    want = jtok._native_matcher().encode_ascii(texts, *special)
    python = tok.python_encode([tok.basic_tokenize(t) for t in texts])
    for k in ("input_ids", "attention_mask"):
        assert got[k].tobytes() == want[k].tobytes() == python[k].tobytes()


@pytest.mark.parametrize(
    "texts",
    [
        ["the movie", "café 电", "the the", "CAFÉ"],  # mixed: ASCII rows one pass, the others normalised in Python
        ["café 电", "CAFÉ"],  # no ASCII row
        ["the movie", "the the"],  # ASCII only
    ],
)
def test_wordpiece_routing_is_the_jax_tokenizers(tmp_path, texts):
    vf = _vocab(tmp_path, ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "cafe", "movie", "电"])
    tok, jtok = WordPieceTokenizer(vf, max_len=8), JaxWordPiece(vf, max_len=8)
    out, jout = tok(texts), jtok(texts)
    python = tok.python_encode([tok.basic_tokenize(t) for t in texts])
    for k in ("input_ids", "attention_mask"):
        assert out[k].tobytes() == jout[k].tobytes() == python[k].tobytes()


def test_wordpiece_accent_keeping_config_takes_no_ascii_pass(tmp_path):
    vf = _vocab(tmp_path, ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "movie", "The"])
    tok = WordPieceTokenizer(vf, max_len=8, lower_case=False, strip_accents=False)
    jtok = JaxWordPiece(vf, max_len=8, lower_case=False, strip_accents=False)
    texts = ["The movie", "the MOVIE"]
    assert tok(texts)["input_ids"].tobytes() == jtok(texts)["input_ids"].tobytes()
    assert tok(texts)["input_ids"].tobytes() == tok.python_encode([tok.basic_tokenize(t) for t in texts])[
        "input_ids"
    ].tobytes()


def test_sparse_vocabulary_stays_on_the_python_matcher(tmp_path):
    vf = tmp_path / "vocab.txt"
    vf.write_text("[PAD]\n[UNK]\n[CLS]\n[SEP]\n\nthe\nmovie\nthe\n", encoding="utf-8")
    tok, jtok = WordPieceTokenizer(str(vf), max_len=8), JaxWordPiece(str(vf), max_len=8)
    assert tok._native_matcher() is None and jtok._native_matcher() is None
    out = tok(["the movie"])
    assert out["input_ids"].tobytes() == jtok(["the movie"])["input_ids"].tobytes()
    np.testing.assert_array_equal(out["input_ids"][0][:4], [tok.cls_id, 7, 6, tok.sep_id])


def test_dense_vocabulary_uses_the_native_matcher(tmp_path):
    tok = WordPieceTokenizer(_vocab(tmp_path, ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "movie"]), max_len=8)
    assert isinstance(tok._native_matcher(), NativeWordPiece)


def test_wordpiece_falls_back_to_python_without_the_library(tmp_path, fallback):
    vf = _vocab(tmp_path, _WP_VOCAB)
    tok, jtok = WordPieceTokenizer(vf, max_len=16), JaxWordPiece(vf, max_len=16)
    assert tok._native_matcher() is None
    assert tok(_WP_TEXTS)["input_ids"].tobytes() == jtok(_WP_TEXTS)["input_ids"].tobytes()


@pytest.mark.parametrize("max_len", [-3, 0, 1])
def test_max_len_guards_raise_as_the_jax_packages(tmp_path, max_len):
    vf = _vocab(tmp_path, ["[PAD]", "[UNK]", "[CLS]", "[SEP]"])
    for wp, hash_tok in ((WordPieceTokenizer, HashTokenizer), (JaxWordPiece, JaxHashTokenizer)):
        with pytest.raises(ValueError, match="max_len"):
            wp(vf, max_len=max_len)
        with pytest.raises(ValueError, match="max_len"):
            hash_tok(max_len=max_len)
    for matcher in (NativeWordPiece, jax_native.loader.NativeWordPiece):
        m = matcher.build(["[PAD]", "[UNK]", "[CLS]", "[SEP]"])
        with pytest.raises(ValueError, match="max_len"):
            m.encode([["x"]], 1, 2, 3, 0, max_len=max_len)
        with pytest.raises(ValueError, match="max_len"):
            m.encode_ascii(["x"], 1, 2, 3, 0, max_len=max_len)
