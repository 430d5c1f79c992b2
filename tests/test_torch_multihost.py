"""The port's ``data/multihost.py`` against the JAX package's:

- ``merge_tokenized_shards`` gives the JAX function's arrays and a
  monolithic encode's, and on a device the same values as tensors;
- ``global_batch_from_local`` and ``global_state_from_host`` place a
  rank's host values on its device, leaf for leaf;
- at 2 Gloo ranks (one spawn for the module), each rank fed only its own
  shard through ``global_batch_from_local`` from weights placed with
  ``global_state_from_host`` gives the single-process ``ExactReducer``
  trajectory on the whole batches (1e-5: only the order of the sums
  differs, as ``test_torch_training.py``'s large-batch check), and the
  ranks' ``encode_shard`` outputs merge into the monolithic encode: the
  port's form of the JAX package's ``tests/multiprocess_worker.py``.
"""

import numpy as np
import pytest
import torch

from network_distributed_pytorch_tpu.data.multihost import merge_tokenized_shards as jax_merge
from network_distributed_pytorch_tpu.data.wordpiece import WordPieceTokenizer as JaxWordPiece
from network_distributed_pytorch_tpu_torch import data
from network_distributed_pytorch_tpu_torch.data.multihost import (
    global_batch_from_local,
    global_state_from_host,
    merge_tokenized_shards,
)
from network_distributed_pytorch_tpu_torch.data.wordpiece import WordPieceTokenizer
from torch_worker import (  # few_torch_threads: autouse
    TinyConvNet,
    exact_ddp_steps,
    few_torch_threads,
    multihost_rank,
    numpy_batches,
    run_all,
    spawn,
)

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "movie", "was", "great", "!", "un", "##believ", "##able", "café"]
TEXTS = [
    "the movie was great!", "unbelievable", "café movie", "", "the the the", "GREAT movie!!", "was it?",
    "the great unbelievable movie", "x" * 120,
]
BATCHES = numpy_batches(seed=21, n_steps=3, batch=8, hw=8)


def _vocab(tmp_path):
    vf = tmp_path / "vocab.txt"
    vf.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    return str(vf)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_merged_shards_are_the_jax_merge_and_the_monolithic_encode(tmp_path, world):
    vf = _vocab(tmp_path)
    tok, jtok = WordPieceTokenizer(vf, max_len=16), JaxWordPiece(vf, max_len=16)
    shards = [tok.encode_shard(TEXTS, world, r) for r in range(world)]
    merged = merge_tokenized_shards(shards)
    want = jax_merge([jtok.encode_shard(TEXTS, world, r) for r in range(world)])
    whole = tok(TEXTS)
    assert set(merged) == set(want) == {"input_ids", "attention_mask"}
    for k in merged:
        assert merged[k].tobytes() == np.asarray(want[k]).tobytes() == whole[k].tobytes()
    on_device = merge_tokenized_shards(shards, device="cpu")
    assert all(isinstance(v, torch.Tensor) and np.array_equal(v.numpy(), merged[k]) for k, v in on_device.items())


def test_merge_of_no_shards_raises():
    with pytest.raises(ValueError, match="no shards"):
        merge_tokenized_shards([])


def test_placement_keeps_the_structure_and_the_values():
    x, y = BATCHES[0]
    batch = global_batch_from_local({"x": x, "y": (y, torch.arange(3)), "n": 5}, torch.device("cpu"))
    assert isinstance(batch["x"], torch.Tensor) and np.array_equal(batch["x"].numpy(), x)
    assert isinstance(batch["y"], tuple) and np.array_equal(batch["y"][0].numpy(), y)
    assert torch.equal(batch["y"][1], torch.arange(3)) and batch["n"] == 5
    state = global_state_from_host([np.float32(2.5), x[:, 0], x[::-1]], "cpu")
    assert isinstance(state, list) and state[0].shape == () and state[0].item() == 2.5
    assert np.array_equal(state[1].numpy(), x[:, 0]) and np.array_equal(state[2].numpy(), x[::-1])


def test_data_exports_what_the_jax_packages_data_exports():
    import network_distributed_pytorch_tpu.data as jax_data

    jax_names = {n for n in dir(jax_data) if not n.startswith("_")} - {"annotations"}
    ours = {n for n in dir(data) if not n.startswith("_")}
    modules = {"cifar10", "imdb", "loader", "multihost", "partition", "wordpiece"}
    assert jax_names - modules <= ours


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("multihost")
    vf = _vocab(root)
    init = {k: v.detach().numpy().copy() for k, v in TinyConvNet().state_dict().items()}
    out = spawn(run_all, 2, root, [(multihost_rank, (init, BATCHES, vf, TEXTS))])
    return [r[0] for r in out], vf


def test_each_rank_on_its_own_shard_gives_the_single_process_trajectory(two_ranks):
    ranks, _ = two_ranks
    single = exact_ddp_steps(0, 1, None, BATCHES)
    for res in ranks:
        np.testing.assert_allclose(res["losses"], single["losses"], rtol=1e-5, atol=1e-5)
        for k, v in single["params"].items():
            torch.testing.assert_close(res["params"][k], v, rtol=1e-5, atol=1e-5)
    for k in ranks[0]["params"]:
        assert torch.equal(ranks[0]["params"][k], ranks[1]["params"][k])


def test_the_ranks_shards_merge_into_the_monolithic_encode(two_ranks):
    ranks, vf = two_ranks
    merged = merge_tokenized_shards([{k: v.numpy() for k, v in r["shard"].items()} for r in ranks])
    whole = JaxWordPiece(vf, max_len=16)(TEXTS)
    assert [len(r["shard"]["input_ids"]) for r in ranks] == [4, 5]  # shard_rows: rank * n // world, the larger shard last
    for k in merged:
        assert merged[k].tobytes() == np.asarray(whole[k]).tobytes()
