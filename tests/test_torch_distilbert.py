"""The DistilBERT/IMDb slice against the JAX package: the encoder and the
classifier's logits on both attention engines, from weights drawn with numpy
and carried across by ``distilbert_state_dict_from_flax``; the reducer's
(n, m, r) shape groups and bits, embedding tables included; two
``ef_momentum`` PowerSGD steps on one worker; the IMDb arrays; and the entry
point on the CPU.

Tolerances: fp32, 1e-5 for logits, hidden states and losses (the two sum
the same products in another order), and for parameters, momenta, error
memories and Q after each of two steps. The two-step check runs at PowerSGD
rank 1, where it holds every leaf over two steps in a row, and at the
slice's rank 16 (batch 16, lr 5e-5), where it holds every leaf whose
gradient has at least the rank r that the reducer gives it. The 2-label
classifier's gradient has rank 1 < r = 2 (its two columns are each other's
negatives): past a matrix's rank, Gram-Schmidt normalises rounding noise
into the extra columns of P-hat, in JAX and in PyTorch alike, and no
cross-framework tolerance holds there. So at rank 16 the port's second step
starts from the JAX state after the first, lest that noise reach the other
leaves through the forward pass. At rank 16, Q = M^T P-hat is held to
Q_TOL_RANK16: P-hat's later columns follow M's smaller singular values,
along which both frameworks' fp32 rounding grows (1.2e-5 at most here, on
pre_classifier, whose gradient sums 32 first-token outer products).
"""

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_distributed_pytorch_tpu.data import imdb as jax_imdb
from network_distributed_pytorch_tpu.models import distilbert as jax_distilbert
from network_distributed_pytorch_tpu.parallel.reducers import PowerSGDReducer as JaxPowerSGD
from network_distributed_pytorch_tpu.parallel.trainer import make_train_step as jax_make_train_step
from network_distributed_pytorch_tpu.utils.losses import cross_entropy_loss as jax_cross_entropy
from network_distributed_pytorch_tpu_torch.data import imdb
from network_distributed_pytorch_tpu_torch.experiments import powersgd_imdb
from network_distributed_pytorch_tpu_torch.models import distilbert
from network_distributed_pytorch_tpu_torch.models.import_weights import (
    distilbert_state_dict_from_flax,
    distilbert_torch_name,
    powersgd_state_from_jax,
)
from network_distributed_pytorch_tpu_torch.parallel.reducers import PowerSGDReducer, embedding_leaves
from network_distributed_pytorch_tpu_torch.parallel.trainer import make_train_step
from network_distributed_pytorch_tpu_torch.utils.config import ExperimentConfig
from torch_parity import random_distilbert_params, to_numpy
from torch_worker import few_torch_threads  # noqa: F401  (autouse)

TOL = 1e-5
LR = 0.01
B, T = 4, 32
RANK = 16  # the slice's rank: shape groups, bits and the second two-step case
Q_TOL_RANK16 = 5e-5  # see above


def _random_params(model, seed):
    return random_distilbert_params(model, T, seed)


def _batch(seed, vocab=1024, b=B):
    """(input_ids, attention_mask, labels): padded tails of several lengths,
    every fourth row with [CLS] and [SEP] alone."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, vocab, (b, T)).astype(np.int32)
    mask = np.ones((b, T), np.int32)
    for row in range(b):
        length = (T, 20, 9, 2)[row % 4]
        mask[row, length:] = 0
        ids[row, length:] = 0
    labels = rng.randint(0, 2, (b,)).astype(np.int32)
    return ids, mask, labels


def _port_model(params, attn_impl):
    model = distilbert.distilbert_tiny(device="cpu", attn_impl=attn_impl)
    model.load_state_dict(distilbert_state_dict_from_flax({"params": to_numpy(params)}))
    return model


@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_encoder_and_logits_match_jax(attn_impl):
    jmodel = jax_distilbert.DistilBertForSequenceClassification(
        dataclasses.replace(jax_distilbert.distilbert_tiny().config, attn_impl=attn_impl)
    )
    params = _random_params(jmodel, seed=1)
    ids, mask, _ = _batch(2)
    want_logits = jmodel.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    want_hidden = jax_distilbert.DistilBertEncoder(jmodel.config).apply(
        {"params": params["distilbert"]}, jnp.asarray(ids), jnp.asarray(mask)
    )
    model = _port_model(params, attn_impl)
    with torch.no_grad():
        tids, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
        hidden = model.distilbert(tids, tmask)
        logits = model(tids, tmask)
    assert logits.dtype == torch.float32
    # every position: padded queries attend to the real keys of their row
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want_hidden), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=TOL, atol=TOL)


def _jax_groups(model, max_len, rank=RANK):
    shapes = jax.eval_shape(
        lambda: model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, max_len), jnp.int32), jnp.ones((1, max_len), jnp.int32)
        )
    )["params"]
    leaves = jax.tree_util.tree_leaves(shapes)
    reducer = JaxPowerSGD(compression_rank=rank, matricize="last")
    groups = collections.Counter((m.n, m.m, m.r) for m in reducer._metas(leaves))
    return groups, reducer.bits_per_step(shapes)


def _port_groups(model, rank=RANK):
    params = list(model.parameters())
    reducer = PowerSGDReducer(compression_rank=rank, matricize="last", features_last=embedding_leaves(model))
    metas = reducer._metas(params)
    assert reducer.n_shape_groups(params) == len({(m.n, m.m, m.r) for m in metas})
    return collections.Counter((m.n, m.m, m.r) for m in metas), reducer.bits_per_step(params)


@pytest.mark.parametrize("preset", ["tiny", "base"])
def test_reducer_shape_groups_match_jax(preset):
    """The port's (n, m, r) groups, with their counts, are the JAX
    reducer's, the embedding tables as stored (vocab, dim) and not
    transposed; so are the bits per step."""
    if preset == "tiny":
        jmodel, model = jax_distilbert.distilbert_tiny(), distilbert.distilbert_tiny(device="cpu")
    else:
        jmodel, model = jax_distilbert.distilbert_base(), distilbert.distilbert_base(device="cpu")
    want_groups, want_bits = _jax_groups(jmodel, 64)
    groups, bits = _port_groups(model)
    assert groups == want_groups
    assert bits == want_bits
    if preset == "base":
        assert sum(p.numel() for p in model.parameters()) == 66_955_010
        assert groups == {
            (30522, 768, 16): 1, (512, 768, 16): 1, (768, 768, 16): 25,
            (768, 3072, 16): 6, (3072, 768, 16): 6, (768, 2, 2): 1,
        }
        assert bits == 61_969_600


def _jax_loss(jmodel):
    def loss_fn(params, model_state, batch):
        ids, mask, labels = batch
        logits = jmodel.apply({"params": params}, ids, mask, deterministic=True)
        return jax_cross_entropy(logits, labels), model_state

    return loss_fn


@functools.lru_cache(maxsize=None)
def _jax_two_steps(rank, b, lr):
    """The JAX step, its initial Q, the batches, and the state and loss
    after each of two steps."""
    jmodel = jax_distilbert.distilbert_tiny()
    params = _random_params(jmodel, seed=3)
    step = jax_make_train_step(
        _jax_loss(jmodel), JaxPowerSGD(random_seed=1, compression_rank=rank, matricize="last"),
        params, lr, momentum=0.9, algorithm="ef_momentum", mesh=None, donate_state=False,
    )
    state = step.init_state(params)
    q0 = np.asarray(jax.device_get(state.reducer_state.q_memory))
    batches = [_batch(10 + i, b=b) for i in range(2)]
    states, losses = [], []
    for batch in batches:
        state, loss = step(state, tuple(jnp.asarray(a) for a in batch))
        states.append(state)
        losses.append(float(loss))
    return params, q0, batches, step, states, losses


def _rank_deficient(model, reducer, batch):
    """Names of the compressed leaves whose gradient on ``batch`` has a rank
    below the reducer's r for them."""
    names, params = zip(*model.named_parameters())
    powersgd_imdb.sequence_classifier_loss()(model, tuple(torch.from_numpy(a) for a in batch)).backward()
    low = {
        names[m.leaf_index] for m in reducer._metas(list(params))
        if torch.linalg.matrix_rank(params[m.leaf_index].grad) < m.r
    }
    model.zero_grad(set_to_none=True)
    return low


@pytest.mark.parametrize("rank,b,lr", [(1, B, LR), (RANK, 32, 5e-5)], ids=["rank1", "rank16"])
def test_two_ef_momentum_steps_match_jax(rank, b, lr):
    """One worker, two PowerSGD ef_momentum steps from the same weights,
    batches and initial Q: after each step the loss and, for every leaf
    whose gradient rank reaches its r, the parameters, momenta, error
    memories and Q (see above). The port runs flash attention (its plain
    version), the JAX step einsum (its ``"auto"`` off the TPU)."""
    params, q0, batches, jstep, jstates, jlosses = _jax_two_steps(rank, b, lr)
    model = _port_model(params, "auto")
    reducer = PowerSGDReducer(
        random_seed=1, compression_rank=rank, matricize="last", features_last=embedding_leaves(model)
    )
    skipped = set()
    for batch in batches:
        skipped |= _rank_deficient(model, reducer, batch)
    # at rank 1 no leaf falls short of its r; at rank 16 only the classifier
    assert skipped == (set() if rank == 1 else {"classifier.weight"})
    step = make_train_step(powersgd_imdb.sequence_classifier_loss(), reducer, model, lr, 0.9, "ef_momentum")
    assert step.bits_per_step == jstep.bits_per_step
    state = step.init_state()
    state.reducer_state = powersgd_state_from_jax(q0, params, reducer, model, name_map=distilbert_torch_name)
    names, leaves = zip(*model.named_parameters())
    metas = reducer._metas(list(leaves))
    _, q_packer, _ = reducer._packers(list(leaves), metas)
    for i, (batch, jstate, jloss) in enumerate(zip(batches, jstates, jlosses)):
        if i and skipped:  # start from the JAX state, the skipped leaves' noise included
            with torch.no_grad():
                for what in ("params", "momenta", "memories"):
                    want = distilbert_state_dict_from_flax({"params": to_numpy(getattr(jstates[i - 1], what))})
                    for name, t in getattr(state, what).items():
                        t.copy_(want[name])
            state.reducer_state = powersgd_state_from_jax(
                np.asarray(jstates[i - 1].reducer_state.q_memory), params, reducer, model,
                name_map=distilbert_torch_name,
            )
        state, loss = step(state, tuple(torch.from_numpy(a) for a in batch))
        np.testing.assert_allclose(float(loss), jloss, rtol=TOL, atol=TOL, err_msg=f"loss of step {i}")
        for what in ("params", "momenta", "memories"):
            want = distilbert_state_dict_from_flax({"params": to_numpy(getattr(jstate, what))})
            got = getattr(state, what)
            assert set(got) == set(want)
            for name in sorted(set(want) - skipped):
                np.testing.assert_allclose(
                    got[name].detach().numpy(), want[name].numpy(), rtol=TOL, atol=TOL,
                    err_msg=f"step {i}: {what} {name}",
                )
        q_want = powersgd_state_from_jax(
            np.asarray(jstate.reducer_state.q_memory), params, reducer, model, name_map=distilbert_torch_name
        ).q_memory
        q_tol = TOL if rank == 1 else Q_TOL_RANK16
        for meta, got, want in zip(metas, q_packer.unpack(state.reducer_state.q_memory), q_packer.unpack(q_want)):
            if names[meta.leaf_index] not in skipped:
                np.testing.assert_allclose(
                    got.numpy(), want.numpy(), rtol=q_tol, atol=q_tol, err_msg=f"step {i}: Q {names[meta.leaf_index]}"
                )


def test_prepare_imdb_matches_jax():
    kw = dict(max_len=48, vocab_size=1024, synthetic_n=256, seed=714)
    got, want = imdb.prepare_imdb(**kw), jax_imdb.prepare_imdb(**kw)
    assert got[2] is False and want[2] is False
    for split_got, split_want in zip(got[:2], want[:2]):
        for key in ("input_ids", "attention_mask", "labels"):
            assert split_got[key].dtype == np.int32
            np.testing.assert_array_equal(split_got[key], split_want[key])
    texts = ["Great movie , really GREAT", "x " * 80, ""]
    tok = imdb.HashTokenizer(vocab_size=1024, max_len=16)
    jtok = jax_imdb.HashTokenizer(vocab_size=1024, max_len=16)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(tok(texts)[key], jtok.python_call(texts)[key])
    with pytest.raises(ValueError):
        imdb.HashTokenizer(max_len=1)


def test_vocab_file_raises_until_wordpiece_is_ported(tmp_path):
    """WordPiece is ported: a ``vocab.txt`` selects it, so a file without
    its special tokens is refused by the tokenizer (the hash tokenizer
    would ignore it), and a whole one tokenizes (``test_torch_wordpiece.py``
    holds it to the JAX and HF tokenizers)."""
    (tmp_path / "vocab.txt").write_text("[PAD]\n")
    with pytest.raises(ValueError, match="special token"):
        imdb.prepare_imdb(data_dir=str(tmp_path), max_len=8, synthetic_n=16)
    (tmp_path / "vocab.txt").write_text("[PAD]\n[UNK]\n[CLS]\n[SEP]\n[MASK]\n")
    train, _, _ = imdb.prepare_imdb(data_dir=str(tmp_path), max_len=8, synthetic_n=16)
    assert (train["input_ids"][:, 0] == 2).all() and set(np.unique(train["input_ids"])) <= {0, 1, 2, 3}


def test_run_on_cpu_end_to_end():
    cfg = powersgd_imdb.default_config()
    cfg.training_epochs = 1
    out = powersgd_imdb.run(cfg, preset="small", device="cpu", max_steps_per_epoch=2)
    assert out["steps"] == 2 and out["num_devices"] == 1 and not out["real_data"]
    assert out["global_batch"] == 16 and out["max_len"] == 64
    assert all(np.isfinite(out["losses"]))
    _, jax_bits = _jax_groups(jax_distilbert.distilbert_tiny(), 64)
    # one rank still sums the loss through its (Gloo) group: + 32 bits
    assert out["bits_per_step"] == jax_bits + 32


def test_attn_impl_options():
    assert ExperimentConfig(attn_impl="flash").attn_impl == "flash"
    with pytest.raises(ValueError):
        ExperimentConfig(attn_impl="pallas")
    model = distilbert.distilbert_tiny(device="cpu", attn_impl="flash")
    ids, mask, _ = (torch.from_numpy(a) for a in _batch(4))
    with pytest.raises(ValueError, match="attention_dropout"):
        model(ids, mask, deterministic=False)
    # rematerialisation is ported: the same weights and logits, the block recomputed in the backward
    remat = distilbert.distilbert_tiny(device="cpu", attn_impl="flash", remat=True)
    assert remat.config.remat and torch.equal(remat(ids, mask), model(ids, mask))
    # sequence parallelism is ported: the schedule is checked, dropout refused
    with pytest.raises(ValueError, match="seq_impl"):
        distilbert.DistilBertConfig(seq_impl="pallas")
    sp = distilbert.DistilBertConfig(seq_axis=object(), seq_impl="ulysses", n_layers=1, dim=32, n_heads=4)
    block = distilbert.MultiHeadSelfAttention(sp)
    with pytest.raises(ValueError, match="attention_dropout"):
        block._attn_impl(deterministic=False)
    assert block._attn_impl(deterministic=True) == "ulysses"


@pytest.mark.parametrize("field", [{"compress_impl": "pallas"}, {"orthogonalize_impl": "eager"}])
def test_build_refuses_other_reducer_pipelines(field):
    """powersgd_imdb builds the JAX package's default reducer pipeline."""
    with pytest.raises(ValueError, match=next(iter(field))):
        powersgd_imdb.build(ExperimentConfig(**field), "small", "cpu", group=None)


def test_launcher_runs_powersgd_imdb_on_cpu(capsys):
    """The launcher takes powersgd_imdb's own defaults (lr 5e-5, rank 16,
    16 sequences per worker), maps the default ``--data-dir`` to synthetic
    data and passes ``--attn-impl`` on."""
    from network_distributed_pytorch_tpu_torch import launch

    args = [
        "powersgd_imdb", "--device", "cpu", "--epochs", "1", "--max-steps-per-epoch", "1", "--attn-impl", "einsum",
        "--json",
    ]
    cfg = launch.config_from_args(launch.build_parser().parse_args(args))
    assert (cfg.learning_rate, cfg.reducer_rank, cfg.global_batch_size, cfg.attn_impl) == (5e-5, 16, 0, "einsum")
    out = launch.main(args)
    assert out["experiment"] == "powersgd_imdb" and out["steps"] == 1 and not out["real_data"]
    assert out["global_batch"] == 16 and np.isfinite(out["losses"]).all()
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("{")


def test_entry_points_raise_without_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        powersgd_imdb.run(preset="small", max_steps_per_epoch=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        powersgd_imdb.build_model("small")
