"""``scripts/torch_accuracy_study.py`` against the JAX package's
``scripts/accuracy_study.py``, on the CPU: the task draws of both tasks and
both IMDb tiers (arrays, ceilings, the realized flip) exactly;
``run_to_plateau`` on the same faked accuracy sequences; ``_slim``,
``_multi_seed`` and ``_save``; each arm's first two steps from
JAX-initialised parameters against the JAX ``make_train_step`` with the
arguments the JAX script passes; each arm's bits at the JAX study's 8
workers; and a cut end-to-end run. Neither script's ``artifacts/`` file is
written: both ``OUT`` paths point into ``tmp_path``.

Tolerances, fp32: the ResNet arms 1e-4 for parameters, momenta, error
memories and BatchNorm's running means after two steps, 1e-5 for the
losses (``tests/test_torch_training.py``'s class: XLA and PyTorch sum the
convolutions' backward in other orders); the DistilBERT arms 1e-5, and 5e-5
for Q at rank 16 (``tests/test_torch_distilbert.py``'s class). At rank 16 a
leaf whose gradient has a rank below the r the reducer gives it (the
2-label classifier, whose two columns are each other's negatives) gets rounding noise normalised into
P-hat's extra columns in both frameworks, so that leaf is left out and the
second step starts from the JAX state after the first, as that file does.
The DistilBERT steps run on random token ids (see ``_imdb_batches``).
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_distributed_pytorch_tpu.data import cifar10 as jax_cifar10
from network_distributed_pytorch_tpu.data import imdb as jax_imdb
from network_distributed_pytorch_tpu.data import loader as jax_loader
from network_distributed_pytorch_tpu.experiments.common import image_classifier_loss as jax_image_loss
from network_distributed_pytorch_tpu.models import distilbert_tiny as jax_distilbert_tiny
from network_distributed_pytorch_tpu.models import distilbert_wide as jax_distilbert_wide
from network_distributed_pytorch_tpu.models import resnet18 as jax_resnet18
from network_distributed_pytorch_tpu.parallel import ExactReducer as JaxExact
from network_distributed_pytorch_tpu.parallel import PowerSGDReducer as JaxPowerSGD
from network_distributed_pytorch_tpu.parallel import make_mesh
from network_distributed_pytorch_tpu.parallel.trainer import make_train_step as jax_make_train_step
from network_distributed_pytorch_tpu.parallel.trainer import stateless_loss
from network_distributed_pytorch_tpu.utils.losses import cross_entropy_loss as jax_cross_entropy
from network_distributed_pytorch_tpu_torch.experiments import common
from network_distributed_pytorch_tpu_torch.experiments.common import process_group
from network_distributed_pytorch_tpu_torch.models.import_weights import (
    distilbert_state_dict_from_flax,
    distilbert_torch_name,
    powersgd_state_from_jax,
    resnet_state_dict_from_flax,
)
from network_distributed_pytorch_tpu_torch.utils.config import ExperimentConfig
from torch_parity import random_distilbert_params, random_flax_variables, to_numpy
from torch_worker import few_torch_threads  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESNET_TOL, RESNET_LOSS_TOL = 1e-4, 1e-5
BERT_TOL, Q_TOL_RANK16 = 1e-5, 5e-5
# rows a parity step (the arms' lr, momentum and reducers are the study's):
# 32 sequences give every DistilBERT leaf but the classifier's its full r
CIFAR_STEP_BATCH, IMDB_STEP_BATCH = 8, 32


def _load(name, path, monkeypatch, tmp_path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "OUT", str(tmp_path / f"{name}.json"))
    return mod


@pytest.fixture
def scripts(monkeypatch, tmp_path):
    """``(port, jax)``: both scripts, their records redirected to ``tmp_path``.
    A non-"cpu" ``ACCURACY_STUDY_PLATFORM`` skips the JAX script's
    module-level device set-up, which the conftest has already made."""
    monkeypatch.setenv("ACCURACY_STUDY_PLATFORM", "preset-by-conftest")
    return (
        _load("torch_accuracy_study", "torch_accuracy_study.py", monkeypatch, tmp_path),
        _load("accuracy_study", "accuracy_study.py", monkeypatch, tmp_path),
    )


# ---- the task draws --------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_cifar_draw_and_ceiling_equal_the_jax_scripts(scripts, seed):
    port, ref = scripts
    assert (port.CIFAR_CLASS_SEP, port.CIFAR_LABEL_NOISE) == (ref.CIFAR_CLASS_SEP, ref.CIFAR_LABEL_NOISE)
    task = port.cifar_task(seed)
    images, labels, means = jax_cifar10.synthetic_cifar10(
        5120, seed=seed, class_sep=ref.CIFAR_CLASS_SEP, label_noise=ref.CIFAR_LABEL_NOISE, return_means=True,
    )
    for got, want in (
        (task["train_x"], images[:4096]), (task["train_y"], labels[:4096]),
        (task["test_x"], images[4096:]), (task["test_y"], labels[4096:]),
    ):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert task["ceiling"] == ref._nearest_mean_accuracy(images[4096:], labels[4096:], means)
    assert 0.8 < task["ceiling"] < 0.95


@pytest.mark.parametrize("wide", [False, True], ids=["tiny", "wide"])
@pytest.mark.parametrize("seed", [0, 1])
def test_imdb_draws_and_realized_flip_equal_the_jax_scripts(scripts, seed, wide):
    port, ref = scripts
    assert (port.IMDB_LABEL_NOISE, port.IMDB_CLASS_WORD_RATE) == (ref.IMDB_LABEL_NOISE, ref.IMDB_CLASS_WORD_RATE)
    task = port.imdb_task(seed, wide)
    max_len = 32 if wide else 64

    def draw(noise):
        return jax_imdb.prepare_imdb(
            max_len=max_len, synthetic_n=2048, vocab_size=1024, seed=714 + seed,
            synthetic_kwargs=dict(class_word_rate=ref.IMDB_CLASS_WORD_RATE, label_noise=noise),
        )

    train, val, _ = draw(ref.IMDB_LABEL_NOISE)
    _, clean, _ = draw(0.0)
    assert task["max_len"] == max_len
    for got, want in ((task["train"], train), (task["val"], val)):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert task["realized_flip"] == float((val["labels"] != clean["labels"]).mean())
    assert 0.05 < task["realized_flip"] < 0.2


# ---- run_to_plateau ----------------------------------------------------------------


class _FakeLogger:
    def summary(self):
        return {"steps": 4}


class _FakeStep:
    bits_per_step = 800


PLATEAU_CASES = {
    # steady sub-min_delta gains: the mark stays at epoch 0, the best is the true maximum
    "best_tracks_small_gains": ([0.90, 0.901, 0.9012, 0.9013, 0.9014, 0.9015], 30, 3),
    # patience met on the last allowed epoch: plateaued all the same
    "break_on_last_epoch": ([0.5, 0.9, 0.9, 0.9, 0.9], 5, 3),
    # still climbing when the budget runs out: not plateaued
    "budget_capped": ([0.1, 0.2, 0.3, 0.4, 0.5, 0.6], 4, 3),
    # a dip below the mark and a recovery past it restart the patience
    "dip_and_recovery": ([0.5, 0.6, 0.55, 0.58, 0.7, 0.69, 0.7, 0.7], 30, 2),
}


@pytest.mark.parametrize("case", list(PLATEAU_CASES))
def test_run_to_plateau_matches_the_jax_script(scripts, monkeypatch, case):
    """The same faked accuracies through both scripts' ``run_to_plateau``
    (each with its package's ``train_loop`` faked): equal records but the
    wall seconds."""
    import network_distributed_pytorch_tpu.experiments.common as jax_common

    port, ref = scripts
    accs, max_epochs, patience = PLATEAU_CASES[case]
    loops = []

    def fake_loop(step, state, batches, epochs, *args, **kw):
        loops.append((epochs, kw.get("world_size", 1)))
        return state, _FakeLogger()

    monkeypatch.setattr(jax_common, "train_loop", fake_loop)
    monkeypatch.setattr(common, "train_loop", fake_loop)
    records = []
    for mod in (port, ref):
        calls = {"n": 0}

        def evaluate(step, state, calls=calls):
            i = min(calls["n"], len(accs) - 1)
            calls["n"] += 1
            return accs[i]

        rec = mod.run_to_plateau("t", _FakeStep(), None, lambda e: iter(()), evaluate, max_epochs, patience)
        records.append({k: v for k, v in rec.items() if k != "wall_s"})
    assert records[0] == records[1]
    assert len(loops) == 2 * records[0]["epochs_run"] and set(loops) == {(1, 1)}
    if case == "best_tracks_small_gains":
        assert records[0]["best_accuracy"] == 0.9013 and records[0]["epochs_run"] == 4 and records[0]["plateaued"]
    if case == "budget_capped":
        assert not records[0]["plateaued"] and records[0]["total_mb_on_wire"] == round(800 * 16 / 8e6, 2)


# ---- the seeds and the record ------------------------------------------------------


def _fake_task(seed, best=0.8):
    return {
        "hardness": {"label_noise": 0.12, "accuracy_ceiling_realized": 0.88 - 0.01 * seed},
        "arms": {
            "exact": {"best_accuracy": best + 0.01 * seed},
            "powersgd_r16": {"best_accuracy": best - 0.02 * seed},
        },
        "accuracy_delta_pts": round(100 * (0.03 * seed), 2),
        "gradient_bytes_ratio": 9.2,
    }


def test_slim_matches_the_jax_script(scripts):
    port, ref = scripts
    for seed in (0, 2):
        assert port._slim(_fake_task(seed), seed) == ref._slim(_fake_task(seed), seed)


@pytest.mark.parametrize("seeds", [1, 3])
def test_multi_seed_matches_the_jax_script(scripts, seeds):
    """The seed-0 record, the slim rows, the per-seed deltas and the worst,
    and a save after every seed, as the JAX script's."""
    port, ref = scripts
    outs = []
    for mod in (port, ref):
        saved, calls = [], []

        def study(max_epochs, patience, data_seed=0, calls=calls):
            calls.append((max_epochs, patience, data_seed))
            return _fake_task(data_seed)

        rec = mod._multi_seed(study, 7, 2, seeds, lambda r, saved=saved: saved.append(json.dumps(r, sort_keys=True)))
        outs.append((rec, saved, calls))
    assert outs[0] == outs[1]
    assert len(outs[0][1]) == seeds and [c[2] for c in outs[0][2]] == list(range(seeds))


def test_save_merges_and_sidelines_a_corrupt_file_as_the_jax_script(scripts, tmp_path):
    port, ref = scripts
    for mod in (port, ref):
        with open(mod.OUT, "w") as f:
            json.dump({"imdb": {"keep": 1}, "device": "old", "n_devices": 8}, f)
        mod._save({"cifar": {"new": 2}})
        with open(mod.OUT + ".tmp", "w") as f:  # a stale temporary is replaced, never read
            f.write("{")
        mod._save({"imdb_wide": {"w": 3}})
    docs = [json.load(open(mod.OUT)) for mod in (port, ref)]
    assert docs[0] == docs[1] == {"imdb": {"keep": 1}, "cifar": {"new": 2}, "imdb_wide": {"w": 3}}
    for mod in (port, ref):
        with open(mod.OUT, "w") as f:
            f.write('{"cifar": {"trunc')
        mod._save({"imdb": {"fresh": 1}})
        assert json.load(open(mod.OUT)) == {"imdb": {"fresh": 1}}
        assert open(mod.OUT + ".corrupt").read() == '{"cifar": {"trunc'


# ---- each arm's first two steps against the JAX step ----------------------------------


def _cifar_batches(port):
    task = port.cifar_task(0)
    it = jax_loader.iterate_batches([task["train_x"], task["train_y"]], CIFAR_STEP_BATCH, shuffle=True, seed=1234)
    return [next(it) for _ in range(2)]


def _imdb_batches(wide):
    """Two batches of random token ids of the tier's ``max_len``, padded
    tails of several lengths (``tests/test_torch_distilbert.py``'s): a
    batch of the synthetic reviews, 40 words from a small vocabulary, gives
    gradients whose singular values near r = 16 lie within 1e-4 of the
    largest, a split that fp32 rounding in either framework moves."""
    max_len = 32 if wide else 64
    out = []
    for seed in (30, 31):
        rng = np.random.RandomState(seed)
        ids = rng.randint(3, 1024, (IMDB_STEP_BATCH, max_len)).astype(np.int32)
        mask = np.ones_like(ids)
        for row in range(IMDB_STEP_BATCH):
            length = (max_len, 20, 9, 2)[row % 4]
            mask[row, length:] = 0
            ids[row, length:] = 0
        out.append((ids, mask, rng.randint(0, 2, (IMDB_STEP_BATCH,)).astype(np.int32)))
    return out


def _jax_reducer(rank):
    if rank is None:
        return JaxExact()
    return JaxPowerSGD(random_seed=714, compression_rank=rank, matricize="last")


def _close(got, want, tol, what, skip=()):
    assert set(want) <= set(got), what
    for name in sorted(set(want) - set(skip)):
        np.testing.assert_allclose(
            got[name].detach().numpy(), want[name].numpy(), rtol=tol, atol=tol, err_msg=f"{what} {name}"
        )


@pytest.mark.parametrize("arm", ["exact", "powersgd_r4"])
def test_cifar_arm_two_steps_match_the_jax_step(scripts, arm):
    """The port's arm (``build_cifar_arm``) from the JAX variables against
    ``make_train_step`` as the JAX script calls it, one worker."""
    port, ref = scripts
    rank, algorithm = port.CIFAR_ARMS[arm]
    jmodel = jax_resnet18(num_classes=10, norm="batch", stem="cifar", width=16)
    variables = random_flax_variables(jmodel, (1, 32, 32, 3), seed=21)
    jstep = jax_make_train_step(
        jax_image_loss(jmodel, has_batch_stats=True), _jax_reducer(rank), variables["params"],
        learning_rate=0.02, momentum=0.9, algorithm=algorithm, mesh=None, donate_state=False,
    )
    jstate = jstep.init_state(variables["params"], model_state={"batch_stats": variables["batch_stats"]})
    q0 = np.asarray(jax.device_get(jstate.reducer_state.q_memory)) if rank else None
    batches = _cifar_batches(port)
    jlosses = []
    for b in batches:
        jstate, loss = jstep(jstate, tuple(jnp.asarray(a) for a in b))
        jlosses.append(float(loss))

    model, step, state = port.build_cifar_arm(arm, "cpu", None, resnet_state_dict_from_flax(to_numpy(variables)))
    if rank:
        state.reducer_state = powersgd_state_from_jax(q0, variables["params"], step.reducer, model)
    losses = []
    for b in batches:
        state, loss = step(state, tuple(torch.from_numpy(a) for a in b))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=RESNET_LOSS_TOL, atol=RESNET_LOSS_TOL)
    for what in ("params", "momenta", "memories"):
        want = resnet_state_dict_from_flax({"params": to_numpy(getattr(jstate, what))})
        _close(getattr(state, what), want, RESNET_TOL, what)
    stats = resnet_state_dict_from_flax({"params": {}, "batch_stats": to_numpy(jstate.model_state["batch_stats"])})
    _close(state.model_state, {k: v for k, v in stats.items() if k.endswith("running_mean")}, RESNET_TOL, "bn")
    assert (step.learning_rate, step.momentum, step.algorithm) == (0.02, 0.9, algorithm)


def _rank_deficient(port, model, reducer, batch):
    """Names of the compressed leaves whose gradient on ``batch`` has a rank
    below the reducer's r for them."""
    from network_distributed_pytorch_tpu_torch.experiments.powersgd_imdb import sequence_classifier_loss

    names, params = zip(*model.named_parameters())
    sequence_classifier_loss()(model, tuple(torch.from_numpy(a) for a in batch)).backward()
    low = {
        names[m.leaf_index] for m in reducer._metas(list(params))
        if torch.linalg.matrix_rank(params[m.leaf_index].grad) < m.r
    }
    model.zero_grad(set_to_none=True)
    return low


@pytest.mark.parametrize("arm", ["exact", "powersgd_r16"])
@pytest.mark.parametrize("wide", [False, True], ids=["tiny", "wide"])
def test_imdb_arm_two_steps_match_the_jax_step(scripts, wide, arm):
    """The port's arm (``build_imdb_arm``) from the JAX parameters against
    ``make_train_step(stateless_loss(...))`` as the JAX script calls it, one
    worker; at rank 16 the rank-deficient classifier is left out (see
    above)."""
    port, ref = scripts
    rank, algorithm = port.IMDB_ARMS[arm]
    max_len = 32 if wide else 64
    lr = 0.002 if wide else 0.005
    jmodel = (jax_distilbert_wide if wide else jax_distilbert_tiny)(num_labels=2)
    params = random_distilbert_params(jmodel, max_len, seed=23)

    def loss(p, batch):
        ids, mask, y = batch
        return jax_cross_entropy(jmodel.apply({"params": p}, ids, mask, deterministic=True), y)

    jstep = jax_make_train_step(
        stateless_loss(loss), _jax_reducer(rank), params, learning_rate=lr, momentum=0.9, algorithm=algorithm,
        mesh=None, donate_state=False,
    )
    jstate = jstep.init_state(params)
    q0 = np.asarray(jax.device_get(jstate.reducer_state.q_memory)) if rank else None
    batches = _imdb_batches(wide)
    jstates, jlosses = [], []
    for b in batches:
        jstate, loss_value = jstep(jstate, tuple(jnp.asarray(a) for a in b))
        jstates.append(jstate)
        jlosses.append(float(loss_value))

    model, step, state = port.build_imdb_arm(arm, wide, "cpu", None, distilbert_state_dict_from_flax({"params": to_numpy(params)}))
    assert model.config.dim == (256 if wide else 32) and step.learning_rate == lr

    def carried_q(q):
        return powersgd_state_from_jax(q, params, step.reducer, model, name_map=distilbert_torch_name)

    skipped = set()
    if rank:
        state.reducer_state = carried_q(q0)
        for b in batches:
            skipped |= _rank_deficient(port, model, step.reducer, b)
        assert skipped == {"classifier.weight"}, skipped
    for i, (b, jst, jloss) in enumerate(zip(batches, jstates, jlosses)):
        if i and skipped:  # start from the JAX state, the skipped leaves' noise included
            with torch.no_grad():
                for what in ("params", "momenta", "memories"):
                    want = distilbert_state_dict_from_flax({"params": to_numpy(getattr(jstates[i - 1], what))})
                    for name, t in getattr(state, what).items():
                        t.copy_(want[name])
            state.reducer_state = carried_q(np.asarray(jstates[i - 1].reducer_state.q_memory))
        state, loss_value = step(state, tuple(torch.from_numpy(a) for a in b))
        np.testing.assert_allclose(float(loss_value), jloss, rtol=BERT_TOL, atol=BERT_TOL, err_msg=f"loss {i}")
        for what in ("params", "momenta", "memories"):
            want = distilbert_state_dict_from_flax({"params": to_numpy(getattr(jst, what))})
            _close(getattr(state, what), want, BERT_TOL, f"step {i}: {what}", skipped)
        if rank:
            names, leaves = zip(*model.named_parameters())
            metas = step.reducer._metas(list(leaves))
            _, q_packer, _ = step.reducer._packers(list(leaves), metas)
            got = q_packer.unpack(state.reducer_state.q_memory)
            want = q_packer.unpack(carried_q(np.asarray(jst.reducer_state.q_memory)).q_memory)
            for meta, g, w in zip(metas, got, want):
                if names[meta.leaf_index] not in skipped:
                    np.testing.assert_allclose(
                        g.numpy(), w.numpy(), rtol=Q_TOL_RANK16, atol=Q_TOL_RANK16,
                        err_msg=f"step {i}: Q {names[meta.leaf_index]}",
                    )


@pytest.mark.parametrize("wide", [False, True], ids=["tiny", "wide"])
def test_imdb_arms_start_at_the_jax_models_init_scale(scripts, wide):
    """Without carried weights an IMDb arm starts from flax's default
    initializers, as the JAX study's model does (the port's model alone
    draws HuggingFace's std 0.02): every leaf's standard deviation within
    four standard errors of the JAX ``model.init``'s, biases 0 and
    LayerNorm 1 and 0 exactly."""
    port, _ = scripts
    max_len = 32 if wide else 64
    jmodel = (jax_distilbert_wide if wide else jax_distilbert_tiny)(num_labels=2)
    params = jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, max_len), jnp.int32), jnp.ones((1, max_len), jnp.int32),
        deterministic=True,
    )["params"]
    want = distilbert_state_dict_from_flax({"params": to_numpy(params)})
    model, step, state = port.build_imdb_arm("exact", wide, "cpu", None)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].detach()
        if float(w.std()) == 0.0 or w.numel() == 1:
            assert torch.equal(g, w), name
            continue
        bound = 4.0 / np.sqrt(2.0 * w.numel())  # the relative standard error of a std estimate, four times
        assert abs(float(g.std()) / float(w.std()) - 1.0) < bound, (name, float(g.std()), float(w.std()))
        assert abs(float(g.mean())) < 4.0 * float(w.std()) / np.sqrt(w.numel()), name
    twin, _, _ = port.build_imdb_arm("powersgd_r16", wide, "cpu", None)
    for name, t in twin.named_parameters():  # both arms start from the same state
        assert torch.equal(t, got[name]), name


# ---- the bits at 8 workers ---------------------------------------------------------------


def test_each_arms_bits_equal_the_jax_step_at_eight_workers(scripts):
    """Each arm's ``bits_per_step`` at 8 workers and each task's byte ratio
    equal the JAX step's on an 8-device mesh, computed live."""
    port, ref = scripts
    mesh = make_mesh(devices=jax.devices()[:8])
    assert mesh.size == port.JAX_WORKERS == 8
    cases = {
        "cifar": (port.CIFAR_ARMS, lambda arm: port.build_cifar_arm(arm, "cpu", None),
                  jax_resnet18(num_classes=10, norm="batch", stem="cifar", width=16), (1, 32, 32, 3)),
        "imdb": (port.IMDB_ARMS, lambda arm: port.build_imdb_arm(arm, False, "cpu", None), jax_distilbert_tiny(), 64),
        "imdb_wide": (port.IMDB_ARMS, lambda arm: port.build_imdb_arm(arm, True, "cpu", None), jax_distilbert_wide(), 32),
    }
    got = {}
    for task, (arms, build, jmodel, shape) in cases.items():
        if task == "cifar":
            jparams = random_flax_variables(jmodel, shape, seed=0)["params"]
        else:
            jparams = random_distilbert_params(jmodel, shape, seed=0)
        bits = {}
        for arm, (rank, algorithm) in arms.items():
            model, step, _ = build(arm)
            jstep = jax_make_train_step(
                lambda p, s, b: (0.0, s), _jax_reducer(rank), jparams, learning_rate=0.01, momentum=0.9,
                algorithm=algorithm, mesh=mesh, donate_state=False,
            )
            assert port.arm_bits(step, model) == jstep.bits_per_step, (task, arm)
            bits[arm] = jstep.bits_per_step
        got[task] = bits
        exact, compressed = bits["exact"], min(v for k, v in bits.items() if k != "exact")
        assert round((exact // 8) / (compressed // 8), 1) == {"cifar": 18.1, "imdb": 1.5, "imdb_wide": 9.2}[task]
    assert got["cifar"] == {"exact": 22_446_944, "powersgd_r4": 1_243_104}
    assert got["imdb_wide"] == {"exact": 27_918_432, "powersgd_r16": 3_047_648}


# ---- the cut end-to-end run ---------------------------------------------------------------


def test_cut_cifar_run_gives_a_well_formed_record_and_cuda_is_refused(scripts, monkeypatch, tmp_path):
    """512 images, one epoch, both arms at world 1 on the CPU: the JAX
    record's keys and the port's provenance; ``--device cuda`` raises where
    there is no card. No ``artifacts/`` file is touched."""
    port, _ = scripts
    artifacts = [os.path.join(REPO, "artifacts", f) for f in ("ACCURACY_STUDY.json", "TORCH_ACCURACY_STUDY.json")]
    before = [os.path.getmtime(p) if os.path.exists(p) else None for p in artifacts]
    dev = torch.device("cpu")
    monkeypatch.setattr(port, "CIFAR_N", 512)
    with process_group(ExperimentConfig(), dev) as group:
        rec = port.cifar_study(1, 1, device=dev, group=group)
    jax_keys = {"task", "model", "workers", "global_batch", "lr", "hardness", "arms", "accuracy_delta_pts",
                "gradient_bytes_ratio"}
    assert jax_keys <= set(rec) and rec["workers"] == 1 and rec["departure"] == port.BN_WORLD_DEPARTURE
    assert set(rec["arms"]) == {"exact", "powersgd_r4"} and rec["gradient_bytes_ratio"] == 18.1
    for arm in rec["arms"].values():
        assert arm["epochs_run"] == 1 and arm["total_steps"] == 1 and len(arm["eval_accuracy_curve"]) == 1
        assert 0.0 <= arm["best_accuracy"] <= 1.0 and arm["wall_s"] >= 0
        assert set(arm["kernel_launches"].values()) == {0}  # the plain versions on the CPU
    assert rec["arms"]["exact"]["bits_per_step"] == 22_446_944
    # the merge-write and the slim line
    port._save({"cifar": rec})
    assert json.load(open(port.OUT))["cifar"]["arms"]["powersgd_r4"]["bits_per_step"] == 1_243_104
    assert set(port._line(rec)) == {"accuracy_delta_pts", "gradient_bytes_ratio", "exact_best", "compressed_best"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.main(["--task", "cifar", "--device", "cuda", "--out", str(tmp_path / "cuda.json")])
        assert not (tmp_path / "cuda.json").exists()
    assert [os.path.getmtime(p) if os.path.exists(p) else None for p in artifacts] == before
