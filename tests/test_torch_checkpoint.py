"""The port's checkpoint layer on one process, as the JAX package's tests
hold its own (``test_checkpoint.py``, ``test_chaos.py``):

- the commit protocol: a torn tmp directory (``_abort_before_commit``) is
  never resumed; a flipped payload byte falls back to the previous step
  with one ``checkpoint_fallback`` event; ``keep_last`` removes the right
  directories and foreign tmp directories; a root that refuses the write
  raises ``CheckpointUnwritableError`` (and the loop exits with 44); a
  restore at another world without a resharder raises
  ``TopologyMismatchError``; a template that does not fit is left
  untouched;
- round trips bit for bit: a ``TrainState`` under each update rule
  (``ef_momentum`` with PowerSGD's Q, ``sgd``, ``"optax"`` with AdamW's
  state) and DiLoCo's state (reference
  ``test_checkpoint.py::test_diloco_checkpoint_resume_bitexact``), the
  restore writing into the model's own tensors;
- the entry points: ``exact_cifar10 --checkpoint-dir`` through the
  launcher resumes at epoch 1, a preempted run exits with 75 and resumes
  past its step, and ``serve_gpt.run(checkpoint_dir=...)`` serves the
  trained parameters bit for bit and reports ``checkpoint_step``;
- the sharded restore (reference ``test_checkpoint.py:147-216``) on two
  Gloo ranks: an FSDP state (``sgd`` and AdamW) saved by both and restored
  by ``restore_checkpoint_sharded`` and ``restore_latest(sharded=True)``
  bit for bit, the next step from it bitwise the uninterrupted one's; a
  restore at a world of one refused, by the topology record and, on an
  untagged checkpoint, by the count of rank files; a template with
  replicated fields refused.
"""

import json
import os

import pytest
import torch

from network_distributed_pytorch_tpu_torch import launch, resilience
from network_distributed_pytorch_tpu_torch.experiments import exact_cifar10, gpt_lm, serve_gpt
from network_distributed_pytorch_tpu_torch.experiments.common import image_classifier_loss, resilient_train_loop
from network_distributed_pytorch_tpu_torch.models.cnn import SmallCNN
from network_distributed_pytorch_tpu_torch.parallel.localsgd import (
    make_diloco_train_fn,
    make_streaming_diloco_train_fn,
)
from network_distributed_pytorch_tpu_torch.parallel.reducers import ExactReducer, PowerSGDReducer, embedding_leaves
from network_distributed_pytorch_tpu_torch.parallel.trainer import make_train_step
from network_distributed_pytorch_tpu_torch.resilience import (
    CKPT_UNWRITABLE_EXIT_CODE,
    PREEMPT_EXIT_CODE,
    CheckpointUnwritableError,
    make_topology,
)
from network_distributed_pytorch_tpu_torch.serving.cache import restore_serving_params
from network_distributed_pytorch_tpu_torch.utils.checkpoint import (
    COMMITTED_MARKER,
    REPLICATED_FILE,
    TopologyMismatchError,
    committed_step_paths,
    gc_checkpoints,
    latest_step_path,
    read_loader_state,
    restore_checkpoint,
    restore_checkpoint_sharded,
    restore_latest,
    save_checkpoint,
    verify_checkpoint,
)
from network_distributed_pytorch_tpu_torch.utils.config import ExperimentConfig
from torch_worker import (  # few_torch_threads: autouse
    Events,
    LinReg,
    few_torch_threads,
    fsdp_checkpoint_rank,
    mse_loss,
    numpy_batches,
    regression_problem,
    resume_batches,
    spawn,
)

CPU = torch.device("cpu")


def _setup(algorithm="ef_momentum", seed=0):
    """A SmallCNN (width 4, 8x8 images) and its step under ``algorithm``."""
    model = SmallCNN(width=4, image_size=8, device="cpu", seed=seed)
    kw = {}
    if algorithm == "ef_momentum":
        reducer = PowerSGDReducer(random_seed=7, compression_rank=2, matricize="last")
    else:
        reducer = ExactReducer()
    if algorithm == "optax":
        kw["optimizer"] = lambda ps: torch.optim.AdamW(ps, lr=1e-3)
    step = make_train_step(image_classifier_loss(), reducer, model, 0.05, 0.9, algorithm, **kw)
    return model, step, step.init_state()


def _train(step, state, epoch, steps=2):
    for x, y in resume_batches(epoch, steps=steps):
        state, _ = step(state, (torch.from_numpy(x), torch.from_numpy(y)))
    return state


def _tensors(state):
    """Every tensor of a state by a path, cloned (an optimizer's too)."""
    out = {}

    def walk(x, path):
        if isinstance(x, torch.Tensor):
            out[path] = x.detach().clone()
        elif isinstance(x, torch.optim.Optimizer):
            walk(x.state_dict()["state"], path + ".opt")
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}.{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")
        elif hasattr(x, "__dataclass_fields__"):
            for k in x.__dataclass_fields__:
                walk(getattr(x, k), f"{path}.{k}")

    walk(state, "state")
    return out


def _assert_bitwise(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("algorithm", ["ef_momentum", "sgd", "optax"])
def test_train_state_round_trip_bit_for_bit(tmp_path, algorithm):
    """Save after two steps, take two more; a fresh model from other weights
    restored from the save takes the same two and lands on the same bits.
    The restore writes into the model's own parameters."""
    model, step, state = _setup(algorithm)
    state = _train(step, state, 0)
    path = save_checkpoint(str(tmp_path), state, step=0)
    want = _tensors(_train(step, state, 1))

    model2, step2, fresh = _setup(algorithm, seed=5)
    params_dict = fresh.params
    restored = restore_checkpoint(path, fresh)
    assert restored is fresh and restored.params is params_dict
    assert all(p is q for p, q in zip(params_dict.values(), model2.parameters()))
    got = _tensors(_train(step2, restored, 1))
    _assert_bitwise(got, want)


@pytest.mark.parametrize("make_fn", [make_diloco_train_fn, make_streaming_diloco_train_fn], ids=["diloco", "streaming"])
def test_diloco_state_round_trip_bit_for_bit(tmp_path, make_fn):
    """DiLoCo's whole carry (params, outer momenta, inner momenta, EF
    memories, PowerSGD's Q; streaming DiLoCo's anchors, per-fragment Qs
    and phase too) survives the round trip: the resumed rounds are
    bit-identical."""
    x, y = regression_problem(seed=0)
    batches = [(torch.from_numpy(x), torch.from_numpy(y))] * 4

    def make():
        reducer = PowerSGDReducer(random_seed=7, compression_rank=2, matricize="last")
        rnd = make_fn(mse_loss, LinReg(), inner_learning_rate=0.05, sync_every=4, reducer=reducer)
        return rnd, rnd.init_state()

    rnd, state = make()
    for _ in range(2):
        state, _ = rnd(state, batches)
    path = save_checkpoint(str(tmp_path), state, step=2)
    for _ in range(2):
        state, _ = rnd(state, batches)
    fresh_rnd, fresh = make()
    resumed = restore_checkpoint(path, fresh)
    for _ in range(2):
        resumed, _ = fresh_rnd(resumed, batches)
    want, got = _tensors(state), _tensors(resumed)
    assert any(".memories." in k for k in want) and any(k.endswith("[0]") for k in want)  # Q
    assert getattr(resumed, "phase", 4) == getattr(state, "phase", 4) == 4
    _assert_bitwise(got, want)


def _two_saves(root):
    model, step, state = _setup()
    state = _train(step, state, 0)
    first = _tensors(state)
    save_checkpoint(str(root), state, step=0)
    state = _train(step, state, 1)
    return step, state, first


def test_torn_tmp_directory_is_never_resumed(tmp_path):
    step, state, first = _two_saves(tmp_path)
    torn = save_checkpoint(str(tmp_path), state, step=1, _abort_before_commit=True)
    assert os.path.basename(torn).startswith("_tmp.step_1.") and os.path.isdir(torn)
    assert not os.path.exists(os.path.join(torn, COMMITTED_MARKER))
    assert latest_step_path(str(tmp_path)) == str(tmp_path / "step_0")
    assert [s for s, _ in committed_step_paths(str(tmp_path))] == [0]
    events = Events()
    restored, step_no = restore_latest(str(tmp_path), _setup(seed=3)[2], telemetry=events)
    assert step_no == 0 and events.seen == []
    _assert_bitwise(_tensors(restored), first)


def test_bit_flip_falls_back_with_one_event(tmp_path):
    step, state, first = _two_saves(tmp_path)
    save_checkpoint(str(tmp_path), state, step=1)
    payload = tmp_path / "step_1" / REPLICATED_FILE
    data = bytearray(payload.read_bytes())
    data[len(data) // 2] ^= 0x10
    payload.write_bytes(bytes(data))
    ok, reason = verify_checkpoint(str(tmp_path / "step_1"))
    assert not ok and "checksum mismatch" in reason
    assert verify_checkpoint(str(tmp_path / "step_0")) == (True, "ok")
    events = Events()
    fresh = _setup(seed=3)[2]
    restored, step_no = restore_latest(str(tmp_path), fresh, telemetry=events)
    assert step_no == 0 and events.seen == [("checkpoint_fallback", 1)]
    _assert_bitwise(_tensors(restored), first)


def test_verify_checks_marker_manifest_and_extra_files(tmp_path):
    _, _, state = _setup()
    path = save_checkpoint(str(tmp_path), state, step=0)
    assert verify_checkpoint(path) == (True, "ok")
    for share in ((0, 2), (1, 2)):
        assert verify_checkpoint(path, share=share) == (True, "ok")
    (tmp_path / "step_0" / "stray.pt").write_bytes(b"x")
    assert not verify_checkpoint(path)[0]
    os.remove(tmp_path / "step_0" / "stray.pt")
    os.remove(tmp_path / "step_0" / COMMITTED_MARKER)
    assert verify_checkpoint(path) == (False, "uncommitted (no _COMMITTED marker)")
    assert latest_step_path(str(tmp_path)) is None and restore_latest(str(tmp_path), state) is None


def test_keep_last_removes_the_right_directories(tmp_path):
    _, _, state = _setup()
    os.makedirs(tmp_path / "_tmp.step_9.1")  # another process's abandoned write
    for s in range(5):
        save_checkpoint(str(tmp_path), state, step=s, keep_last=2)
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4"]
    assert gc_checkpoints(str(tmp_path), 1) == [str(tmp_path / "step_3")]
    with pytest.raises(ValueError):
        gc_checkpoints(str(tmp_path), 0)


def test_unwritable_root_raises_the_typed_error(tmp_path):
    """A parent path that is a file (ENOTDIR) refuses the write even for
    root, where permission bits do not."""
    blocker = tmp_path / "ckroot"
    blocker.write_text("not a directory")
    _, step, state = _setup()
    with pytest.raises(CheckpointUnwritableError, match="unwritable"):
        save_checkpoint(str(blocker / "ck"), state, step=0)
    assert issubclass(CheckpointUnwritableError, OSError) and not issubclass(CheckpointUnwritableError, RuntimeError)
    events = Events()
    with pytest.raises(SystemExit) as exit_info:
        resilient_train_loop(step, state, resume_batches, 1, str(blocker / "ck"), CPU, telemetry=events)
    assert exit_info.value.code == CKPT_UNWRITABLE_EXIT_CODE == 44
    assert events.seen == [("checkpoint_unwritable", 0)]


def test_restore_at_another_world_raises_without_a_resharder(tmp_path):
    _, _, state = _setup()
    save_checkpoint(str(tmp_path), state, step=0, topology=make_topology(2))
    with pytest.raises(TopologyMismatchError):
        restore_checkpoint(str(tmp_path / "step_0"), _setup()[2])
    with pytest.raises(TopologyMismatchError):
        restore_latest(str(tmp_path), _setup()[2])
    # the replicated fields alone do not depend on the world
    params = dict(_setup(seed=4)[0].named_parameters())
    assert restore_serving_params(str(tmp_path), params)[1] == 0


def test_a_template_that_does_not_fit_is_left_untouched(tmp_path):
    _, _, state = _setup()
    save_checkpoint(str(tmp_path), state, step=0)
    model = SmallCNN(width=8, image_size=8, device="cpu", seed=1)
    step = make_train_step(image_classifier_loss(), ExactReducer(), model, 0.05, 0.9, "ef_momentum")
    other = step.init_state()
    before = _tensors(other)
    events = Events()
    assert restore_latest(str(tmp_path), other, telemetry=events) is None
    assert events.seen == [("checkpoint_fallback", 0)]
    _assert_bitwise(_tensors(other), before)


def test_loop_commits_the_loader_state_and_topology(tmp_path):
    _, step, state = _setup()
    resilient_train_loop(
        step, state, resume_batches, 2, str(tmp_path), CPU, keep_last=1, topology=make_topology(1, global_batch=16),
        loader_state_fn=lambda epoch, done: {"epoch": epoch, "batches_done": done},
    )
    assert os.listdir(tmp_path) == ["step_1"]
    assert read_loader_state(str(tmp_path / "step_1")) == {"epoch": 2, "batches_done": 0}
    with open(tmp_path / "step_1" / "_TOPOLOGY.json") as f:
        assert json.load(f)["global_batch"] == 16


def test_launch_exact_cifar10_resumes_from_its_checkpoint(tmp_path, capsys):
    args = ["exact_cifar10", "--device", "cpu", "--global-batch", "16", "--max-steps-per-epoch", "2",
            "--checkpoint-dir", str(tmp_path)]
    first = launch.main(args + ["--epochs", "1"])
    second = launch.main(args + ["--epochs", "2"])
    assert (first["start_epoch"], second["start_epoch"]) == (0, 1) and first["steps"] == second["steps"] == 2
    assert first["bits_per_step"] == second["bits_per_step"]
    assert sorted(os.listdir(tmp_path)) == ["step_0", "step_1"]
    assert '"kind": "resumed"' in capsys.readouterr().err


class _RequestAfterEachStep:
    """A training step that raises the newest guard's flag after it runs,
    as a SIGTERM during the step would."""

    def __init__(self, step, guards):
        self.step, self.guards = step, guards

    def __getattr__(self, name):
        return getattr(self.step, name)

    def __call__(self, state, batch):
        out = self.step(state, batch)
        if not self.guards[-1].requested:
            self.guards[-1].request()
        return out


def test_exact_cifar10_preemption_exits_75_and_resumes_past_its_step(tmp_path, monkeypatch):
    guards = []

    class Recorded(resilience.PreemptionGuard):
        def install(self):
            guards.append(self)
            return super().install()

    build = exact_cifar10.build

    def preempting_build(*args, **kwargs):
        model, step, state = build(*args, **kwargs)
        return model, _RequestAfterEachStep(step, guards), state

    cfg = ExperimentConfig(training_epochs=2, global_batch_size=16, learning_rate=0.001)
    monkeypatch.setattr(resilience, "PreemptionGuard", Recorded)
    monkeypatch.setattr(exact_cifar10, "build", preempting_build)
    with pytest.raises(SystemExit) as exit_info:
        exact_cifar10.run(cfg, device="cpu", max_steps_per_epoch=2, checkpoint_dir=str(tmp_path))
    assert exit_info.value.code == PREEMPT_EXIT_CODE == 75 and guards[-1].checkpoint_saved
    with open(tmp_path / "step_0" / "_TOPOLOGY.json") as f:
        assert json.load(f)["epoch_cursor"] == {"epoch": 0, "batches_done": 1}
    monkeypatch.setattr(exact_cifar10, "build", build)
    out = exact_cifar10.run(cfg, device="cpu", max_steps_per_epoch=2, checkpoint_dir=str(tmp_path))
    assert out["start_epoch"] == 0 and out["steps"] == 3  # the rest of epoch 0, then epoch 1


MAX_NEW = 6


def _train_serving_shaped_gpt(root, epochs=2):
    """gpt_tiny at serve_gpt's small shape (vocabulary 64, max_len 12 +
    MAX_NEW positions) trained through resilient_train_loop, one step an
    epoch: its parameters."""
    max_len = serve_gpt.serving_max_len("small", MAX_NEW, "slot", 16)
    model = serve_gpt.build_model("small", max_len, torch.float32, "cpu", seed=714).train()
    reducer = PowerSGDReducer(random_seed=714, compression_rank=2, matricize="last", features_last=embedding_leaves(model))
    step = make_train_step(gpt_lm.lm_loss(), reducer, model, 0.1, 0.9, "ef_momentum")
    state, _, _ = resilient_train_loop(
        step, step.init_state(), lambda e: gpt_lm.synthetic_lm_batches(64, 4, 12, 1, 100 + e), epochs, str(root), CPU,
    )
    return {k: v.detach().clone() for k, v in state.params.items()}


def test_serve_gpt_hot_loads_the_trained_params(tmp_path, monkeypatch):
    trained = _train_serving_shaped_gpt(tmp_path)
    built = []
    build_model = serve_gpt.build_model
    monkeypatch.setattr(serve_gpt, "build_model", lambda *a, **k: built.append(build_model(*a, **k)) or built[-1])
    out = serve_gpt.run(
        preset="small", checkpoint_dir=str(tmp_path), device="cpu", requests=3, request_rate=0.0,
        max_new_tokens=MAX_NEW,
    )
    assert out["checkpoint_step"] == 1 and out["slo"]["n_finished"] == 3
    served = dict(built[-1].named_parameters())
    assert set(served) == set(trained)
    for k, v in trained.items():
        assert torch.equal(served[k].detach(), v), k


def test_serve_gpt_without_a_checkpoint_serves_fresh_params(tmp_path, capsys):
    out = serve_gpt.run(
        preset="small", checkpoint_dir=str(tmp_path / "empty"), device="cpu", requests=2, request_rate=0.0,
        max_new_tokens=MAX_NEW,
    )
    assert out["checkpoint_step"] is None and out["slo"]["n_finished"] == 2
    assert "no restorable checkpoint" in capsys.readouterr().err


# ---- the sharded restore of an FSDP state, on two ranks --------------------------


@pytest.fixture(scope="module")
def fsdp_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("fsdp_ckpt")
    return spawn(fsdp_checkpoint_rank, 2, root, str(root), numpy_batches(60, 3, batch=8, hw=16))


@pytest.mark.parametrize("algorithm", ["sgd", "optax"])
def test_fsdp_state_restores_sharded_bit_for_bit(fsdp_ranks, algorithm):
    """Each rank's shards, momenta or AdamW moments and BN buffers come back
    bit for bit from its own file, by both restores, and the next step from
    the restored state is the uninterrupted run's."""
    for res in fsdp_ranks:
        got = res[algorithm]
        _assert_bitwise(got["restored"], got["saved"])
        _assert_bitwise(got["latest"], got["saved"])
        assert got["latest_step"] == 0
        assert got["losses"][0] == got["losses"][1]
        _assert_bitwise(got["resumed"], got["after"])
    # the ranks hold different shards: nothing was read from the other's file
    a, b = (res["sgd"]["saved"] for res in fsdp_ranks)
    assert any(not torch.equal(a[k], b[k]) for k in a if k.startswith("param_shards"))


def test_fsdp_restore_at_another_world_is_refused(fsdp_ranks):
    tagged, untagged = fsdp_ranks[0]["refused"]
    assert tagged is not None and "world size 2" in tagged
    assert untagged is not None and "2 rank files" in untagged


def test_sharded_restore_refuses_replicated_fields(tmp_path):
    _, _, state = _setup("sgd")
    save_checkpoint(str(tmp_path), state, step=0)
    with pytest.raises(ValueError, match="replicated"):
        restore_checkpoint_sharded(str(tmp_path / "step_0"), _setup("sgd")[2])
