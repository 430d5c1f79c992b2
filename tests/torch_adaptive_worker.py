"""Rank functions for the port's adaptive-communication and geo-resilience
tests: the fence hooks, the deadline guard over Gloo ranks, the adaptive
loop and the hierarchical round.

Imports torch and the port, never jax, so a spawned rank starts quickly;
each function runs on every rank of a :func:`torch_worker.spawn` (through
``torch_worker.run_all``) and returns plain values.
"""

from __future__ import annotations

import numpy as np
import torch

from network_distributed_pytorch_tpu_torch.experiments.common import adaptive_train_loop, image_classifier_loss
from network_distributed_pytorch_tpu_torch.models.cnn import SmallCNN
from network_distributed_pytorch_tpu_torch.models.import_weights import powersgd_state_from_jax
from network_distributed_pytorch_tpu_torch.models.resnet import resnet18
from network_distributed_pytorch_tpu_torch.parallel import comm
from network_distributed_pytorch_tpu_torch.parallel.hierarchical import (
    make_hierarchical_groups,
    make_hierarchical_train_fn,
)
from network_distributed_pytorch_tpu_torch.parallel.reducers import ExactReducer, PowerSGDReducer, PowerSGDState
from network_distributed_pytorch_tpu_torch.parallel.trainer import make_train_step
from network_distributed_pytorch_tpu_torch.resilience import (
    ChaosPlan,
    CommFaultInjector,
    FallbackController,
    FaultSpec,
    Rung,
)
from torch_worker import mse_loss, plain_records, shard


class Events:
    """A telemetry double that keeps ``(kind or event, record)`` pairs."""

    def __init__(self):
        self.seen = []

    def emit(self, ev):
        rec = ev.record()
        self.seen.append((rec.get("kind") or rec.get("event"), rec))

    def close(self):
        pass


class ScriptedController(FallbackController):
    """A controller whose moves are fixed by epoch (``{epoch: +1 or -1}``),
    whatever the health says; the healths it was given are kept."""

    def __init__(self, moves, **kw):
        super().__init__(**kw)
        self.moves = dict(moves)
        self.healths = []

    def observe(self, health):
        self.healths.append(health)
        delta = self.moves.get(health.epoch)
        return None if delta is None else self._move(delta, f"scripted:{delta}", health.epoch)


# ---- the fence hooks ---------------------------------------------------------------


def fence_hooks_rank(rank, world, group, flat, k, sends):
    """``chunked_all_reduce_mean`` of ``flat`` as ``k`` chunks with no hook
    and with a recording hook; then the exact reducer (bucketed) and
    PowerSGD under the recording hook: the infos each saw, as tuples."""
    seen = []

    def hook(info):
        seen.append((info["tag"], info["chunk"], info["n_chunks"], info["payload_bytes"], info["phase"],
                     info["device_index"]))

    plain = comm.chunked_all_reduce_mean(flat.clone(), group, k, tag="t")
    syncs = comm.fence_syncs()
    comm.add_fence_hook(hook)
    try:
        hooked = comm.chunked_all_reduce_mean(flat.clone(), group, k, tag="t")
        chunked = list(seen)
        seen.clear()
        sends = [s.clone() for s in sends[rank]]
        exact = ExactReducer(bucket_bytes=64, comm_chunks=2)
        exact.reduce({}, sends, group)
        exact_tags = list(seen)
        seen.clear()
        psgd = PowerSGDReducer(random_seed=3, compression_rank=2)
        psgd.reduce(psgd.init(sends), sends, group)
        psgd_tags = list(seen)
    finally:
        comm.remove_fence_hook(hook)
    return {
        "plain": plain, "hooked": hooked, "chunked": chunked, "exact": exact_tags, "powersgd": psgd_tags,
        "syncs": comm.fence_syncs() - syncs, "active_after": comm.fence_hooks_active(),
    }


# ---- the deadline guard over two ranks -----------------------------------------


def _cnn_batches(epoch, steps=4, batch=8, hw=8):
    rng = np.random.RandomState(100 + epoch)
    for _ in range(steps):
        yield (rng.randn(batch, hw, hw, 3).astype(np.float32), rng.randint(0, 10, size=batch).astype(np.int32))


def stall_world_rank(rank, world, group, stall_s, floor_s):
    """The adaptive loop of a SmallCNN on one rung, clean (a 30 s floor) and
    with a ``comm_stall`` of ``stall_s`` on rank 1 only at step 2 (deadline
    floor ``floor_s``, slack 1): each run's final parameters and the kinds
    of its events."""
    out = {}
    for name, faults, floor in (("clean", [], 30.0), ("stalled", [FaultSpec(kind="comm_stall", step=2, rank=1,
                                payload={"stall_seconds": stall_s})], floor_s)):
        model = SmallCNN(width=4, image_size=8, device="cpu", seed=5)

        def factory(overrides, model=model):
            return make_train_step(image_classifier_loss(), ExactReducer(), model, 0.05, 0.9, "ef_momentum", group)

        events = Events()
        injector = CommFaultInjector(ChaosPlan(faults), rank=rank, telemetry=events) if faults else None
        controller = FallbackController(ladder=[Rung("exact", {})], telemetry=events)
        with comm.record_collectives() as records:
            state, logger, _ = adaptive_train_loop(
                factory, _cnn_batches, 2, controller, torch.device("cpu"), injector=injector, telemetry=events,
                rank=rank, world_size=world, deadline_floor_s=floor, deadline_slack=1.0, run_name=name,
            )
        out[name] = {
            "params": {k: v.detach().clone() for k, v in state.params.items()},
            "kinds": [k for k, _ in events.seen],
            "steps": len(logger.records),
            "records": plain_records(records),
        }
    return out


# ---- the adaptive loop against the JAX loop ---------------------------------------


def adaptive_parity_rank(rank, world, group, sd, flax_params, q_by_rung, ladder, moves, batches, lr):
    """The adaptive loop of the small ResNet-18 from ``sd`` with a scripted
    controller over ``ladder`` (names and overrides), PowerSGD rungs under
    ``matricize="last"`` from the JAX reducer's Q (``q_by_rung``). Returns
    the final state, the losses, the decisions and what each rebuild
    carried."""
    model = resnet18(num_classes=10, norm="batch", stem="cifar", width=16, device="cpu")
    model.load_state_dict(sd)
    names = [n for n, _ in ladder]

    def factory(overrides):
        if overrides.get("reducer") == "powersgd":
            reducer = PowerSGDReducer(
                random_seed=7, compression_rank=overrides["reducer_rank"], matricize="last",
                comm_chunks=overrides.get("comm_chunks"),
            )
        else:
            reducer = ExactReducer(comm_chunks=overrides.get("comm_chunks"))
        step = make_train_step(image_classifier_loss(), reducer, model, lr, 0.9, "ef_momentum", group)
        rung = names[[r.overrides for r in controller.ladder].index(overrides)]
        init = step.init_state

        def init_state():
            st = init()
            if rung in q_by_rung:
                q = powersgd_state_from_jax(q_by_rung[rung], flax_params, reducer, model)
                st.reducer_state = PowerSGDState(q.q_memory, st.reducer_state.generator)
            built.append(st)
            return st

        step.init_state = init_state
        return step

    built = []  # every state a step's init_state gave the loop, in order
    carried = []

    class Carrying(ScriptedController):
        """Checks the carry where the loop reports a rebuild: the state the
        new step began with against the one the old step left."""

        def record(self, decision, **kw):
            old, new = built[-2], built[-1]
            carried.append({
                "params_same": all(new.params[k] is old.params[k] for k in old.params),
                "momenta_same": all(new.momenta[k] is old.momenta[k] for k in old.momenta),
                "memories_zero": all(not bool(m.any()) for m in new.memories.values()),
            })
            return super().record(decision, **kw)

    controller = Carrying(moves, ladder=[Rung(n, o) for n, o in ladder])
    epochs = len(batches)
    state, logger, controller = adaptive_train_loop(
        factory, lambda e: iter(batches[e]), epochs, controller, torch.device("cpu"), rank=rank,
        world_size=world, fabric="10GbE", deadline_floor_s=30.0,
    )
    return {
        "params": {k: v.detach().clone() for k, v in state.params.items()},
        "momenta": {k: v.detach().clone() for k, v in state.momenta.items()},
        "buffers": {k: v.detach().clone() for k, v in model.named_buffers()},
        "losses": [r.loss for r in logger.records],
        "decisions": [(d.action, d.rung_before, d.rung_after, d.epoch) for d in controller.decisions],
        "carried": carried, "rung": controller.rung.name,
    }


# ---- the agreed alert nudge ----------------------------------------------------------


class LaggingFeed:
    """An ``AlertFeed`` that hands each poll's records out one poll late: a
    rank that reads the file after its peer has."""

    def __init__(self, feed):
        self.feed, self.held = feed, []

    def poll(self):
        out, self.held = self.held, self.feed.poll()
        return out


def alert_nudge_rank(rank, world, group, run_dir, alert_before_step, lag_rank):
    """The adaptive loop of the small ResNet-18 over a baseline and a
    PowerSGD rung, reading the run's ``alerts.jsonl``: rank 0 appends a
    ``step_time_drift`` alert just before its step ``alert_before_step``
    (between two steps), and rank ``lag_rank`` reads the file one poll
    late. Returns the step at which each rebuild happened, the decisions,
    the final parameters and the agreement's collectives."""
    from network_distributed_pytorch_tpu_torch.observe.live import AlertFeed, append_alert

    model = resnet18(num_classes=10, norm="batch", stem="cifar", width=16, device="cpu", seed=3)
    steps_run = [0]
    rebuilt_at = []

    def factory(overrides):
        rebuilt_at.append(steps_run[0])
        if overrides.get("reducer") == "powersgd":
            reducer = PowerSGDReducer(random_seed=7, compression_rank=overrides["reducer_rank"])
        else:
            reducer = ExactReducer()
        return make_train_step(image_classifier_loss(), reducer, model, 0.01, 0.9, "ef_momentum", group)

    def batches(epoch):
        for i, b in enumerate(_cnn_batches(epoch, steps=4, batch=8, hw=16)):
            gstep = 4 * epoch + i
            if rank == 0 and gstep == alert_before_step:
                append_alert(run_dir, {"event": "alert", "alert": "step_time_drift", "severity": "warn",
                                       "rank": 0, "step": gstep})
            if gstep > 0:
                steps_run[0] = gstep
            yield b

    feed = AlertFeed(run_dir)
    controller = FallbackController(
        ladder=[Rung("baseline", {}), Rung("compress", {"reducer": "powersgd", "reducer_rank": 1})]
    )
    with comm.record_collectives() as records:
        state, logger, controller = adaptive_train_loop(
            factory, batches, 2, controller, torch.device("cpu"), rank=rank, world_size=world,
            alert_feed=LaggingFeed(feed) if rank == lag_rank else feed, deadline_floor_s=30.0,
        )
    return {
        "rebuilt_at": rebuilt_at,
        "decisions": [(d.action, d.trigger, d.epoch, d.rung_after) for d in controller.decisions],
        "params": {k: v.detach().clone() for k, v in state.params.items()},
        "steps": len(logger.records),
        "nudge_agreements": sum(1 for r in records if r.kind == "alert-nudge"),
    }


# ---- the hierarchical round on a 2 x 2 grid ----------------------------------------


class LinRegT(torch.nn.Module):
    """``x @ w.T + b`` from zeros, ``w`` in torch's ``(out, in)`` layout, so
    that the port's PowerSGD views it as the JAX package's ``(in, out)``
    kernel and the JAX reducer's Q carries over."""

    def __init__(self, n_in=16, n_out=4):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(n_out, n_in))
        self.b = torch.nn.Parameter(torch.zeros(n_out))

    def forward(self, x):
        return x @ self.w.t() + self.b


def _round_batches(batches, rank, world):
    return [shard(b, rank, world) for b in batches]


def geo_rank(rank, world, group, rounds, cases, q_port):
    """Each case of ``cases`` (``name -> (kwargs, plan)``, ``plan`` a list of
    "sync" / "local", ``kwargs`` with ``outer`` "exact" or a PowerSGD rank;
    ``inner_algorithm="optax"`` is torch SGD at 0.05) run on a fresh
    ``LinRegT`` over this rank's slice of ``rounds``: after
    every round the parameters, the site losses and the collectives by
    group; and the round's bits."""
    groups = make_hierarchical_groups(2, group)
    inner_ranks = tuple(torch.distributed.get_process_group_ranks(groups[0]))
    outer_ranks = tuple(torch.distributed.get_process_group_ranks(groups[1]))
    out = {"inner_ranks": inner_ranks, "outer_ranks": outer_ranks}
    for name, (kwargs, plan) in cases.items():
        kwargs = dict(kwargs)
        outer = kwargs.pop("outer")
        reducer = ExactReducer() if outer == "exact" else PowerSGDReducer(
            random_seed=1, compression_rank=outer, matricize="last"
        )
        model = LinRegT()
        if kwargs.get("inner_algorithm") == "optax":
            kwargs["inner_optimizer"] = lambda ps: torch.optim.SGD(ps, lr=0.05)
        fn = make_hierarchical_train_fn(mse_loss, model, outer_reducer=reducer, groups=groups, group=group, **kwargs)
        state = fn.init_state()
        if outer != "exact":
            state.reducer_state = PowerSGDState(q_port[outer].clone(), state.reducer_state.generator)
        per_round = []
        for kind, batches in zip(plan, rounds):
            with comm.record_collectives() as records:
                state, losses = fn(state, _round_batches(batches, rank, world), local=kind == "local")
            per_round.append({
                "w": state.params["w"].detach().clone(), "b": state.params["b"].detach().clone(),
                "losses": losses.clone(), "records": plain_records(records),
            })
        out[name] = {
            "rounds": per_round,
            "eval_w": fn.eval_params(state)["w"],
            "bits": {
                "round": fn.bits_per_round, "local": fn.local_bits_per_round, "inner": fn.inner_bits_per_round,
                "outer": fn.outer_bits_per_round, "ledger": fn.ledger.by_tag(),
            },
        }
    return out
