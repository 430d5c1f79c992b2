"""Checkpoint and resume, with an atomic commit protocol: the JAX package's
``utils/checkpoint.py`` on torch tensors.

The whole training state is saved: parameters, momenta, every rank's
error-feedback memories and BatchNorm buffers, the PowerSGD warm-start Q
(and its generator), a ``torch.optim`` optimizer's ``state_dict``, so a
resumed run continues the error-feedback chain bit for bit.

The port runs one process a rank, so a checkpoint is written by all of
them into one directory on a filesystem they share (one host):

- rank 0 writes the replicated fields (``replicated.pt``: the fields that
  are the same on every rank);
- each rank writes its own row (``rank_RRRRR.pt``: the fields of
  ``PER_RANK_FIELDS``, in the JAX package's terms row ``r`` of every
  per-worker leaf, as the topology record's ``shard_layout`` says).

Storage without a shared filesystem (several hosts) is out of scope. The
payload is ``torch.save`` of plain containers of CPU tensors, read back
with ``torch.load(..., weights_only=True)``; it does not read the JAX
package's orbax directories.

Commit protocol (what makes a crash mid-save survivable):

1. the files go into a sibling ``_tmp.<name>.<pid>`` directory (rank 0's
   pid, the same name on every rank); the ranks agree that every write
   landed;
2. rank 0 writes the ``_TOPOLOGY.json`` and ``_LOADER_STATE.json``
   records and a ``_CHECKSUMS.json`` manifest (the sha256 of every
   payload file);
3. rank 0 writes the ``_COMMITTED`` marker LAST;
4. one atomic ``os.replace`` renames the directory to ``step_N``, and the
   ranks agree that it did.

A crash at any point leaves either no ``step_N`` (only an ignorable tmp
directory) or a committed one. Readers trust only directories that carry
the marker (:func:`latest_step_path`), and :func:`restore_latest` also
verifies the manifest, falling back to the previous committed step with
a ``checkpoint_fallback`` :class:`..observe.FailureEvent` rather than
resume from a torn or bit-flipped directory.

A restore writes INTO the template's tensors (``copy_`` under
``no_grad``), never rebinding them: the trainer's ``params`` are the
model's own ``Parameter`` tensors and ``model_state`` its buffers, so the
model, the reducer and any optimizer see the restored values.
"""

from __future__ import annotations

import dataclasses
import errno
import hashlib
import json
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..parallel.comm import agree

COMMITTED_MARKER = "_COMMITTED"
CHECKSUM_MANIFEST = "_CHECKSUMS.json"
TOPOLOGY_RECORD = "_TOPOLOGY.json"
LOADER_STATE_RECORD = "_LOADER_STATE.json"
REPLICATED_FILE = "replicated.pt"
_TMP_PREFIX = "_tmp."
# files the protocol adds on top of the payload: outside the manifest
_PROTOCOL_FILES = {COMMITTED_MARKER, CHECKSUM_MANIFEST, TOPOLOGY_RECORD, LOADER_STATE_RECORD}
# the state fields each rank holds its own of (a state class may name its
# own in a ``PER_RANK_FIELDS`` class attribute); every other field is the
# same on every rank and rank 0 writes it
PER_RANK_FIELDS = ("memories", "model_state", "inner_opt")
# errors of a directory that refuses the write itself
_UNWRITABLE_ERRNOS = (errno.EACCES, errno.EPERM, errno.EROFS, errno.ENOTDIR, errno.EISDIR, errno.EEXIST)


class TopologyMismatchError(ValueError):
    """The checkpoint was written at another world size than the one
    restoring it. A plain restore would hand each rank another rank's row;
    route it through ``resilience.reshard.reshard_from_checkpoint`` (or
    give :func:`restore_latest` a ``resharder``) instead."""


def rank_file(rank: int) -> str:
    """The name of rank ``rank``'s payload file."""
    return f"rank_{rank:05d}.pt"


def rank_and_world(group) -> Tuple[int, int]:
    """This process's rank in ``group`` and its size (``None``: 0 and 1)."""
    if group is None:
        return 0, 1
    import torch.distributed as dist

    return dist.get_rank(group), dist.get_world_size(group)


# ---- the payload: a state as plain containers of CPU tensors -----------------


def per_rank_fields(state: Any) -> Tuple[str, ...]:
    """The fields of ``state`` that each rank holds its own of."""
    return tuple(getattr(type(state), "PER_RANK_FIELDS", PER_RANK_FIELDS))


def state_fields(state: Any) -> List[str]:
    """The top-level fields of a state: a dataclass's, a NamedTuple's or a
    dict's keys."""
    if dataclasses.is_dataclass(state) and not isinstance(state, type):
        return [f.name for f in dataclasses.fields(state)]
    if isinstance(state, tuple) and hasattr(type(state), "_fields"):
        return list(state._fields)
    if isinstance(state, dict):
        return list(state)
    raise TypeError(f"a checkpointed state is a dataclass, a NamedTuple or a dict, got {type(state).__name__}")


def _get(state: Any, name: str) -> Any:
    return state[name] if isinstance(state, dict) else getattr(state, name)


def _plain(x: Any) -> Any:
    """``x`` as containers ``torch.load(weights_only=True)`` reads back:
    tensors copied to the CPU (a view's copy holds only its own elements),
    generators and optimizers as their state."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, torch.Generator):
        return {"__generator__": x.get_state()}
    if isinstance(x, torch.optim.Optimizer):
        return {"__optimizer__": _plain(x.state_dict())}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):  # a NamedTuple too
        return [_plain(v) for v in x]
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def _assign(template: Any, saved: Any, where: str, dry: bool) -> Any:
    """Write ``saved`` into ``template`` (in place where the template is
    mutable) and return the restored value. ``dry=True`` only checks that
    the structure, shapes and dtypes agree, and writes nothing."""
    if isinstance(template, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise ValueError(f"{where}: checkpoint holds {type(saved).__name__}, the template a tensor")
        if saved.shape != template.shape or saved.dtype != template.dtype:
            raise ValueError(
                f"{where}: checkpoint {tuple(saved.shape)} {saved.dtype},"
                f" template {tuple(template.shape)} {template.dtype}"
            )
        if not dry:
            with torch.no_grad():
                template.copy_(saved)
        return template
    if isinstance(template, torch.Generator):
        if not (isinstance(saved, dict) and "__generator__" in saved):
            raise ValueError(f"{where}: checkpoint holds no generator state")
        if not dry:
            template.set_state(saved["__generator__"])
        return template
    if isinstance(template, torch.optim.Optimizer):
        if not (isinstance(saved, dict) and "__optimizer__" in saved):
            raise ValueError(f"{where}: checkpoint holds no optimizer state")
        if not dry:
            template.load_state_dict(saved["__optimizer__"])
        return template
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        for f in dataclasses.fields(template):
            if not isinstance(saved, dict) or f.name not in saved:
                raise ValueError(f"{where}: checkpoint lacks field {f.name!r}")
            value = _assign(getattr(template, f.name), saved[f.name], f"{where}.{f.name}", dry)
            if not dry:
                setattr(template, f.name, value)
        return template
    if isinstance(template, dict):
        if not isinstance(saved, dict) or set(saved) != set(template):
            raise ValueError(f"{where}: checkpoint keys differ from the template's")
        for k in template:
            value = _assign(template[k], saved[k], f"{where}[{k!r}]", dry)
            if not dry:
                template[k] = value
        return template
    if isinstance(template, (list, tuple)):
        if not isinstance(saved, list) or len(saved) != len(template):
            raise ValueError(f"{where}: checkpoint holds another sequence than the template")
        values = [_assign(t, s, f"{where}[{i}]", dry) for i, (t, s) in enumerate(zip(template, saved))]
        if isinstance(template, list):
            if not dry:
                template[:] = values
            return template
        return type(template)(*values) if hasattr(type(template), "_fields") else tuple(values)
    if template is not None and saved is not None and type(saved) is not type(template):
        raise ValueError(f"{where}: checkpoint holds {type(saved).__name__}, the template {type(template).__name__}")
    return saved


def _assign_fields(template: Any, saved: Dict[str, Any], names: Sequence[str], dry: bool) -> None:
    for name in names:
        if name not in saved:
            raise ValueError(f"checkpoint lacks field {name!r}")
        value = _assign(_get(template, name), saved[name], name, dry)
        if not dry:
            if isinstance(template, dict):
                template[name] = value
            else:
                setattr(template, name, value)


# ---- integrity ----------------------------------------------------------------


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


def _payload_files(root: str) -> List[str]:
    """Every regular file under ``root`` (relative paths), protocol files
    excluded."""
    out = []
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), root)
            if rel not in _PROTOCOL_FILES:
                out.append(rel)
    return sorted(out)


def write_manifest(path: str) -> Dict[str, str]:
    """Hash every payload file under ``path`` into ``_CHECKSUMS.json``."""
    sums = {rel: _sha256_file(os.path.join(path, rel)) for rel in _payload_files(path)}
    with open(os.path.join(path, CHECKSUM_MANIFEST), "w") as f:
        json.dump(sums, f)
    return sums


def is_committed(path: str) -> bool:
    return os.path.isfile(os.path.join(path, COMMITTED_MARKER))


def verify_checkpoint(path: str, share: Optional[Tuple[int, int]] = None) -> Tuple[bool, str]:
    """Integrity check: the committed marker and the manifest present,
    every manifest entry present with a matching sha256, no payload file
    missing from the manifest. Returns ``(ok, reason)``.

    ``share=(rank, world)`` hashes only every ``world``-th manifest entry
    from the ``rank``-th: the ranks split the hashing, and agree on the
    verdict."""
    if not os.path.isdir(path):
        return False, "missing directory"
    if not is_committed(path):
        return False, "uncommitted (no _COMMITTED marker)"
    manifest_path = os.path.join(path, CHECKSUM_MANIFEST)
    if not os.path.isfile(manifest_path):
        return False, "no checksum manifest"
    try:
        with open(manifest_path) as f:
            sums = json.load(f)
    except (OSError, ValueError) as e:
        return False, f"unreadable manifest: {e}"
    for i, (rel, want) in enumerate(sorted(sums.items())):
        full = os.path.join(path, rel)
        if not os.path.isfile(full):
            return False, f"missing file {rel}"
        if share is not None and i % share[1] != share[0]:
            continue
        if _sha256_file(full) != want:
            return False, f"checksum mismatch at {rel}"
    extra = set(_payload_files(path)) - set(sums)
    if extra:
        return False, f"unmanifested files: {sorted(extra)[:3]}"
    return True, "ok"


# ---- the topology and loader-state records ----------------------------------


def write_topology(path: str, topology: Dict[str, Any]) -> str:
    """Tag a checkpoint directory with its topology record
    (``resilience.reshard.make_topology``): a protocol file, outside the
    manifest."""
    full = os.path.join(path, TOPOLOGY_RECORD)
    with open(full, "w") as f:
        json.dump(topology, f, indent=2, sort_keys=True)
    return full


def read_topology(path: str) -> Optional[Dict[str, Any]]:
    """The topology record of a checkpoint directory, or None."""
    try:
        with open(os.path.join(path, TOPOLOGY_RECORD)) as f:
            topo = json.load(f)
    except (OSError, ValueError):
        return None
    return topo if isinstance(topo, dict) else None


def write_loader_state(path: str, state: Dict[str, Any]) -> str:
    """Tag a checkpoint directory with its data loader's state (a stream
    cursor), committed in the same atomic step as the checkpoint: samples
    count as consumed exactly when the checkpoint carrying their cursor
    commits."""
    full = os.path.join(path, LOADER_STATE_RECORD)
    with open(full, "w") as f:
        json.dump(state, f, indent=2, sort_keys=True)
    return full


def read_loader_state(path: str) -> Optional[Dict[str, Any]]:
    """The loader-state record of a checkpoint directory, or None."""
    try:
        with open(os.path.join(path, LOADER_STATE_RECORD)) as f:
            state = json.load(f)
    except (OSError, ValueError):
        return None
    return state if isinstance(state, dict) else None


def check_topology(path: str, world: int, mesh_axes: Optional[Dict[str, int]] = None) -> Optional[Dict[str, Any]]:
    """The checkpoint's topology record (None when untagged); raises
    :class:`TopologyMismatchError` when it was written on another mesh than
    ``mesh_axes`` (``None``: all data over ``world`` ranks), the ranks
    restoring it, or, for records without ``mesh_axes``, at a world size
    other than ``world``."""
    topo = read_topology(path)
    if topo is None:
        return None
    saved = topo.get("world_size")
    axes = topo.get("mesh_axes")
    if isinstance(axes, dict):
        from ..resilience.reshard import normalize_mesh_axes

        recorded = normalize_mesh_axes(axes)
        want = normalize_mesh_axes(mesh_axes if mesh_axes is not None else {"data": world}, world_size=world)
        if recorded != want:
            raise TopologyMismatchError(
                f"topology mismatch: checkpoint {os.path.basename(path)} was written at world size {saved} on"
                f" mesh {recorded} (data degree {recorded['data']}), restoring at {world} ranks on mesh {want};"
                f" reshard via resilience.reshard.reshard_from_checkpoint"
            )
    elif saved is not None and int(saved) != world:
        raise TopologyMismatchError(
            f"topology mismatch: checkpoint {os.path.basename(path)} was written at world size {saved},"
            f" restoring at {world} ranks; reshard via resilience.reshard.reshard_from_checkpoint"
        )
    return topo


# ---- save -------------------------------------------------------------------


def _phase(group, root: str, step, work: Callable[[], None]) -> None:
    """Run this rank's part of a save, then agree with the other ranks on
    whether every part landed: every rank raises if any failed, so none
    waits for a peer that gave up. A directory that refuses the write
    raises :class:`..resilience.guards.CheckpointUnwritableError`."""
    from ..resilience.guards import CheckpointUnwritableError

    err: Optional[BaseException] = None
    code = 0
    try:
        work()
    except OSError as e:
        err = e
        unwritable = isinstance(e, (CheckpointUnwritableError, PermissionError)) or e.errno in _UNWRITABLE_ERRNOS
        code = 1 if unwritable else 2
    except Exception as e:  # a peer must not wait for this rank
        err, code = e, 2
    code = agree(code, group, "max", kind="checkpoint")
    if code == 0:
        return
    if code == 1:
        if isinstance(err, CheckpointUnwritableError):
            raise err
        raise CheckpointUnwritableError(
            f"checkpoint root {root} unwritable at step {step}: {err or 'refused on another rank'}"
        ) from err
    if err is not None:
        raise err
    raise RuntimeError(f"checkpoint save at step {step} failed on another rank")


def _stage(tmp: str, parent: str) -> None:
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(parent, exist_ok=True)
    os.makedirs(tmp)


def _commit(
    tmp: str, final: str, step: Optional[int], topology: Optional[Dict[str, Any]],
    loader_state: Optional[Dict[str, Any]], timings: Optional[Dict[str, float]],
) -> None:
    if topology is not None:
        write_topology(tmp, topology)
    if loader_state is not None:
        write_loader_state(tmp, loader_state)
    t0 = time.perf_counter()
    write_manifest(tmp)
    t1 = time.perf_counter()
    with open(os.path.join(tmp, COMMITTED_MARKER), "w") as f:
        json.dump({"step": step, "ts": time.time()}, f)
    if os.path.isdir(final):  # a re-save of the same step replaces it whole
        shutil.rmtree(final)
    os.replace(tmp, final)
    if timings is not None:
        timings["hash_s"] = t1 - t0
        timings["bytes"] = sum(os.path.getsize(os.path.join(final, rel)) for rel in _payload_files(final))


def save_checkpoint(
    path: str,
    state: Any,
    step: Optional[int] = None,
    keep_last: Optional[int] = None,
    topology: Optional[Dict[str, Any]] = None,
    loader_state: Optional[Dict[str, Any]] = None,
    group=None,
    timings: Optional[Dict[str, float]] = None,
    _abort_before_commit: bool = False,
) -> str:
    """Save a training state (a ``TrainState``, a ``DiLoCoState``, any
    dataclass, NamedTuple or dict carry) through the commit protocol above;
    every rank of ``group`` calls it (``None``: one process). Returns the
    final path, ``<path>/step_N`` (``path`` itself without a step).

    ``keep_last`` removes all but the newest K committed steps after the
    save lands; ``topology`` and ``loader_state`` are committed with it.
    ``timings``, a dict, receives rank 0's ``serialize_s`` (the copies to
    the host and the file writes, every rank's included), ``hash_s``,
    ``commit_s`` (the records, the manifest, the marker and the rename)
    and ``bytes`` (the payload on disk).

    ``_abort_before_commit`` returns after the payload write but BEFORE
    the manifest, marker and rename: the torn tmp directory a crash
    mid-save leaves. A directory that refuses the write raises
    :class:`..resilience.guards.CheckpointUnwritableError` on every rank.
    """
    rank, _ = rank_and_world(group)
    root = os.path.abspath(path)
    final = os.path.join(root, f"step_{step}") if step is not None else root
    parent, name = os.path.dirname(final), os.path.basename(final)
    pid = agree(os.getpid() if rank == 0 else 0, group, "max", kind="checkpoint")
    tmp = os.path.join(parent, f"{_TMP_PREFIX}{name}.{pid}")
    t0 = time.perf_counter()
    _phase(group, root, step, lambda: _stage(tmp, parent) if rank == 0 else None)
    own = per_rank_fields(state)

    def write() -> None:
        names = state_fields(state)
        if rank == 0:
            torch.save({n: _plain(_get(state, n)) for n in names if n not in own}, os.path.join(tmp, REPLICATED_FILE))
        torch.save({n: _plain(_get(state, n)) for n in names if n in own}, os.path.join(tmp, rank_file(rank)))

    _phase(group, root, step, write)
    t1 = time.perf_counter()
    if _abort_before_commit:
        return tmp
    _phase(
        group, root, step,
        lambda: _commit(tmp, final, step, topology, loader_state, timings) if rank == 0 else None,
    )
    if timings is not None:
        timings["serialize_s"] = t1 - t0
        timings["commit_s"] = time.perf_counter() - t1
    if keep_last is not None and step is not None and rank == 0:
        gc_checkpoints(root, keep_last)
    return final


# ---- restore ------------------------------------------------------------------


def _load(path: str, name: str) -> Dict[str, Any]:
    return torch.load(os.path.join(path, name), map_location="cpu", weights_only=True)


def load_checked(
    path: str, template: Any, group=None, fields: Optional[Sequence[str]] = None, sharded: bool = False,
    mesh_axes: Optional[Dict[str, int]] = None,
) -> Callable[[], Any]:
    """Read the checkpoint at ``path`` for this rank and check it against
    ``template`` without writing anything; returns the function that
    writes it into ``template`` (and returns the template). ``fields``
    restores only those fields; a restore of replicated fields alone does
    not depend on the world size. ``sharded`` reads this rank's own file
    and nothing else (every field restored must be per rank), after
    checking that the checkpoint holds one file for each rank of
    ``group``. ``mesh_axes`` is the mesh of the ranks restoring
    (:func:`check_topology`)."""
    path = os.path.abspath(path)
    rank, world = rank_and_world(group)
    names = list(fields) if fields is not None else state_fields(template)
    own = per_rank_fields(template)
    per_rank = [n for n in names if n in own]
    if sharded and len(per_rank) < len(names):
        replicated = [n for n in names if n not in own]
        raise ValueError(f"a sharded restore reads per-rank fields only; {replicated} are replicated")
    if per_rank:
        check_topology(path, world, mesh_axes)
    if sharded:
        files = sum(1 for n in os.listdir(path) if n.startswith("rank_") and n.endswith(".pt"))
        if files != world:
            raise TopologyMismatchError(
                f"topology mismatch: checkpoint {os.path.basename(path)} holds {files} rank files, restoring at"
                f" {world} ranks; reshard via resilience.reshard.reshard_from_checkpoint"
            )
    saved: Dict[str, Any] = {}
    if len(per_rank) < len(names):
        replicated = _load(path, REPLICATED_FILE)
        saved.update({n: replicated[n] for n in names if n not in own and n in replicated})
    if per_rank:
        mine = _load(path, rank_file(rank))
        saved.update({n: mine[n] for n in per_rank if n in mine})
    _assign_fields(template, saved, names, dry=True)
    return lambda: (_assign_fields(template, saved, names, dry=False), template)[1]


def restore_checkpoint(
    path: str, template: Any, group=None, fields: Optional[Sequence[str]] = None,
    mesh_axes: Optional[Dict[str, int]] = None,
) -> Any:
    """Restore the checkpoint at ``path`` into ``template`` (built the way
    the run built its initial state) and return it: each rank reads the
    replicated file and its own row. A checkpoint tagged with another
    world size, or another mesh than ``mesh_axes``, raises
    :class:`TopologyMismatchError`."""
    return load_checked(path, template, group, fields, mesh_axes=mesh_axes)()


def restore_checkpoint_sharded(path: str, template: Any, group=None) -> Any:
    """Restore a state whose every field is per rank (``parallel.fsdp.
    FSDPState``) from this rank's own file only: no rank reads, or holds,
    another rank's shards (the reference's ``utils/checkpoint.py:334-363``).
    A checkpoint of another world size (by its topology record, or by its
    count of rank files) raises :class:`TopologyMismatchError`; a
    template with replicated fields raises ``ValueError``."""
    return load_checked(path, template, group, sharded=True)()


def committed_step_paths(root: str) -> List[Tuple[int, str]]:
    """Committed ``step_N`` checkpoints under ``root``, newest first; torn
    directories and in-flight tmp directories are skipped."""
    root = os.path.abspath(root)
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_") and name[5:].isdigit():
            full = os.path.join(root, name)
            if is_committed(full):
                steps.append((int(name[5:]), full))
    return sorted(steps, reverse=True)


def latest_step_path(root: str) -> Optional[str]:
    """The newest COMMITTED ``step_N`` under ``root``, or None."""
    committed = committed_step_paths(root)
    return committed[0][1] if committed else None


def restore_latest(
    root: str,
    template: Any,
    telemetry: Any = None,
    label: str = "",
    resharder: Optional[Callable[[str, Optional[Dict[str, Any]]], Any]] = None,
    group=None,
    fields: Optional[Sequence[str]] = None,
    sharded: bool = False,
) -> Optional[Tuple[Any, int]]:
    """Restore the newest checkpoint that passes verification, walking back
    through older committed steps when the newest is corrupt (a bit flip,
    a torn payload) or unreadable; every skip emits a
    ``checkpoint_fallback`` :class:`..observe.FailureEvent`. Returns
    ``(state, step)``, or None when nothing restorable exists. The ranks
    split the hashing and agree on each verdict, so all of them restore
    the same step.

    ``sharded`` restores through :func:`restore_checkpoint_sharded` (each
    rank reads its own file only). A checkpoint of another world size is
    never restored as it is: with ``resharder`` (a ``(path, saved_topology) ->
    state`` callable, typically around
    ``resilience.reshard.reshard_from_checkpoint``) the restore goes
    through it; without one, :class:`TopologyMismatchError` propagates."""
    from ..observe import FailureEvent

    rank, world = rank_and_world(group)
    for step, path in committed_step_paths(root):
        ok, reason = verify_checkpoint(path, share=(rank, world))
        ok = bool(agree(int(ok), group, "min", kind="checkpoint"))
        if ok:
            apply = None
            try:
                apply = load_checked(path, template, group, fields, sharded=sharded)
            except TopologyMismatchError:
                if resharder is None:
                    raise
                return resharder(path, read_topology(path)), step
            except Exception as e:  # a payload torch.load cannot parse
                reason = f"restore failed: {type(e).__name__}: {e}"
            if agree(int(apply is not None), group, "min", kind="checkpoint"):
                return apply(), step
            if apply is not None:
                reason = "restore failed on another rank"
        if telemetry is not None:
            telemetry.emit(
                FailureEvent(
                    kind="checkpoint_fallback", label=label, step=step,
                    message=f"skipping {os.path.basename(path)}: {reason}",
                )
            )
    return None


def gc_checkpoints(root: str, keep_last: int) -> List[str]:
    """Retention: delete all but the newest ``keep_last`` committed steps,
    and any abandoned ``_tmp.*`` directory not of this process. Returns
    the deleted paths."""
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    root = os.path.abspath(root)
    deleted = []
    for _step, path in committed_step_paths(root)[keep_last:]:
        shutil.rmtree(path, ignore_errors=True)
        deleted.append(path)
    if os.path.isdir(root):
        own_suffix = f".{os.getpid()}"
        for name in os.listdir(root):
            if name.startswith(_TMP_PREFIX) and not name.endswith(own_suffix):
                shutil.rmtree(os.path.join(root, name), ignore_errors=True)
                deleted.append(os.path.join(root, name))
    return deleted
