"""The per-collective wire ledger, the JAX package's ``observe/ledger.py``
for the port.

A step's analytic bits on the wire (``bits_per_step``) is one number; the
ledger itemises it: each collective the step issues gets a line (tag,
layer, op, axis, dtype, payload bytes, count), so a report says which part
of the system moved the bytes (the reducer's P and Q factors, the rank-1
payload, the trainer's loss sync, FSDP's gathers and reduce-scatters).

The JAX package reconciles the ledger against the compiled step's HLO. The
port runs eagerly and has no HLO: :func:`audit_recorded_step` reconciles
it against what :func:`..parallel.comm.record_collectives` saw during the
step's first call, and emits the same events (one ``CollectiveEvent`` a
ledger line and one ``CompileEvent``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from .events import CollectiveEvent, CompileEvent

# the trainer's all-reduce of the scalar loss (trainer.LOSS_SYNC_BITS, 32
# bits); a literal here because the trainer imports this module
_LOSS_SYNC_BYTES = 4


@dataclass(frozen=True)
class LedgerEntry:
    """One ledger line. ``payload_bytes`` is the TOTAL over the entry's
    ``count`` collectives."""

    tag: str  # "grads", "powersgd.P", "loss-sync", "fsdp.param-gather", ...
    layer: str  # reducer | trainer | fsdp | pipeline
    op: str  # all-reduce | all-gather | reduce-scatter | ...
    axis: str  # the mesh axis ("data", ...); "" = none
    dtype: str
    payload_bytes: int
    count: int = 1


def dtype_name(dtype) -> str:
    """A dtype's name as the JAX package writes it (``float32``)."""
    return str(dtype).rsplit(".", 1)[-1]


def _tensor_bytes(t) -> int:
    return t.numel() * t.element_size()


class WireLedger:
    """The itemisation of a step's ``bits_per_step``. ``dense_grad_bits``
    (where known) is the uncompressed gradient's size, the numerator of
    the compression ratio."""

    def __init__(self, entries: Sequence[LedgerEntry] = (), dense_grad_bits: Optional[int] = None):
        self.entries: List[LedgerEntry] = list(entries)
        self.dense_grad_bits = dense_grad_bits

    def add(self, entry: LedgerEntry) -> LedgerEntry:
        self.entries.append(entry)
        return entry

    def total_bytes(self) -> int:
        return sum(e.payload_bytes for e in self.entries)

    def total_bits(self) -> int:
        return 8 * self.total_bytes()

    def by_tag(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.entries:
            out[e.tag] = out.get(e.tag, 0) + e.payload_bytes
        return out

    def by_layer(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.entries:
            out[e.layer] = out.get(e.layer, 0) + e.payload_bytes
        return out

    def layer_bytes(self, layer: str) -> int:
        return sum(e.payload_bytes for e in self.entries if e.layer == layer)

    def compression_ratio(self) -> Optional[float]:
        """Dense gradient bytes over the reducer layer's wire bytes (1.0 for
        exact DDP; None where either is unknown or zero)."""
        reducer_bytes = self.layer_bytes("reducer")
        if not reducer_bytes or self.dense_grad_bits is None:
            return None
        return (self.dense_grad_bits / 8) / reducer_bytes

    def collective_events(self, label: str) -> List[CollectiveEvent]:
        return [
            CollectiveEvent(
                label=label, tag=e.tag, layer=e.layer, op=e.op, axis=e.axis, dtype=e.dtype,
                payload_bytes=e.payload_bytes, count=e.count,
            )
            for e in self.entries
        ]

    def reconcile(self, records) -> Dict:
        """The analytic total against the collectives a step issued
        (``parallel.comm.CollectiveRecord``s). The keys are the JAX
        package's, whose ``hlo_*`` are the compiled step's collectives:
        here the recorded ones. The delta is signed and always reported."""
        issued = sum(r.payload_bytes for r in records)
        analytic = self.total_bytes()
        by_kind: Dict[str, int] = {}
        for r in records:
            by_kind[r.kind] = by_kind.get(r.kind, 0) + 1
        return {
            "analytic_bytes": analytic,
            "hlo_bytes": issued,
            "delta_bytes": issued - analytic,
            "exact": issued == analytic,
            "hlo_by_kind": dict(sorted(by_kind.items())),
            "hlo_collective_count": len(records),
        }


def loss_sync_entry(axis: str) -> LedgerEntry:
    """The trainer's one collective outside the reducer: the all-reduce of
    the scalar loss for reporting (``trainer.LOSS_SYNC_BITS``)."""
    return LedgerEntry(
        tag="loss-sync", layer="trainer", op="all-reduce", axis=axis, dtype="float32", payload_bytes=_LOSS_SYNC_BYTES
    )


def reducer_ledger_entries(reducer, params_template, axis: str, n_workers: int = 1) -> List[LedgerEntry]:
    """The entries of one reduction of ``params_template`` (a sequence of
    tensors). A reducer that knows its structure gives them
    (``ledger_entries``); any other gets one entry at its analytic
    ``bits_per_step``, so the ledger's total still matches the step's."""
    if hasattr(reducer, "ledger_entries"):
        return list(reducer.ledger_entries(params_template, axis=axis, n_workers=n_workers))
    leaves = list(params_template)
    if hasattr(reducer, "bits_per_step"):
        bits = reducer.bits_per_step(leaves, n_workers=n_workers)
    else:
        bits = sum(8 * _tensor_bytes(t) for t in leaves)
    dtypes = {dtype_name(t.dtype) for t in leaves}
    return [
        LedgerEntry(
            tag="reduction", layer="reducer", op="all-reduce", axis=axis,
            dtype=dtypes.pop() if len(dtypes) == 1 else "mixed", payload_bytes=bits // 8,
        )
    ]


def step_ledger(
    reducer,
    params_template,
    axis: str,
    n_workers: int,
    expected_bits: Optional[int] = None,
    include_loss_sync: bool = True,
) -> WireLedger:
    """The training step's ledger: the reducer's entries and the loss
    sync (left out for the single-process step, which has no group and no
    loss collective), with the dense gradient's size. ``expected_bits``
    (the step's ``bits_per_step``) pins the ledger as an itemisation of
    that number, not a second model that can drift from it."""
    leaves = list(params_template)
    entries = reducer_ledger_entries(reducer, leaves, axis, n_workers)
    if include_loss_sync:
        entries.append(loss_sync_entry(axis))
    ledger = WireLedger(entries, dense_grad_bits=sum(8 * _tensor_bytes(t) for t in leaves))
    if expected_bits is not None and ledger.total_bits() != expected_bits:
        raise AssertionError(
            f"wire ledger itemizes {ledger.total_bits()} bits but the step's analytic bits_per_step is"
            f" {expected_bits}: the ledger must sum to the model it itemizes (entries: {entries})"
        )
    return ledger


def audit_recorded_step(step, records, label: str = "train_step", telemetry=None, device_kind: str = "") -> CompileEvent:
    """Reconcile ``step``'s wire ledger against ``records``, the
    collectives its first call issued (``parallel.comm.record_collectives``
    around it), and emit the result through ``telemetry``: one
    ``CollectiveEvent`` a ledger line, then the ``CompileEvent``.

    The port's counterpart of the JAX package's ``audit_compiled_step``,
    which reads the compiled HLO. Its ``hlo_*`` fields hold the issued
    collectives here; the compile-time cost, memory and overlap fields
    have no counterpart in eager PyTorch and stay empty. ``device_kind``
    names the device the step ran on."""
    from .spans import span

    ledger = getattr(step, "ledger", None)
    if ledger is None:
        # a step without an itemised ledger still gets the check against its
        # one-number analytic model
        ledger = WireLedger([
            LedgerEntry(
                tag="step", layer="trainer", op="all-reduce", axis="", dtype="unknown",
                payload_bytes=getattr(step, "bits_per_step", 0) // 8,
            )
        ])
    with span("audit/record"):
        rec = ledger.reconcile(records)
    event = CompileEvent(
        label=label,
        analytic_bytes=rec["analytic_bytes"],
        hlo_bytes=rec["hlo_bytes"],
        delta_bytes=rec["delta_bytes"],
        exact=rec["exact"],
        hlo_collective_count=rec["hlo_collective_count"],
        hlo_by_kind=rec["hlo_by_kind"],
        dense_grad_bytes=ledger.dense_grad_bits // 8 if ledger.dense_grad_bits else None,
        compression_ratio=ledger.compression_ratio(),
        comm_config=dict(getattr(step, "comm_config", None) or {}),
        device_kind=device_kind,
    )
    if telemetry is not None:
        for ce in ledger.collective_events(label):
            telemetry.emit(ce)
        telemetry.emit(event)
    return event
