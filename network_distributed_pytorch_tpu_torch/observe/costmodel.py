"""The offline what-if cost model: the port's own copy of the JAX
package's ``observe/costmodel.py``. It replays one run's report into a
predictor for each component of a step and prices comm configs that were
never run. Imports no torch.

It reads only the machine-readable run report that ``scripts/
torch_report.py`` writes, and its predictions are events of their own
(:class:`~observe.events.PredictionEvent`): when a predicted config is
later run, ``scripts/torch_report.py --plan`` joins predicted against
realized (:func:`join_realized`, whose ``error`` is the model's own).

The model, per (config, fabric):

- **compute**: the ``step/compute`` span's mean when the run recorded
  spans (less the modeled exposed comm on ``source_fabric`` when given:
  a step's collectives run inside that span), else the measured step p50.
  It does not change with the comm config; the run's FLOPs over it are
  the rate the compression term is priced at.
- **comm**: the ring all-reduce's wire time ``2(W-1)/W * bytes / beta``
  (``utils.bandwidth``), scaled by the measured exposed fraction and
  divided by the config's pipeline depth (chunks or buckets expose about
  1/D of it), plus a fabric latency a collective that grows with depth.
- **compression**: PowerSGD's compress-side compute, about ``6 * rank *
  n_elems`` FLOPs at that rate; the payload is ``rank *
  bytes_fraction_per_rank`` of the dense gradient (measured when the
  source run was compressed, 1/8 a rank unit otherwise).
- **localsgd**: ``sync_every`` spreads the round over the steps between
  syncs.

The one difference from the JAX package: the hierarchical rungs' inner
level is priced on ``INNER_FABRIC = "NVLink4(H100)"``, the port's in-node
row, where the JAX package names its TPU interconnect.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass, replace
from typing import Dict, List, Optional

from ..utils import bandwidth as _bandwidth
from .events import PredictionEvent

PLAN_SCHEMA = 1

# compression model default: a PowerSGD rank-r payload as a fraction of the
# dense gradient bytes, per rank unit, used when the source run never ran
# compressed (nothing measured to calibrate from). 1/8 per rank matches the
# toy worker's rank-1 ledger and is the right order for the paper's CIFAR
# convnet; a compressed source run overrides it with the measured ratio.
DEFAULT_BYTES_FRACTION_PER_RANK = 1.0 / 8.0
# PowerSGD compress-side compute: ~2 GEMM passes (P = M^T Q, Q = M P) plus
# the Gram-Schmidt, ~6 FLOPs per payload element per rank unit
POWERSGD_FLOPS_PER_ELEM_PER_RANK = 6.0
# modeled pipeline depth cap: beyond this, per-chunk latency dominates and
# the linear exposure discount stops being credible
MAX_PIPELINE_DEPTH = 64
# floor on the calibrated compute fraction of the measured step: the
# subtraction path (step minus modeled comm) must not calibrate compute to
# ~zero on a comm-dominated source run
MIN_COMPUTE_FRACTION = 0.05

KNOBS = (
    "reducer", "reducer_rank", "comm_chunks", "comm_strategy",
    "bucket_bytes", "sync_every", "outer_async", "sites",
)

# hierarchical pricing: the inner level reduces over the fast in-node
# fabric, so it is priced on this scalar table entry and never on a
# measured cross-site matrix (whose bottleneck edge is the slow link)
INNER_FABRIC = "NVLink4(H100)"
DEFAULT_SITES = 2


def canonical_config(config: Optional[Dict], name: str = "") -> Dict:
    """Normalize a comm config (a fallback-ladder rung's overrides, a
    ``CompileEvent.comm_config``, or a plan entry) to the canonical knob
    dict predictions and realized runs join on."""
    config = config or {}
    reducer = str(config.get("reducer") or "exact").lower()
    if "powersgd" in reducer:
        reducer = "powersgd"
    elif "hier" in reducer:
        reducer = "hierarchical"
    elif reducer not in ("exact",):
        reducer = "exact" if "exact" in reducer else reducer
    rank = config.get("reducer_rank")
    out = {
        "name": str(config.get("name") or name or ""),
        "reducer": reducer,
        "reducer_rank": int(rank) if rank else 0,
        "comm_chunks": int(config.get("comm_chunks") or 0),
        "comm_strategy": str(config.get("comm_strategy") or "interleave"),
        "bucket_bytes": int(config.get("bucket_bytes") or 0),
        "sync_every": max(1, int(config.get("sync_every") or 1)),
        # two-level knobs: meaningful only for reducer="hierarchical"
        # (config_key omits them elsewhere so historical keys are stable)
        "outer_async": 1 if config.get("outer_async") else 0,
        "sites": int(config.get("sites") or 0),
    }
    if out["reducer"] == "powersgd" and out["reducer_rank"] == 0:
        out["reducer_rank"] = 1
    return out


def config_key(config: Dict) -> str:
    """The canonical join key: knob values only, never the display name."""
    c = canonical_config(config)
    key = (
        f"reducer={c['reducer']},rank={c['reducer_rank']},"
        f"chunks={c['comm_chunks']},strategy={c['comm_strategy']},"
        f"bucket={c['bucket_bytes']},sync={c['sync_every']}"
    )
    if c["reducer"] == "hierarchical":
        key += f",async={c['outer_async']},sites={c['sites']}"
    return key


@dataclass
class CostCalibration:
    """What one run's artifacts pin down: the measured step, the split of
    it the model treats as comm-invariant compute, the dense wire cost,
    and the schedule's exposure — everything :func:`predict` needs."""

    step_time_s: float
    compute_s: float
    dense_bytes: float  # uncompressed gradient bytes on the wire per sync
    bytes_per_step: float  # what the source run actually moved per step
    n_workers: int
    exposed_fraction: float = 1.0
    n_collectives: int = 1
    flops_per_step: float = 0.0
    peak_flops_per_s: float = 0.0
    bytes_fraction_per_rank: float = DEFAULT_BYTES_FRACTION_PER_RANK
    source_config: Optional[Dict] = None
    source_fabric: Optional[str] = None
    source_run: str = ""

    @property
    def effective_flops_per_s(self) -> float:
        """The MFU-scaled FLOP rate the source run actually sustained —
        what compression compute is priced at (falls back to peak, then 0
        = compression compute unpriceable)."""
        if self.flops_per_step > 0 and self.compute_s > 0:
            return self.flops_per_step / self.compute_s
        return self.peak_flops_per_s


def _num(v) -> Optional[float]:
    return float(v) if isinstance(v, (int, float)) and v == v else None


def calibrate(report: Dict, source_fabric: Optional[str] = None) -> CostCalibration:
    """Build a :class:`CostCalibration` from a run-report dict
    (``scripts/torch_report.py --run-dir``, ``--json-out``).

    ``source_fabric`` names the fabric the measured run executed on (a
    ``utils.bandwidth.FABRICS_BYTES_PER_S`` key); when given, the modeled
    exposed comm time on it is subtracted from the compute calibration —
    needed when the run's ``step/compute`` span encloses the collectives
    (the real training step), harmless when it does not.

    Raises ``ValueError`` when the report has no usable step time."""
    step = _num(report.get("step_p50_s"))
    if step is None or step <= 0:
        raise ValueError("report has no usable step_p50_s to calibrate from")

    n_workers = int(report.get("world_size") or 0) or 1
    bw = report.get("bandwidth") if isinstance(report.get("bandwidth"), dict) else {}
    total = bw.get("total") if isinstance(bw.get("total"), dict) else {}
    attribution = (
        bw.get("attribution") if isinstance(bw.get("attribution"), dict) else {}
    )
    compile_rec = (
        report.get("compile") if isinstance(report.get("compile"), dict) else {}
    )

    bytes_per_step = _num(total.get("payload_bytes"))
    if bytes_per_step is None:
        bytes_per_step = _num(compile_rec.get("analytic_bytes")) or 0.0
    n_collectives = int(total.get("count") or 0) or 1
    exposed = _num(attribution.get("exposed_fraction"))
    exposed = 1.0 if exposed is None else min(1.0, max(0.0, exposed))

    # the source run's own comm config: what it compiled with (the
    # CompileEvent plumbing), canonicalized so the dense-bytes and
    # compression-ratio calibration below know whether the measured
    # payload was already compressed
    source_config = canonical_config(compile_rec.get("comm_config"))
    frac_per_rank = DEFAULT_BYTES_FRACTION_PER_RANK
    dense_bytes = bytes_per_step
    ratio = _num(compile_rec.get("compression_ratio"))
    dense_rec = _num(compile_rec.get("dense_grad_bytes"))
    if source_config["reducer"] == "powersgd":
        if dense_rec and dense_rec > 0:
            dense_bytes = dense_rec
        elif ratio and ratio > 0:
            dense_bytes = bytes_per_step * ratio
        if dense_bytes > 0 and source_config["reducer_rank"] > 0:
            frac_per_rank = (
                (bytes_per_step / dense_bytes) / source_config["reducer_rank"]
            )
    elif source_config["reducer"] == "hierarchical" and dense_rec:
        # a two-level source run's wire total folds in the amortized
        # inner sync phase and the compressed outer round; the recorded
        # dense gradient size is the honest per-level baseline
        dense_bytes = dense_rec

    # FLOPs from the report's MFU join (first record carrying them)
    flops = peak = 0.0
    for rec in report.get("mfu") or []:
        f = _num(rec.get("flops_per_step")) if isinstance(rec, dict) else None
        if f and f > 0:
            flops = f
            peak = _num(rec.get("peak_flops_per_s")) or 0.0
            break

    # compute calibration: the step/compute span mean when recorded (the
    # toy worker and the real loops both span it), else the whole step;
    # minus the modeled exposed comm on the source fabric when known
    spans = report.get("spans") if isinstance(report.get("spans"), dict) else {}
    by_name = spans.get("by_name") if isinstance(spans.get("by_name"), dict) else {}
    slot = by_name.get("step/compute")
    compute = _num(slot.get("mean_s")) if isinstance(slot, dict) else None
    base = min(compute, step) if compute and compute > 0 else step
    if source_fabric and bytes_per_step > 0:
        # the shared typed accessor (scalar tables here: the source run's
        # own fabric is what the measured step already priced in)
        model = _bandwidth.fabric_model()
        modeled = exposed * model.allreduce_time_s(
            bytes_per_step, n_workers, source_fabric,
            n_collectives=n_collectives,
        )
        base = max(base - modeled, MIN_COMPUTE_FRACTION * step)

    return CostCalibration(
        step_time_s=step,
        compute_s=base,
        dense_bytes=float(dense_bytes),
        bytes_per_step=float(bytes_per_step),
        n_workers=n_workers,
        exposed_fraction=exposed,
        n_collectives=n_collectives,
        flops_per_step=flops,
        peak_flops_per_s=peak,
        bytes_fraction_per_rank=frac_per_rank,
        source_config=source_config,
        source_fabric=source_fabric,
        source_run=str(report.get("run_dir") or ""),
    )


def predict(
    calib: CostCalibration,
    config: Dict,
    fabric: str,
    matrix: Optional[Dict] = None,
) -> Dict:
    """Price one config on one fabric. Returns the prediction dict with
    its full per-component breakdown (the PredictionEvent payload).

    ``matrix`` is an optional measured per-edge fabric matrix
    (``observe.fabric`` / ``artifacts/fabric_matrix.json``). When present,
    the ring terms price against the SLOWEST measured edge — every chunk
    of a ring reduction traverses every link, so the worst link gates the
    whole collective — instead of the named fabric's scalar."""
    model = _bandwidth.fabric_model(matrix)
    if fabric not in model.fabrics:
        raise ValueError(
            f"unknown fabric {fabric!r} (have {sorted(model.fabrics)})"
        )
    beta = model.ring_beta(fabric)
    lat = model.ring_latency_s(fabric)
    c = canonical_config(config)
    if c["reducer"] == "hierarchical":
        return _predict_hierarchical(calib, c, fabric, model)
    w = max(1, calib.n_workers)

    # bytes on the wire per sync round
    if c["reducer"] == "powersgd":
        frac = min(1.0, c["reducer_rank"] * calib.bytes_fraction_per_rank)
        wire_bytes = calib.dense_bytes * frac
        n_coll = 2 * calib.n_collectives  # the P and Q round trips
    else:
        wire_bytes = calib.dense_bytes
        n_coll = calib.n_collectives

    # pipeline depth: chunked and bucketed configs decompose the payload
    # into D fenced collectives; ~1/D of the wire time stays exposed, but
    # every segment pays the fabric's latency
    chunks = c["comm_chunks"] or 1
    n_buckets = (
        max(1, math.ceil(wire_bytes / c["bucket_bytes"]))
        if c["bucket_bytes"] else 1
    )
    depth = min(MAX_PIPELINE_DEPTH, max(chunks, n_buckets))

    wire_s = (
        (2.0 * (w - 1) / w) * (wire_bytes / beta) if w > 1 and beta > 0 else 0.0
    )
    exposed_comm_s = calib.exposed_fraction * wire_s / depth
    latency_s = lat * n_coll * depth

    compress_s = 0.0
    if c["reducer"] == "powersgd":
        eff = calib.effective_flops_per_s
        if eff > 0:
            n_elems = calib.dense_bytes / 4.0  # fp32 gradient elements
            compress_s = (
                POWERSGD_FLOPS_PER_ELEM_PER_RANK * c["reducer_rank"] * n_elems
            ) / eff

    sync = c["sync_every"]
    per_step_comm_s = (exposed_comm_s + latency_s + compress_s) / sync
    return {
        "config": c,
        "config_key": config_key(c),
        "fabric": fabric,
        "predicted_step_s": calib.compute_s + per_step_comm_s,
        "predicted_bytes_per_step": wire_bytes / sync,
        "compute_s": calib.compute_s,
        "wire_s": wire_s,
        "exposed_comm_s": exposed_comm_s / sync,
        "latency_s": latency_s / sync,
        "compress_s": compress_s / sync,
        "pipeline_depth": depth,
        "n_collectives": n_coll,
        # provenance: scalar table vs measured per-edge matrix, and which
        # edge gated the ring when a matrix was supplied
        "per_edge": model.per_edge,
        "bottleneck_edge": (
            {"src": model.bottleneck().src, "dst": model.bottleneck().dst}
            if model.per_edge else None
        ),
    }


def _predict_hierarchical(
    calib: CostCalibration, c: Dict, fabric: str, model
) -> Dict:
    """Price a two-level hierarchical config: dense per-step reduction on
    the fast in-node fabric plus a compressed (or exact, rank=0) outer
    reduction over site leaders every ``sync_every`` steps on the slow
    ``fabric``. With ``outer_async`` the outer collective overlaps the
    next round's inner steps, so only the overflow past that compute
    window stays exposed — the whole point of the async outer loop.

    The inner level is priced on :data:`INNER_FABRIC`'s scalar even when
    a measured matrix gates the outer ring: the inner all-reduce never
    crosses the measured bottleneck edge."""
    w = max(1, calib.n_workers)
    sites = c["sites"] or DEFAULT_SITES
    sites = max(2, min(sites, w)) if w > 1 else 1
    inner_w = max(1, w // sites)
    sync = c["sync_every"]

    # inner level: one dense DDP all-reduce per step plus the sync
    # round's dense inner reduction, on the fast fabric
    inner_beta = model.fabrics.get(INNER_FABRIC) or max(model.fabrics.values())
    inner_wire_s = (
        (2.0 * (inner_w - 1) / inner_w) * (calib.dense_bytes / inner_beta)
        if inner_w > 1 and inner_beta > 0 else 0.0
    )
    inner_per_step_s = (
        calib.exposed_fraction * inner_wire_s * (1.0 + 1.0 / sync)
    )

    # outer level: the cross-site ring on the slow edge (matrix
    # bottleneck when measured), compressed when an outer rank is set
    beta = model.ring_beta(fabric)
    lat = model.ring_latency_s(fabric)
    rank = c["reducer_rank"]
    if rank > 0:
        frac = min(1.0, rank * calib.bytes_fraction_per_rank)
        outer_bytes = calib.dense_bytes * frac
        n_coll = 2 * calib.n_collectives  # the P and Q round trips
    else:
        outer_bytes = calib.dense_bytes
        n_coll = calib.n_collectives
    outer_wire_s = (
        (2.0 * (sites - 1) / sites) * (outer_bytes / beta)
        if sites > 1 and beta > 0 else 0.0
    )
    compress_s = 0.0
    if rank > 0:
        eff = calib.effective_flops_per_s
        if eff > 0:
            n_elems = calib.dense_bytes / 4.0  # fp32 gradient elements
            compress_s = (
                POWERSGD_FLOPS_PER_ELEM_PER_RANK * rank * n_elems
            ) / eff
    outer_total_s = outer_wire_s + lat * n_coll + compress_s
    if c["outer_async"]:
        # a whole round of inner compute to hide the outer sync in;
        # only the overflow past that window is exposed
        window_s = sync * (calib.compute_s + inner_per_step_s)
        exposed_outer_s = max(0.0, outer_total_s - window_s)
    else:
        exposed_outer_s = (
            calib.exposed_fraction * outer_wire_s + lat * n_coll + compress_s
        )

    inner_bytes_per_step = calib.dense_bytes * (1.0 + 1.0 / sync)
    outer_bytes_per_step = outer_bytes / sync
    per_step_comm_s = inner_per_step_s + exposed_outer_s / sync
    return {
        "config": c,
        "config_key": config_key(c),
        "fabric": fabric,
        "predicted_step_s": calib.compute_s + per_step_comm_s,
        "predicted_bytes_per_step": (
            inner_bytes_per_step + outer_bytes_per_step
        ),
        # per-level breakdown: the cross-site shrinkage claim is
        # falsifiable against the ledger's outer.*/inner.* tags
        "predicted_inner_bytes_per_step": inner_bytes_per_step,
        "predicted_outer_bytes_per_step": outer_bytes_per_step,
        "compute_s": calib.compute_s,
        "wire_s": outer_wire_s,
        # exposed_comm_s here is the full exposed per-step comm (inner +
        # outer overflow); under async the latency/compress components
        # may be wholly hidden, so they are reported informationally
        "exposed_comm_s": per_step_comm_s,
        "latency_s": lat * n_coll / sync,
        "compress_s": compress_s / sync,
        "pipeline_depth": 1,
        "n_collectives": n_coll,
        "sites": sites,
        "outer_async": bool(c["outer_async"]),
        "per_edge": model.per_edge,
        "bottleneck_edge": (
            {"src": model.bottleneck().src, "dst": model.bottleneck().dst}
            if model.per_edge else None
        ),
    }


def slice_calibration(calib: CostCalibration, world: int) -> CostCalibration:
    """The calibration re-anchored at a different worker count: per-worker
    compute and the dense gradient are invariant (data parallelism keeps
    the per-worker batch fixed), only the ring term's ``2(W-1)/W`` factor
    and the collective fan-in change. This is what lets one calibrated
    toy run price every viable mesh SLICE of the fleet's inventory."""
    return replace(calib, n_workers=max(1, int(world)))


def price_slice(
    calib: CostCalibration,
    world: int,
    fabric: str,
    config: Optional[Dict] = None,
    steps: Optional[float] = None,
    deadline_s: Optional[float] = None,
    matrix: Optional[Dict] = None,
) -> Dict:
    """Price one mesh slice: the calibrated job executed on ``world`` of
    the inventory's chips instead of the ``calib.n_workers`` it was
    measured at.

    ``steps`` is the job's remaining work in steps AT THE CALIBRATED
    world; a slice of ``world`` workers processes the same global work in
    ``steps * n_workers / world`` steps (data-parallel scaling of the
    global batch), so a bigger slice finishes sooner but burns more
    chip-seconds per wall second — exactly the tradeoff the scheduler's
    deadline-cheapest admission resolves. ``predicted_chip_seconds`` is
    the slice's total cost (world x predicted wall); ``meets_deadline``
    is set when both ``steps`` and ``deadline_s`` were given."""
    c = canonical_config(config or calib.source_config or {})
    p = predict(slice_calibration(calib, world), c, fabric, matrix=matrix)
    out: Dict = {
        "world": int(world),
        "fabric": fabric,
        "config": c,
        "config_key": p["config_key"],
        "predicted_step_s": p["predicted_step_s"],
        "exposed_comm_s": p["exposed_comm_s"],
        "compute_s": p["compute_s"],
    }
    if steps is not None and steps > 0:
        scaled_steps = steps * max(1, calib.n_workers) / max(1, world)
        wall = scaled_steps * p["predicted_step_s"]
        out["steps"] = scaled_steps
        out["predicted_wall_s"] = wall
        out["predicted_chip_seconds"] = wall * max(1, world)
        if deadline_s is not None:
            out["deadline_s"] = float(deadline_s)
            out["meets_deadline"] = wall <= deadline_s
    return out


def search_slices(
    calib: CostCalibration,
    worlds: List[int],
    fabric: str,
    config: Optional[Dict] = None,
    steps: Optional[float] = None,
    deadline_s: Optional[float] = None,
    matrix: Optional[Dict] = None,
) -> List[Dict]:
    """Rank candidate slice sizes for one job: deadline-meeting slices
    first, cheapest chip-seconds among them (the admission policy — never
    grant more chips than the deadline needs); slices that miss the
    deadline sort after, fastest wall first (the least-bad overflow
    order). Without ``steps``/``deadline_s`` it degrades to cheapest
    predicted step time, largest world breaking ties (pure throughput)."""
    priced = [
        price_slice(
            calib, w, fabric, config=config, steps=steps,
            deadline_s=deadline_s, matrix=matrix,
        )
        for w in sorted(set(int(w) for w in worlds if int(w) >= 1))
    ]

    def rank_key(p: Dict):
        if "meets_deadline" in p:
            return (
                0 if p["meets_deadline"] else 1,
                p.get("predicted_chip_seconds")
                if p["meets_deadline"]
                else p.get("predicted_wall_s", float("inf")),
            )
        if "predicted_wall_s" in p:
            return (0, p["predicted_chip_seconds"])
        return (0, (p["predicted_step_s"], -p["world"]))

    return sorted(priced, key=rank_key)


def ladder_configs(ladder=None) -> List[Dict]:
    """The fallback ladder's rungs as canonical configs (name preserved) —
    the planner prices exactly what the controller can walk."""
    if ladder is None:
        from ..resilience.controller import DEFAULT_LADDER

        ladder = DEFAULT_LADDER
    return [canonical_config(dict(r.overrides), name=r.name) for r in ladder]


def default_configs(calib: Optional[CostCalibration] = None) -> List[Dict]:
    """The planner's search space: every fallback-ladder rung plus the
    chunk/bucket variants the ladder does not enumerate. Bucket targets
    derive from the calibrated dense payload so they stay meaningful at
    any model size."""
    configs = ladder_configs()
    seen = {config_key(c) for c in configs}
    extras: List[Dict] = [
        {"name": "chunked-2", "comm_chunks": 2},
        {"name": "ring-4", "comm_chunks": 4, "comm_strategy": "ring"},
        {"name": "compress-r2", "reducer": "powersgd", "reducer_rank": 2},
    ]
    if calib is not None and calib.dense_bytes > 0:
        for div, tag in ((2, "halves"), (4, "quarters")):
            extras.append(
                {
                    "name": f"bucketed-{tag}",
                    "bucket_bytes": max(1, int(calib.dense_bytes // div)),
                }
            )
    for raw in extras:
        c = canonical_config(raw)
        if config_key(c) not in seen:
            seen.add(config_key(c))
            configs.append(c)
    return configs


def hierarchical_configs(
    calib: Optional[CostCalibration] = None,
    sync_everys=(4, 8, 16),
    ranks=(0, 1, 4),
    asyncs=(0, 1),
    sites: int = 0,
) -> List[Dict]:
    """The hierarchical what-if grid ``scripts/torch_plan.py --hierarchical``
    prices: sync period H x outer rank (0 = exact outer) x sync/async,
    over ``sites`` sites (0 = the model's two-site default). This is the
    planner-side search of where to cut the sites:
    the matrix's bottleneck edge prices the outer ring of every entry."""
    out: List[Dict] = []
    for sync in sync_everys:
        for rank in ranks:
            for a in asyncs:
                name = f"hier-H{sync}-r{rank}" + ("-async" if a else "")
                out.append(
                    canonical_config(
                        {
                            "name": name,
                            "reducer": "hierarchical",
                            "reducer_rank": rank,
                            "sync_every": sync,
                            "outer_async": a,
                            "sites": sites,
                        }
                    )
                )
    return out


def search(
    calib: CostCalibration,
    fabrics: Optional[List[str]] = None,
    configs: Optional[List[Dict]] = None,
    matrix: Optional[Dict] = None,
) -> Dict[str, List[Dict]]:
    """Rank every config per fabric, cheapest predicted step first."""
    model = _bandwidth.fabric_model(matrix)
    fabrics = list(fabrics or model.fabrics)
    configs = configs if configs is not None else default_configs(calib)
    return {
        fabric: sorted(
            (predict(calib, c, fabric, matrix=matrix) for c in configs),
            key=lambda p: p["predicted_step_s"],
        )
        for fabric in fabrics
    }


def build_plan(
    calib: CostCalibration,
    fabrics: Optional[List[str]] = None,
    configs: Optional[List[Dict]] = None,
    matrix: Optional[Dict] = None,
) -> Dict:
    """The tuned per-fabric plan document the launcher's ``--plan`` reads:
    per fabric the ranked predictions and the best pick, plus the
    rung-name ladder ordering ``resilience.controller.ladder_from_plan``
    reorders the fallback ladder with."""
    ranked = search(calib, fabrics=fabrics, configs=configs, matrix=matrix)
    return {
        "schema": PLAN_SCHEMA,
        "source": "observe.costmodel",
        "source_run": calib.source_run,
        "calibration": asdict(calib),
        # provenance of the ring pricing: None = scalar tables, else the
        # measured matrix's bottleneck edge gated every prediction
        "fabric_matrix": (
            {
                "per_edge": True,
                "world_size": matrix.get("world_size"),
                "bottleneck": matrix.get("bottleneck"),
            }
            if isinstance(matrix, dict) and matrix.get("edges") else None
        ),
        "fabrics": {
            fabric: {"best": preds[0], "ranked": preds}
            for fabric, preds in ranked.items()
            if preds
        },
        "ladder": {
            fabric: [
                p["config"]["name"] for p in preds if p["config"]["name"]
            ]
            for fabric, preds in ranked.items()
        },
    }


def prediction_events(
    plan: Dict, rank: Optional[int] = None
) -> List[PredictionEvent]:
    """Every plan entry as a typed event — the observatory's write side."""
    events: List[PredictionEvent] = []
    for fabric, slot in (plan.get("fabrics") or {}).items():
        for p in slot.get("ranked") or []:
            events.append(
                PredictionEvent(
                    fabric=str(fabric),
                    config_key=str(p.get("config_key", "")),
                    config=dict(p.get("config") or {}),
                    predicted_step_s=_num(p.get("predicted_step_s")),
                    predicted_bytes_per_step=_num(
                        p.get("predicted_bytes_per_step")
                    ),
                    compute_s=_num(p.get("compute_s")),
                    exposed_comm_s=_num(p.get("exposed_comm_s")),
                    latency_s=_num(p.get("latency_s")),
                    compress_s=_num(p.get("compress_s")),
                    source_run=str(plan.get("source_run") or ""),
                    rank=rank,
                )
            )
    return events


def join_realized(
    plan: Dict,
    fabric: str,
    report: Dict,
    executed_config: Optional[Dict] = None,
) -> Optional[Dict]:
    """The observatory's read side: join a plan's prediction against a
    realized run of the same config. The executed config comes from (in
    order) the explicit argument, the run's own ``CompileEvent``
    comm-config plumbing (``report["compile"]["comm_config"]``), or the
    plan's best pick for the fabric. Returns the ``costmodel`` report
    section (``error`` is the model's relative step-time error), or None when
    the run has no usable step time or the plan no such fabric."""
    slot = (plan.get("fabrics") or {}).get(fabric)
    realized_step = _num(report.get("step_p50_s"))
    if not isinstance(slot, dict) or realized_step is None or realized_step <= 0:
        return None

    if executed_config is None:
        compile_rec = (
            report.get("compile") if isinstance(report.get("compile"), dict) else {}
        )
        executed_config = compile_rec.get("comm_config") or None
    if executed_config is None:
        executed_config = (slot.get("best") or {}).get("config")
    key = config_key(executed_config or {})

    prediction = next(
        (p for p in slot.get("ranked") or [] if p.get("config_key") == key),
        None,
    )
    bw = report.get("bandwidth") if isinstance(report.get("bandwidth"), dict) else {}
    total = bw.get("total") if isinstance(bw.get("total"), dict) else {}
    realized_bytes = _num(total.get("payload_bytes"))

    out: Dict = {
        "fabric": fabric,
        "config_key": key,
        "config": canonical_config(executed_config or {}),
        "matched": prediction is not None,
        "realized_step_s": realized_step,
        "realized_bytes_per_step": realized_bytes,
        # the source run's measured step (the hand-set default the plan
        # was calibrated from): realized < this means the planner's pick
        # actually beat the default
        "default_step_s": _num(
            (plan.get("calibration") or {}).get("step_time_s")
        ),
    }
    if prediction is not None:
        pred_step = _num(prediction.get("predicted_step_s"))
        pred_bytes = _num(prediction.get("predicted_bytes_per_step"))
        out["predicted_step_s"] = pred_step
        out["predicted_bytes_per_step"] = pred_bytes
        if pred_step is not None:
            out["error"] = abs(pred_step - realized_step) / realized_step
        if pred_bytes is not None and realized_bytes and realized_bytes > 0:
            out["bytes_error"] = (
                abs(pred_bytes - realized_bytes) / realized_bytes
            )
    if out["default_step_s"]:
        out["beats_default"] = realized_step < out["default_step_s"]
    return out
