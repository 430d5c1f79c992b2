"""The parts of the JAX package's ``resilience/`` that the port has:

- :mod:`.chaos`: the seeded fault schedule (``ChaosPlan``) and its
  injectors into the step, the loader and the checkpoint;
- :mod:`.guards`: the recovery guards of the checkpointed training loop
  (``GuardedStep``, ``guarded_batches``, ``PreemptionGuard``), the typed
  errors and the exit codes;
- :mod:`.supervisor`: the supervising parent (spawn, watch, restart,
  degrade) and the worker side of its environment contract;
- :mod:`.reshard`: the data-axis resharding of a checkpoint at another
  world size;
- :mod:`.controller`: the fallback ladder of the degraded fabric and the
  controller that walks it from each epoch's health;
- and, for the adaptive loop and the hierarchical round, the collective
  watchdog, the deadline guard, the partition policy and the outer-sync
  driver (:mod:`.guards`) and the comm fault injector (:mod:`.chaos`).

:mod:`.scheduler` is the fleet control plane (job manifests, the job
spool, the gang scheduler with SLO-driven preemption and chip leases), and
:mod:`.supervisor` also holds the serving autoscaler that leases from it.

Nothing here imports torch at import time (the supervising parent and the
fleet scheduler import this package).
"""

from .chaos import (  # noqa: F401
    CHAOS_EXIT_CODE,
    CHECKPOINT_FAULTS,
    COMM_FAULTS,
    CORRELATED_FAULTS,
    FAULT_KINDS,
    HEALTH_FAULTS,
    INJECTION_SITES,
    LOADER_FAULTS,
    MEMORY_FAULTS,
    PROCESS_FAULTS,
    STEP_FAULTS,
    ChaosOutOfMemoryError,
    ChaosPlan,
    ChaosStep,
    ChaosTransientError,
    CommFaultInjector,
    FaultSpec,
    apply_checkpoint_fault,
    chaos_batches,
    check_fault_registry,
    make_checkpoint_unwritable,
    restore_checkpoint_writable,
)
from .controller import (  # noqa: F401
    DEFAULT_LADDER,
    EpochHealth,
    FallbackController,
    PolicyDecision,
    Rung,
    ladder_from_plan,
)
from .guards import (  # noqa: F401
    CKPT_UNWRITABLE_EXIT_CODE,
    PREEMPT_EXIT_CODE,
    CheckpointUnwritableError,
    CollectiveWatchdog,
    CommDeadlineError,
    CommDeadlineGuard,
    CommEscalationError,
    GuardedStep,
    NonFiniteLossError,
    OuterSyncDriver,
    OutOfMemoryError,
    PartitionPolicy,
    PreemptionGuard,
    StateSnapshot,
    derive_collective_deadline,
    derive_outer_deadline,
    guarded_batches,
    is_oom_error,
)
from .reshard import (  # noqa: F401
    MESH_AXES,
    RankRows,
    fold_groups,
    fold_memories,
    make_topology,
    memory_total,
    merge_model_state,
    mesh_world,
    normalize_mesh_axes,
    rescale_accum_steps,
    reshard_from_checkpoint,
    reshard_mesh_state,
    reshard_train_state,
    topology_mesh,
    widen_memories,
    widen_model_state,
    widen_template,
)
from .scheduler import (  # noqa: F401
    FleetConfig,
    FleetScheduler,
    JobManifest,
    JobSpool,
)
from .supervisor import (  # noqa: F401
    ENV_DEVICE_RANKS,
    ENV_INCARNATION,
    ENV_MESH,
    ENV_RANK,
    ENV_WORLD,
    AutoscalerConfig,
    ServingAutoscaler,
    Supervisor,
    SupervisorConfig,
    SupervisorResult,
    device_ranks_from_env,
    incarnation_from_env,
    mesh_from_env,
    plan_mesh,
)
