"""The parts of the JAX package's ``resilience/`` that the port has: which
life of a supervised worker is running (:mod:`.supervisor`), the recovery
guards of the checkpointed training loop (:mod:`.guards`: the
``PreemptionGuard``, the typed errors and the exit codes) and the
data-axis resharding of a checkpoint at another world size
(:mod:`.reshard`). The supervisor itself, the chaos plan, ``GuardedStep``
and the controller are not ported yet (ROADMAP.md §A item 4)."""

from .guards import (  # noqa: F401
    CKPT_UNWRITABLE_EXIT_CODE,
    PREEMPT_EXIT_CODE,
    CheckpointUnwritableError,
    NonFiniteLossError,
    PreemptionGuard,
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
from .supervisor import ENV_INCARNATION, incarnation_from_env  # noqa: F401
