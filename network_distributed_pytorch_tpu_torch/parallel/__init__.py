"""The data-parallel and model-parallel layers of the port."""

from .fsdp import FSDPState, make_fsdp_train_step, shard_params, unshard_params  # noqa: F401
from .hierarchical import (  # noqa: F401
    CompiledHierarchical,
    HierarchicalReducer,
    HierarchicalState,
    make_hierarchical_train_fn,
)
