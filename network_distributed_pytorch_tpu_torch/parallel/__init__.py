"""The data-parallel and model-parallel layers of the port."""

from .fsdp import FSDPState, make_fsdp_train_step, shard_params, unshard_params  # noqa: F401
