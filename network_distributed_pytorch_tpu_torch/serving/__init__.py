"""serving: continuous-batching inference over the GPT decoder, the JAX
package's ``serving/`` on torch.

- :mod:`serving.engine`: ``SlotEngine`` (a dense slot-batched KV cache,
  one decode step a tick shared by requests at different depths, freed
  slots refilled from the queue after every tick) and ``PagedEngine`` (the
  same scheduler over a block pool: copy-on-write prefix sharing and
  speculative decoding), with ``spec_accept`` and
  ``padded_static_decode_steps``.
- :mod:`serving.blocks`: the host side of paging, the refcounted block
  allocator (``BlockPool``) and the prompt-hash prefix index
  (``PrefixIndex``).
- :mod:`serving.request`: the typed request lifecycle, emitted as one
  terminal ``observe.RequestEvent`` a request.
- :mod:`serving.cache`: the slot cache and the block pool.
- :mod:`serving.frontend`: Poisson workloads, wall-clock replay, the
  file-spool queue and the SLO summary.

This ``__init__`` exports the names of the host half (request and
frontend), as the JAX package's does; import ``serving.engine`` and
``serving.cache`` for the engines.
"""

from .frontend import (  # noqa: F401
    BurnEscalator,
    FileSpool,
    WorkloadConfig,
    poisson_workload,
    replay,
    serve_from_spool,
    slo_summary,
)
from .request import (  # noqa: F401
    DECODING,
    EVICTED,
    FAILED,
    FINISHED,
    PREFILLING,
    QUEUED,
    TERMINAL_STATES,
    LifecycleError,
    Request,
)
