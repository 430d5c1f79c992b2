"""The data layer: deterministic cross-rank partitioning, the dataset
pipelines, batch iteration and device staging, multi-host placement and
the native (C++) loader, as the JAX package's ``data/__init__.py``
exports them."""

from .partition import (  # noqa: F401
    DataPartitioner,
    ElasticIndexStream,
    Partition,
    StreamedPermutation,
    elastic_assignments,
    partition_dataset,
    split_indices,
    streamed_elastic_assignments,
)

from .loader import device_prefetch, epoch_order, iterate_batches, steps_per_epoch  # noqa: F401
from .cifar10 import load_cifar10, load_cifar10_or_synthetic, synthetic_cifar10  # noqa: F401
from .imdb import HashTokenizer, prepare_imdb, read_imdb_split, synthetic_imdb  # noqa: F401
from .wordpiece import (  # noqa: F401
    WordPieceTokenizer,
    build_vocab,
    cached_vocab_file,
    load_vocab,
    shard_rows,
)
from .multihost import (  # noqa: F401
    global_batch_from_local,
    global_state_from_host,
    merge_tokenized_shards,
)
from ..native import NativeBatchLoader  # noqa: F401  (the C++ prefetching loader)
