"""Multi-device engines over a mesh of shards.

Counterpart of ``gfasort_tpu/parallel/``: the path-step arrays are
sharded over a :class:`~.mesh.Mesh` (whole paths per shard, padded to
one shard length), the node positions are replicated, and the shards'
per-node sums are merged with :meth:`~.mesh.Mesh.all_reduce` — an
in-order sum over this process's shards, then ``torch.distributed``
across processes (NCCL on the card, gloo on the CPU).
"""

from .mesh import default_mesh, partition_paths  # noqa: F401
from .sgd_shard import (  # noqa: F401
    ShardedIndex,
    path_linear_sgd_sharded,
    path_sgd_sort_sharded,
)
from .sweep_shard import (  # noqa: F401
    path_linear_sgd_sweep_sharded,
    path_sgd_sort_sweep_sharded,
)
from .sweep_nd_shard import (  # noqa: F401
    path_linear_sgd_layout_sweep_sharded,
)
