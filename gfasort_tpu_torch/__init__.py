"""gfasort_tpu_torch — the PyTorch/CUDA port of gfasort_tpu.

The JAX package ``gfasort_tpu`` stays the reference; this package
imports nothing of it.  It carries its own copies of the host layers
(graph, index, params, io, algos, trace, the exact oracle and its C++
twin in :mod:`.native`, the sweep policy) and ports the device side:
the 1D offset-sweep engine (:mod:`.ops.sweep`), the nD layout sweep
engine (:mod:`.ops.sweep_nd`), their sampler (hash or threefry draws,
f32 or f64) and node consensus, the bucket-apply kernels written by
hand in CUDA C++ for Hopper (``csrc/bucket_apply.cu``,
``csrc/dense_apply_nd.cu``), the batched engine (:mod:`.ops.sgd`)
with its checkpointed form (:mod:`.checkpoint`), and the multi-device
engines over a mesh of shards (:mod:`.parallel`).  It imports ``torch``
and never ``jax``.  Entry points:
:func:`.pipeline.run_pipeline`, ``python -m gfasort_tpu_torch`` (with
``--server``, the warm process of :mod:`.server`) and :mod:`.entry`.

The names below are the JAX package's top-level names, from the port's
host copies; none of them imports ``torch``, so ``import
gfasort_tpu_torch`` stays cheap for the ``--server`` client.
"""

from .graph import BiPath, BidirectedGraph
from .index import PathIndex
from .io.layout_tsv import Layout
from .params import LayoutSGDParams, PathSGDParams, YgsParams

__version__ = "0.1.0"

__all__ = [
    "BiPath",
    "BidirectedGraph",
    "PathIndex",
    "Layout",
    "PathSGDParams",
    "LayoutSGDParams",
    "YgsParams",
]
