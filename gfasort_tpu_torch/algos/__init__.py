"""Host-side graph algorithms (deterministic worklist passes).

These are the sequential, order-sensitive passes of the pipeline
(topological sorts, grooming, unchop).  They run on the host by design:
they are O(E) frontier/heap algorithms over irregular structures with
loop-carried dependences — exactly the shape the TPU's MXU/VPU cannot
help with — while the SGD hot loops (the actual FLOPs) run on device
(SURVEY.md §9 "Host/device split").

Each algorithm reproduces the reference's observable behavior exactly
(same emission order, same tie-breaking) but replaces the reference's
per-handle full-edge-set rescans — which make the Rust implementation
O(V·E log E) (SURVEY.md §4.4) — with an adjacency index built once and
incremental unmasked-incoming counters, giving O(E log V).
"""

from .topo import exact_odgi_topological_order, find_head_nodes, find_tail_nodes  # noqa: F401
from .priority_topo import priority_topological_order  # noqa: F401
from .groom import groom, groom_with_mode, apply_grooming_with_reorder  # noqa: F401
from .unchop import compact  # noqa: F401
from .refine import local_topological_refinement  # noqa: F401
