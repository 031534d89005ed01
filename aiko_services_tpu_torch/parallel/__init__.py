"""Device meshes, the SPMD runner and its collectives
(``parallel/mesh.py``), and context-parallel attention
(``parallel/ring.py``), as the JAX package's ``parallel`` exports them."""

from .mesh import (AXIS_ORDER, Collectives, Mesh, MeshAborted, MeshPlan, P,
                   all_gather, all_to_all, axis_index, filter_spec,
                   make_mesh, ppermute, psum, shard_map)
from .ring import (ring_attention, ulysses_attention, blockwise_attention,
                   ring_attention_sharded)

__all__ = ["AXIS_ORDER", "Collectives", "Mesh", "MeshAborted", "MeshPlan",
           "P", "all_gather", "all_to_all", "axis_index", "filter_spec",
           "make_mesh", "ppermute", "psum", "shard_map", "ring_attention",
           "ulysses_attention", "blockwise_attention",
           "ring_attention_sharded"]
