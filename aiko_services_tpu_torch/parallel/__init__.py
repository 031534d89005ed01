"""Device meshes, the SPMD runner and its collectives
(``parallel/mesh.py``; across processes ``parallel/distributed.py``),
and context-parallel attention
(``parallel/ring.py``), as the JAX package's ``parallel`` exports them."""

from .mesh import (AXIS_ORDER, Collectives, Keep, Mesh, MeshAborted,
                   MeshPlan, NamedSharding, P, Placed, all_gather,
                   all_to_all, axis_index, device_inventory,
                   donate_argnums_supported, filter_spec, filter_specs,
                   inventory_tags, make_mesh, ppermute, psum, remat,
                   shard_map, submesh, virtual_cpu_devices)
from .ring import (ring_attention, ulysses_attention, blockwise_attention,
                   ring_attention_sharded)

__all__ = ["AXIS_ORDER", "Collectives", "Keep", "Mesh", "MeshAborted",
           "MeshPlan", "NamedSharding", "P", "Placed", "all_gather",
           "all_to_all", "axis_index", "filter_spec", "filter_specs",
           "make_mesh", "ppermute", "psum", "remat", "shard_map",
           "submesh", "device_inventory", "donate_argnums_supported",
           "inventory_tags", "virtual_cpu_devices", "ring_attention", "ulysses_attention",
           "blockwise_attention", "ring_attention_sharded"]
