"""Device meshes of the port: ``make_mesh`` and ``MeshPlan`` only; the
rest of the JAX package's ``parallel`` waits for ROADMAP Queue 1
item 7."""

from .mesh import AXIS_ORDER, Mesh, MeshPlan, make_mesh

__all__ = ["AXIS_ORDER", "Mesh", "MeshPlan", "make_mesh"]
