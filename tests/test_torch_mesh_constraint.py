"""``MeshPlan.constraint`` in the port against the JAX package's
(``jax.lax.with_sharding_constraint``) on the eight virtual CPU devices:
each position's shard equal to the JAX array's shard on the device at
the same position of the mesh, over ``P("dp")`` and ``P(None, "tp")``;
a ``Placed`` tree resharded, or returned as it is when already laid
out so."""

import jax
import numpy as np
import pytest
import torch

from aiko_services_tpu.parallel import MeshPlan as JaxMeshPlan
from aiko_services_tpu.parallel import make_mesh as jax_make_mesh

from aiko_services_tpu_torch.parallel import MeshPlan, P, Placed, make_mesh

AXES = {"dp": 2, "tp": 4}
SPECS = {"dp": ("dp",), "tp": (None, "tp")}


def plans() -> tuple:
    return (JaxMeshPlan(jax_make_mesh(AXES, jax.devices()[:8])),
            MeshPlan(make_mesh(AXES, [torch.device("cpu", index)
                                      for index in range(8)])))


def jax_shards(array, mesh) -> list:
    """The JAX array's shard at each position of ``mesh``."""
    by_device = {shard.device: np.asarray(shard.data)
                 for shard in array.addressable_shards}
    return [by_device[device] for device in mesh.devices.flat]


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_constraint_shards_match_jax(spec):
    jax_plan, plan = plans()
    value = np.random.default_rng(0).standard_normal((8, 16)).astype(
        np.float32)
    theirs = jax_plan.constraint(jax.numpy.asarray(value),
                                 *SPECS[spec])
    ours = plan.constraint(torch.from_numpy(value), *SPECS[spec])
    assert isinstance(ours, Placed)
    assert ours.sharding == plan.shard(*SPECS[spec])
    want = jax_shards(theirs, jax_plan.mesh)
    assert len(ours.shards) == len(want) == 8
    for got, expected in zip(ours.shards, want):
        np.testing.assert_array_equal(got.numpy(), expected)


def test_constraint_reshards_a_placed_tree():
    _, plan = plans()
    value = torch.arange(128.0).reshape(8, 16)
    by_dp = plan.constraint(value, P("dp"))
    assert plan.constraint(by_dp, P("dp")) is by_dp
    by_tp = plan.constraint(by_dp, P(None, "tp"))
    assert by_tp.sharding == plan.shard(P(None, "tp"))
    torch.testing.assert_close(plan.gather(by_tp), value, rtol=0, atol=0)
