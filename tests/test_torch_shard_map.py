"""The port's mesh runner (``aiko_services_tpu_torch/parallel/mesh.py``):
``P`` and ``filter_spec``, ``shard_map`` and its collectives against the
JAX package's ``shard_map`` with ``jax.lax``'s collectives on its
8-virtual-device mesh, on the same numpy inputs; gradients through every
collective against ``jax.grad``; a mesh that lists one device at four
positions; and a position that fails or returns early, which makes the
call raise instead of hang.

The inputs are small integers in float32, so every sum is exact and the
two sides agree bit for bit; gradients likewise."""

import gc
import threading
import weakref

import jax
import numpy as np
import pytest
import torch

from aiko_services_tpu.parallel import MeshPlan as JaxPlan
from aiko_services_tpu.parallel import make_mesh as jax_make_mesh
from aiko_services_tpu.parallel.mesh import P as JP
from aiko_services_tpu.parallel.mesh import shard_map as jax_shard_map
from aiko_services_tpu.parallel.ring import ring_attention as jax_ring
from aiko_services_tpu_torch.parallel import (MeshAborted, MeshPlan, P,
                                              all_gather, all_to_all,
                                              axis_index, filter_spec,
                                              make_mesh, ppermute, psum,
                                              remat, ring_attention,
                                              shard_map)

AXES = {"dp": 2, "sp": 4}
CALL_LIMIT_S = 30.0


def meshes(axes=AXES):
    count = int(np.prod(list(axes.values())))
    return (jax_make_mesh(axes, jax.devices()[:count]),
            make_mesh(axes, [torch.device("cpu", i) for i in range(count)]))


def integers(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(-8, 8, shape) \
        .astype(np.float32)


RING = [(j, (j + 1) % 4) for j in range(4)]
# name -> (jax body, port body, out spec entries)
COLLECTIVES = {
    "ppermute-ring": (lambda x: jax.lax.ppermute(x, "sp", RING),
                      lambda x: ppermute(x, "sp", RING), ("dp", "sp")),
    "ppermute-partial": (lambda x: jax.lax.ppermute(x, "sp", [(0, 2)]),
                         lambda x: ppermute(x, "sp", [(0, 2)]),
                         ("dp", "sp")),
    "all_to_all": (lambda x: jax.lax.all_to_all(x, "sp", 2, 1, tiled=True),
                   lambda x: all_to_all(x, "sp", split_axis=2,
                                        concat_axis=1), ("dp", "sp")),
    "all_gather": (lambda x: jax.lax.all_gather(x, "sp", axis=1,
                                                tiled=True),
                   lambda x: all_gather(x, "sp", axis=1), ("dp", None)),
    "psum-sp": (lambda x: jax.lax.psum(x, "sp"),
                lambda x: psum(x, "sp"), ("dp", None)),
    "psum-dp-sp": (lambda x: jax.lax.psum(x, ("dp", "sp")),
                   lambda x: psum(x, ("dp", "sp")), (None, None)),
    "axis_index": (lambda x: x * jax.lax.axis_index("sp")
                   + 10 * jax.lax.axis_index(("dp", "sp")),
                   lambda x: x * axis_index("sp")
                   + 10 * axis_index(("dp", "sp")), ("dp", "sp")),
}


def run_both(name: str, x: np.ndarray):
    jbody, tbody, out = COLLECTIVES[name]
    jmesh, mesh = meshes()
    want = jax_shard_map(jbody, jmesh, in_specs=(JP("dp", "sp"),),
                         out_specs=JP(*out), check=False)(x)
    tensor = torch.from_numpy(x).requires_grad_(True)
    got = shard_map(tbody, mesh, in_specs=(P("dp", "sp"),),
                    out_specs=P(*out))(tensor)
    return want, got, tensor


@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collective_matches_jax(name):
    x = integers((4, 16, 8))
    want, got, _ = run_both(name, x)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collective_gradient_matches_jax(name):
    """d/dx of sum(w * collective(x)) on both sides: every collective
    passes its cotangent back to the positions it read from."""
    x = integers((4, 16, 8))
    jbody, _, out = COLLECTIVES[name]
    jmesh, _ = meshes()
    want_out, got, tensor = run_both(name, x)
    weights = integers(np.asarray(want_out).shape, seed=1)

    def jax_loss(value):
        return (jax_shard_map(jbody, jmesh, in_specs=(JP("dp", "sp"),),
                              out_specs=JP(*out), check=False)(value)
                * weights).sum()
    want = jax.jit(jax.grad(jax_loss))(x)
    (got * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_array_equal(tensor.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("spec", [P("dp", "tp"), P(("dp", "fsdp"), "sp"),
                                  P(None, ("fsdp", "tp")), P("ep"), P()])
def test_filter_spec_matches_jax(spec):
    mesh = make_mesh({"dp": 2, "tp": 4}, [torch.device("cpu")] * 8)
    jplan = JaxPlan(jax_make_mesh({"dp": 2, "tp": 4}, jax.devices()[:8]))
    want = jplan._filter_spec(JP(*spec))
    assert tuple(filter_spec(mesh, spec)) == tuple(want)
    assert tuple(MeshPlan(mesh)._filter_spec(spec)) == tuple(want)


def test_one_device_at_four_positions():
    """A mesh listing one device four times: four shards, every hop run,
    the result equal to four distinct positions' and to JAX's ring; the
    stage-placement view of it is that one device."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 16, 2, 8)).astype(np.float32)
               for _ in range(3))
    positions = np.arange(16)[None, :]
    one = make_mesh({"sp": 4}, [torch.device("cpu")] * 4)
    assert one.shape == {"sp": 4}
    assert list(one.devices.flat) == [torch.device("cpu")] * 4
    plan = MeshPlan(one)
    assert plan.replicated() == plan.device == torch.device("cpu")
    args = [torch.from_numpy(a) for a in (q, k, v, positions)]
    seen = []

    def where(x):
        seen.append((axis_index("sp"), x.shape[1]))
        return ppermute(x, "sp", RING)
    shard_map(where, one, in_specs=(P(None, "sp"),),
              out_specs=P(None, "sp"))(args[0])
    assert sorted(seen) == [(i, 4) for i in range(4)]
    got = ring_attention(*args, one)
    _, distinct = meshes({"sp": 4})
    assert torch.equal(got, ring_attention(*args, distinct))
    jmesh, _ = meshes({"sp": 4})
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_ring(q, k, v, positions,
                                                   jmesh)), atol=1e-5)


def call_bounded(fn, *args):
    """``fn(*args)`` on a thread, joined within CALL_LIMIT_S; returns its
    exception (None if it returned)."""
    outcome = {}

    def target():
        try:
            fn(*args)
            outcome["error"] = None
        except Exception as error:       # the assertion reads it
            outcome["error"] = error
    caller = threading.Thread(target=target, daemon=True)
    caller.start()
    caller.join(CALL_LIMIT_S)
    assert not caller.is_alive(), "the call hung"
    return outcome["error"]


def test_position_failure_aborts_the_call():
    """Position 5 raises while the others wait in a psum: the call
    raises position 5's error, and every position's thread has ended."""
    _, mesh = meshes()

    def body(x):
        if axis_index(("dp", "sp")) == 5:
            raise ZeroDivisionError("position 5 fails")
        return psum(x, ("dp", "sp"))
    error = call_bounded(shard_map(body, mesh, in_specs=(P("dp", "sp"),),
                                   out_specs=P()),
                         torch.ones(4, 8))
    assert isinstance(error, ZeroDivisionError)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("shard_map-")]


def test_position_returning_early_raises():
    """A position that returns without joining its group's collective
    fails the waiters instead of leaving them blocked."""
    _, mesh = meshes()

    def body(x):
        if axis_index("sp") == 3:
            return x
        return psum(x, "sp")
    error = call_bounded(shard_map(body, mesh, in_specs=(P("dp", "sp"),),
                                   out_specs=P("dp", "sp")),
                         torch.ones(4, 8))
    assert isinstance(error, RuntimeError)
    assert not isinstance(error, MeshAborted)
    assert "returned without joining" in str(error)


def test_collective_outside_shard_map_raises():
    with pytest.raises(RuntimeError, match="outside shard_map"):
        psum(torch.ones(2), "sp")


def test_remat_frees_its_tensors_after_the_backward_pass():
    """A ``remat`` node holds its positions' arguments and results only
    as long as the graph: once the backward pass ran and the loss is
    gone, no tensor made inside the mapped function stays alive."""
    _, mesh = meshes({"dp": 2})
    made = []

    def body(w, x):
        h = w * 2.0
        y = remat(lambda h, x: torch.tanh(h * x), h, x)
        made.extend([weakref.ref(h), weakref.ref(y)])
        return psum(y.sum(), "dp")
    w = torch.ones(8, requires_grad=True)
    x = torch.from_numpy(integers((2, 8)))
    loss = shard_map(body, mesh, in_specs=(P(), P("dp")),
                     out_specs=P())(w, x)
    loss.backward()
    assert w.grad is not None and torch.isfinite(w.grad).all()
    del loss
    gc.collect()
    assert len(made) == 4
    assert all(ref() is None for ref in made)
