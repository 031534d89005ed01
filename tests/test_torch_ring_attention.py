"""Port twins of ``test_ring_attention.py``: the port's blockwise, ring
and Ulysses attention (``aiko_services_tpu_torch/parallel/ring.py``) on
CPU positions of a port mesh, against the JAX package's functions on its
8-virtual-device mesh, on the same numpy-seeded inputs.

Tolerances: 1e-5 for float32 attention (the two differ in summation
order only); the bf16 ring within one bf16 step of outputs below 4 in
magnitude (2**-6: both compute float32 statistics from exact bf16
products and round the output once), and within the JAX test's 6e-2 of
dense attention."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.ops import attention_prefill as jax_dense
from aiko_services_tpu.parallel import make_mesh as jax_make_mesh
from aiko_services_tpu.parallel import ring as jring
from aiko_services_tpu_torch.ops.layers import attention_prefill
from aiko_services_tpu_torch.parallel import make_mesh
from aiko_services_tpu_torch.parallel import ring as tring

B, S, H, D = 2, 32, 4, 16
F32_TOL = 1e-5
BF16_STEP = 2.0 ** -6
BF16_DENSE_TOL = 6e-2


def port_mesh(axes: dict):
    count = int(np.prod(list(axes.values())))
    return make_mesh(axes, [torch.device("cpu", i) for i in range(count)])


def jax_mesh(axes: dict):
    count = int(np.prod(list(axes.values())))
    return jax_make_mesh(axes, jax.devices()[:count])


@pytest.fixture(scope="module")
def qkv():
    """(q, k, v, positions) as numpy, and JAX's dense attention."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    positions = np.broadcast_to(np.arange(S)[None, :], (B, S)).copy()
    dense = np.asarray(jax_dense(q, k, v, positions))
    return q, k, v, positions, dense


def torch_args(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def close(got: torch.Tensor, want, tol: float = F32_TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32), atol=tol)


def test_blockwise_matches_dense(qkv):
    q, k, v, positions, dense = qkv
    want = jring.blockwise_attention(q, k, v, positions, block_size=8)
    got = tring.blockwise_attention(*torch_args(q, k, v, positions),
                                    block_size=8)
    close(got, want)
    close(got, dense)


def test_blockwise_ragged_tail(qkv):
    """T not divisible by block_size exercises the pad/mask path."""
    q, k, v, positions, dense = qkv
    want = jring.blockwise_attention(q, k, v, positions, block_size=7)
    got = tring.blockwise_attention(*torch_args(q, k, v, positions),
                                    block_size=7)
    close(got, want)
    close(got, dense)


def test_blockwise_offset_positions():
    """Chunked-prefill shape: queries begin mid-cache (start offset)."""
    rng = np.random.default_rng(1)
    t = 24
    q = rng.standard_normal((1, 8, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((1, t, H, D)).astype(np.float32)
            for _ in range(2))
    q_pos = np.arange(16, 24)[None, :]
    kv_pos = np.arange(t)[None, :]
    want = jring.blockwise_attention(q, k, v, q_pos, kv_pos, block_size=5)
    got = tring.blockwise_attention(*torch_args(q, k, v, q_pos, kv_pos),
                                    block_size=5)
    close(got, want)
    close(got, attention_prefill(*torch_args(q, k, v, q_pos)))


def test_ring_matches_dense(qkv):
    q, k, v, positions, dense = qkv
    want = jring.ring_attention(q, k, v, positions, jax_mesh({"sp": 4}))
    got = tring.ring_attention(*torch_args(q, k, v, positions),
                               port_mesh({"sp": 4}))
    close(got, want)
    close(got, dense)


def test_ring_full_axis(qkv):
    q, k, v, positions, dense = qkv
    want = jring.ring_attention(q, k, v, positions, jax_mesh({"sp": 8}))
    got = tring.ring_attention(*torch_args(q, k, v, positions),
                               port_mesh({"sp": 8}))
    close(got, want)
    close(got, dense)


def test_ring_jits(qkv):
    """JAX's jitted ring against the port's ring bound into a closure the
    same way and called twice (the port runs eagerly: no trace to reuse,
    the same result each call)."""
    q, k, v, positions, dense = qkv
    jmesh = jax_mesh({"sp": 4})
    want = jax.jit(lambda *a: jring.ring_attention(*a, mesh=jmesh))(
        q, k, v, positions)
    mesh = port_mesh({"sp": 4})
    ring = lambda *a: tring.ring_attention(*a, mesh=mesh)    # noqa: E731
    args = torch_args(q, k, v, positions)
    first, second = ring(*args), ring(*args)
    assert torch.equal(first, second)
    close(first, want)
    close(first, dense)


def test_ulysses_matches_dense(qkv):
    q, k, v, positions, dense = qkv
    want = jring.ulysses_attention(q, k, v, positions, jax_mesh({"sp": 4}))
    got = tring.ulysses_attention(*torch_args(q, k, v, positions),
                                  port_mesh({"sp": 4}))
    close(got, want)
    close(got, dense)


def test_ulysses_rejects_indivisible_heads(qkv):
    q, k, v, positions, _ = qkv
    with pytest.raises(ValueError):
        jring.ulysses_attention(q, k, v, positions, jax_mesh({"sp": 8}))
    with pytest.raises(ValueError, match="divisible"):
        tring.ulysses_attention(*torch_args(q, k, v, positions),
                                port_mesh({"sp": 8}))


def test_ring_bfloat16(qkv):
    q, k, v, positions, _ = qkv
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = jring.ring_attention(jq, jk, jv, positions, jax_mesh({"sp": 4}))
    dense = jax_dense(jq, jk, jv, positions)
    tq, tk, tv = (x.to(torch.bfloat16) for x in torch_args(q, k, v))
    got = tring.ring_attention(tq, tk, tv, torch.from_numpy(positions),
                               port_mesh({"sp": 4}))
    assert got.dtype == torch.bfloat16
    close(got, np.asarray(want.astype(jnp.float32)), BF16_STEP)
    close(got, np.asarray(dense.astype(jnp.float32)), BF16_DENSE_TOL)
