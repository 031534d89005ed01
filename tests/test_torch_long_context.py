"""Port twins of ``test_long_context.py``: the port's context-parallel
Llama forward (``aiko_services_tpu_torch/models/long_context.py``) on
CPU positions of a port mesh, against the JAX package's on its
8-virtual-device mesh, the JAX parameters carried over through
``models/bridge.py`` and the same numpy-seeded tokens; plus the loss
gradient against ``jax.grad``.

Tolerances: ``LlamaConfig.tiny`` in bf16 (the JAX test's config) within
the JAX test's own atol 0.15 / rtol 0.05 of the other side -- bf16
activations through two layers, each side rounding its products and
norms in its own order; the same config in float32 within 1e-4 of the
JAX logits (summation order only), the loss within 1e-5 and each
gradient leaf within 1e-4 of its largest magnitude."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import llama as jl
from aiko_services_tpu.models import long_context as jlc
from aiko_services_tpu.parallel import MeshPlan as JaxPlan
from aiko_services_tpu.parallel import make_mesh as jax_make_mesh
from aiko_services_tpu_torch.models import bridge
from aiko_services_tpu_torch.models import llama as tl
from aiko_services_tpu_torch.models import long_context as tlc
from aiko_services_tpu_torch.models.checkpoint import flatten
from aiko_services_tpu_torch.parallel import MeshPlan, make_mesh

BF16_ATOL, BF16_RTOL = 0.15, 0.05
F32_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def plans(axes: dict) -> tuple[JaxPlan, MeshPlan]:
    count = int(np.prod(list(axes.values())))
    return (JaxPlan(jax_make_mesh(axes, jax.devices()[:count])),
            MeshPlan(make_mesh(axes, [torch.device("cpu", i)
                                      for i in range(count)])))


def configs(dtype: str):
    return (dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=128,
                                                    max_seq=64), dtype=dtype),
            dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=128,
                                                    max_seq=64), dtype=dtype))


def bridged(jax_params, config) -> dict:
    """The JAX tree on the port, bf16 leaves bit for bit."""
    def leaf(array):
        array = np.asarray(array)
        if array.dtype == jnp.bfloat16:
            return array.view(np.uint16), "bfloat16"
        return array
    return bridge.params_from_numpy(jax.tree_util.tree_map(leaf, jax_params),
                                    config, device="cpu")


@pytest.fixture(scope="module", params=["bfloat16", "float32"])
def setup(request):
    jc, tc = configs(request.param)
    params = jl.init_params(jax.random.PRNGKey(0), jc)
    tokens = np.random.default_rng(1).integers(
        0, jc.vocab_size, (2, 32)).astype(np.int32)
    cache = tl.init_cache(tc, 2, 32, device="cpu")
    ours = bridged(params, tc)
    dense, _ = tl.prefill(ours, tc, torch.from_numpy(tokens), cache,
                          torch.zeros(2, dtype=torch.int32))
    return jc, tc, params, ours, tokens, dense.float().numpy()


def assert_twin(got: torch.Tensor, want, dense, dtype: str):
    got = got.float().numpy()
    want = np.asarray(want, dtype=np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_TOL)
        np.testing.assert_allclose(got, dense, atol=F32_TOL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL,
                                   rtol=BF16_RTOL)
        np.testing.assert_allclose(got, dense, atol=BF16_ATOL,
                                   rtol=BF16_RTOL)


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_cp_forward_matches_dense(setup, attention):
    jc, tc, params, ours, tokens, dense = setup
    jplan, plan = plans({"sp": 4})
    want = jlc.make_long_context_forward(jc, jplan, attention)(params,
                                                               tokens)
    got = tlc.make_long_context_forward(tc, plan, attention)(
        ours, torch.from_numpy(tokens))
    assert got.shape == (2, 32, tc.vocab_size)
    assert_twin(got, want, dense, tc.dtype)


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
@pytest.mark.parametrize("axes", [{"dp": 2, "sp": 2, "tp": 2},
                                  {"fsdp": 2, "sp": 2, "tp": 2}],
                         ids=["dp-sp-tp", "fsdp-sp-tp"])
def test_cp_forward_mixed_mesh(setup, axes, attention):
    """sp composed with dp (or fsdp) and tp on one mesh."""
    jc, tc, params, ours, tokens, dense = setup
    jplan, plan = plans(axes)
    want = jlc.make_long_context_forward(jc, jplan, attention)(params,
                                                               tokens)
    got = tlc.make_long_context_forward(tc, plan, attention)(
        ours, torch.from_numpy(tokens))
    assert_twin(got, want, dense, tc.dtype)


def test_cp_requires_sp_axis(setup):
    jc, tc, *_ = setup
    jplan, plan = plans({"dp": 8})
    with pytest.raises(ValueError):
        jlc.make_long_context_forward(jc, jplan)
    with pytest.raises(ValueError, match="no 'sp' axis"):
        tlc.make_long_context_forward(tc, plan)


def jax_flat(tree) -> dict:
    return {".".join(str(key.key) for key in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_cp_loss_gradient_matches_jax(attention):
    """``make_long_context_loss`` over {"sp": 4} in float32: the loss and
    every parameter's gradient against ``jax.grad`` of the JAX loss."""
    jc, tc = configs("float32")
    params = jl.init_params(jax.random.PRNGKey(0), jc)
    tokens = np.random.default_rng(2).integers(
        0, jc.vocab_size, (2, 32)).astype(np.int32)
    jplan, plan = plans({"sp": 4})
    jloss = jlc.make_long_context_loss(jc, jplan, attention)
    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params,
                                                               tokens)

    ours = bridged(params, tc)
    leaves = flatten(ours)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    loss = tlc.make_long_context_loss(tc, plan, attention)(
        ours, torch.from_numpy(tokens))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= LOSS_TOL
    want = jax_flat(want_grads)
    assert set(leaves) == set(want)
    for name, leaf in leaves.items():
        scale = max(np.abs(want[name]).max(), 1e-12)
        error = np.abs(leaf.grad.double().numpy() - want[name]).max()
        assert error <= GRAD_TOL * scale, (name, error, scale)
