"""Port parity for ``models/train.py``: the loss, its gradients and the
AdamW step against the JAX package's ``language_model_loss`` /
``init_train_state`` / ``make_train_step`` on ``LlamaConfig.tiny`` in
float32, from the same initial weights (the JAX tree bridged through
numpy, the port's moments zero).  Tolerances: losses within 1e-5,
gradients and updated parameters within 1e-4 of each leaf's largest
magnitude.  Plus the twins of ``test_models.py``'s training tests
(``test_sharded_train_step``, ``test_remat_training_matches_and_
microbatching_averages``) on the port's one device, and a step over a
plan of two positions against the one-device step (the sharded step's
own twins, on {"dp": 2, "fsdp": 2, "tp": 2}, are in
``test_torch_sharded_step.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import llama as jl
from aiko_services_tpu.models import train as jt
from aiko_services_tpu.parallel import MeshPlan as JaxPlan
from aiko_services_tpu_torch.models import bridge
from aiko_services_tpu_torch.models import llama as tl
from aiko_services_tpu_torch.models import train as tt
from aiko_services_tpu_torch.models.checkpoint import flatten
from aiko_services_tpu_torch.parallel.mesh import MeshPlan

LOSS_TOL = 1e-5         # f32 losses: summation order only
REL_TOL = 1e-4          # f32 gradients and updated parameters, of max |leaf|


def cpu_plan() -> MeshPlan:
    return MeshPlan.build({"dp": 1}, devices=[torch.device("cpu")])


def jax_plan() -> JaxPlan:
    return JaxPlan.build({"dp": 1}, devices=jax.devices()[:1])


def configs(preset: str = "tiny", **overrides):
    base = dict(dtype="float32", **overrides)
    return (dataclasses.replace(getattr(jl.LlamaConfig, preset)(
                vocab_size=128, max_seq=64), **base),
            dataclasses.replace(getattr(tl.LlamaConfig, preset)(
                vocab_size=128, max_seq=64), **base))


def batch(shape=(4, 16), seed=3, vocab=128) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def to_port(jax_tree, config) -> dict:
    return bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jax_tree), config, device="cpu")


def jax_flat(tree) -> dict:
    """JAX tree -> {"a.b": numpy}, the port's ``flatten`` names."""
    return {".".join(str(key.key) for key in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_leaves_close(ours: dict, theirs: dict, tol: float = REL_TOL):
    assert set(ours) == set(theirs)
    for name, leaf in ours.items():
        want = theirs[name].astype(np.float64)
        got = leaf.detach().double().numpy()
        scale = max(np.abs(want).max(), 1e-12)
        assert np.abs(got - want).max() <= tol * scale, name


def trainable(params) -> list:
    """``params``' leaves, marked to require grad (a bridged tree's are
    not)."""
    leaves = tt._leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    return leaves


def port_grads(params, config, tokens):
    leaves = trainable(params)
    loss = tt.language_model_loss(params, config, torch.from_numpy(tokens))
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(flatten(params), grads))


@pytest.mark.parametrize("preset,overrides", [
    ("tiny", {}), ("tiny", {"kv_dtype": "int8"}), ("tiny_moe", {})],
    ids=["dense", "int8-kv", "moe"])
def test_language_model_loss_and_grads_match_jax(preset, overrides):
    jc, tc = configs(preset, **overrides)
    jp = jl.init_params(jax.random.PRNGKey(0), jc)
    tokens = batch()
    want_loss, want_grads = jax.value_and_grad(jt.language_model_loss)(
        jp, jc, jnp.asarray(tokens))
    loss, grads = port_grads(to_port(jp, tc), tc, tokens)
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL
    assert_leaves_close(grads, jax_flat(want_grads))


def jax_steps(jc, tokens, steps: int, accumulate: int = 1):
    params, opt_state, optimizer = jt.init_train_state(
        jax.random.PRNGKey(0), jc, jax_plan())
    start = jax.tree_util.tree_map(np.asarray, params)
    step = jt.make_train_step(jc, jax_plan(), optimizer=optimizer,
                              accumulate_steps=accumulate)
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, jnp.asarray(tokens))
        losses.append(float(loss))
    return start, params, losses


def port_steps(tc, start, tokens, steps: int, accumulate: int = 1):
    params = bridge.params_from_numpy(start, tc, device="cpu")
    step = tt.make_train_step(tc, cpu_plan(), accumulate_steps=accumulate)
    opt_state, losses = tt.adamw()(trainable(params)), []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state,
                                       torch.from_numpy(tokens))
        losses.append(float(loss))
    return params, losses


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("preset,overrides,accumulate", [
    ("tiny", {}, 1), ("tiny", {"remat": True}, 1), ("tiny", {}, 2)],
    ids=["plain", "remat", "accumulate-2"])
def test_adamw_steps_match_jax(preset, overrides, accumulate, steps):
    """One and two steps from the same init: the losses and every
    updated parameter equal the JAX package's (optax adamw at its
    defaults, weight decay 1e-4; accumulation in float32 over
    interleaved microbatches)."""
    jc, tc = configs(preset, **overrides)
    tokens = batch()
    start, want, want_losses = jax_steps(jc, tokens, steps, accumulate)
    params, losses = port_steps(tc, start, tokens, steps, accumulate)
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=LOSS_TOL)
    assert_leaves_close(flatten(params), jax_flat(want))


def test_remat_gives_the_same_loss_and_grads():
    _, tc = configs()
    _, tc_remat = configs(remat=True)
    jp = jl.init_params(jax.random.PRNGKey(0), configs()[0])
    tokens = batch()
    loss, grads = port_grads(to_port(jp, tc), tc, tokens)
    loss_remat, grads_remat = port_grads(to_port(jp, tc_remat), tc_remat,
                                         tokens)
    assert abs(float(loss) - float(loss_remat)) <= LOSS_TOL
    assert_leaves_close(grads_remat, {name: grad.numpy()
                                      for name, grad in grads.items()})


def test_step_updates_in_place_and_returns_the_same_dict():
    _, tc = configs()
    params, opt_state, optimizer = tt.init_train_state(0, tc, cpu_plan())
    assert isinstance(opt_state, torch.optim.AdamW)
    assert opt_state.defaults["weight_decay"] == 1e-4
    before = params["layers"]["wq"].detach().clone()
    pointer = params["layers"]["wq"].data_ptr()
    step = tt.make_train_step(tc, cpu_plan(), optimizer=optimizer)
    out, state, loss = step(params, opt_state, torch.from_numpy(batch()))
    assert out is params and state is opt_state
    assert params["layers"]["wq"].data_ptr() == pointer
    assert not torch.equal(params["layers"]["wq"].detach(), before)
    assert loss.dtype == torch.float32 and not loss.requires_grad
    assert all(leaf.grad is None for leaf in tt._leaves(params))


def test_accumulate_rejects_a_batch_that_does_not_divide():
    _, tc = configs()
    params, opt_state, _ = tt.init_train_state(0, tc, cpu_plan())
    step = tt.make_train_step(tc, cpu_plan(), accumulate_steps=3)
    with pytest.raises(ValueError, match="not divisible"):
        step(params, opt_state, torch.from_numpy(batch()))


def test_plan_over_two_cards_raises():
    """A plan of two positions (two CPU descriptors standing for two
    cards) no longer raises: ``init_train_state`` places the tree, equal
    leaf for leaf to ``put`` of ``init_params``, and a step equals the
    one-device step (loss and updated parameters)."""
    _, tc = configs()
    plan = MeshPlan.build({"dp": 2}, devices=[torch.device("cpu", 0),
                                              torch.device("cpu", 1)])
    params, opt_state, _ = tt.init_train_state(0, tc, plan)
    want = plan.put(tl.init_params(0, tc, device="cpu"),
                    tl.partition_specs(tc))
    for got, expected in zip(params.tensors(), want.tensors()):
        assert torch.equal(got.detach(), expected)
    one, state, _ = tt.init_train_state(0, tc, cpu_plan())
    tokens = torch.from_numpy(batch())
    params, _, loss = tt.make_train_step(tc, plan)(params, opt_state,
                                                   tokens)
    one, _, want_loss = tt.make_train_step(tc, cpu_plan())(one, state,
                                                           tokens)
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL
    assert_leaves_close(flatten(plan.gather(params)),
                        {name: leaf.detach().numpy()
                         for name, leaf in flatten(one).items()})


# -- twins of test_models.py's training tests, on one device -----------------

def test_sharded_train_step():
    """Twin of ``test_models.py::test_sharded_train_step`` (bf16 tiny):
    the step learns the batch."""
    config = tl.LlamaConfig.tiny()
    params, opt_state, optimizer = tt.init_train_state(0, config,
                                                       cpu_plan())
    step = tt.make_train_step(config, cpu_plan(), optimizer=optimizer)
    tokens = torch.from_numpy(batch(vocab=config.vocab_size))
    params, opt_state, loss1 = step(params, opt_state, tokens)
    params, opt_state, loss2 = step(params, opt_state, tokens)
    assert float(loss2) < float(loss1)
    assert np.isfinite(float(loss1))


def test_remat_training_matches_and_microbatching_averages():
    """Twin of ``test_models.py::test_remat_training_matches_and_
    microbatching_averages`` (bf16 tiny), the same bounds."""
    config = tl.LlamaConfig.tiny()
    tokens = torch.from_numpy(batch(vocab=config.vocab_size))

    def first_loss(cfg, accumulate):
        params, opt_state, optimizer = tt.init_train_state(0, cfg,
                                                           cpu_plan())
        step = tt.make_train_step(cfg, cpu_plan(), optimizer=optimizer,
                                  accumulate_steps=accumulate)
        params, opt_state, loss = step(params, opt_state, tokens)
        _, _, loss2 = step(params, opt_state, tokens)
        assert float(loss2) < float(loss)
        return float(loss)

    plain = first_loss(config, 1)
    remat = first_loss(dataclasses.replace(config, remat=True), 1)
    accumulated = first_loss(config, 2)
    assert abs(plain - remat) < 1e-2
    assert abs(plain - accumulated) < 5e-2
