"""The port's checkpoints (``aiko_services_tpu_torch/models/checkpoint.py``)
and its safetensors format (``models/_safetensors.py``): twins of
``tests/test_checkpoint.py`` -- the same states through both packages'
``save_pytree`` / ``Checkpointer`` and back, equal leaf for leaf -- with
the sharded restore as a one-device plan on a CPU descriptor of the
tests' pool (a plan over two cards raises ``not_ported``); the format
against the ``safetensors`` package both ways, every dtype, bf16
included; an async save followed by an in-place change of the source
tensors.  Restores are exact: every comparison is bitwise."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_pipeline_elements import cpu_pool  # noqa: F401

from aiko_services_tpu.models import checkpoint as jax_checkpoint
from aiko_services_tpu_torch.models import _safetensors, bridge, llama
from aiko_services_tpu_torch.models.checkpoint import (
    Checkpointer, flatten, maybe_restore, restore_pytree, save_pytree)
from aiko_services_tpu_torch.parallel import MeshPlan, make_mesh

CPU = torch.device("cpu")
DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.float64,
          torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64,
          torch.bool]


def _random(dtype, shape, seed=0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if dtype == torch.bool:
        return torch.from_numpy(rng.integers(0, 2, shape).astype(np.bool_))
    if dtype.is_floating_point:
        return torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    info = torch.iinfo(dtype)
    return torch.from_numpy(rng.integers(max(info.min, -1000),
                                         min(info.max, 1000), shape)).to(dtype)


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# -- twins of tests/test_checkpoint.py ---------------------------------------


def test_roundtrip_simple(tmp_path):
    w = np.arange(8.0, dtype=np.float32)
    b = np.ones((2, 3), np.float32)
    state = {"w": torch.from_numpy(w.copy()), "b": torch.from_numpy(b.copy())}
    save_pytree(tmp_path / "ck", state)
    restored = restore_pytree(tmp_path / "ck", template=state)
    jax_checkpoint.save_pytree(tmp_path / "jax_ck",
                               {"w": jnp.asarray(w), "b": jnp.asarray(b)})
    reference = jax_checkpoint.restore_pytree(
        tmp_path / "jax_ck", template={"w": jnp.asarray(w),
                                       "b": jnp.asarray(b)})
    for name in ("w", "b"):
        assert _bitwise(restored[name], state[name])
        np.testing.assert_array_equal(restored[name].numpy(),
                                      np.asarray(reference[name]))


def test_sharded_restore_onto_mesh(tmp_path, cpu_pool):
    """Llama params saved, restored onto a one-device plan (a CPU
    descriptor of the pool) against a template of meta tensors."""
    config = llama.LlamaConfig.tiny(vocab_size=64, max_seq=32)
    plan = MeshPlan(make_mesh({"fsdp": 1, "tp": 1}, cpu_pool[3:4]))
    params = llama.init_params(0, config, device="cpu")

    with Checkpointer(tmp_path / "ck") as ckpt:
        ckpt.save(10, {"params": params}, metadata={"loss": 1.5},
                  wait=True)
        restored = ckpt.restore(
            template={"params": llama.abstract_params(config)}, plan=plan,
            specs={"params": None})
        meta = ckpt.metadata()

    leaf = restored["params"]["layers"]["wq"]
    assert leaf.device.type == plan.device.type   # CPU tensors drop the index
    for name, value in flatten(params).items():
        assert _bitwise(flatten(restored["params"])[name], value), name
    assert meta["loss"] == 1.5
    assert meta["step"] == 10


def test_restore_plan_over_two_cards_raises(tmp_path):
    """A plan over two CUDA cards raises ``not_ported`` before anything
    touches a card, as the plan's own puts do."""
    save_pytree(tmp_path / "ck", {"x": torch.zeros(4)})
    plan = MeshPlan(make_mesh({"tp": 2}, [torch.device("cuda", 0),
                                          torch.device("cuda", 1)]))
    with pytest.raises(NotImplementedError, match="not ported"):
        restore_pytree(tmp_path / "ck", template={"x": torch.zeros(4)},
                       plan=plan)


def test_retention_and_latest(tmp_path):
    with Checkpointer(tmp_path / "ck", keep=2) as ckpt:
        for step in (1, 2, 3):
            ckpt.save(step, {"x": torch.full((4,), float(step))},
                      wait=True)
        assert ckpt.latest_step == 3
        assert ckpt.all_steps() == [2, 3]          # keep=2
        restored = ckpt.restore(template={"x": torch.zeros((4,))})
        assert restored["x"].tolist() == [3.0, 3.0, 3.0, 3.0]
    with jax_checkpoint.Checkpointer(tmp_path / "jax_ck", keep=2) as ckpt:
        for step in (1, 2, 3):
            ckpt.save(step, {"x": jnp.full((4,), float(step))}, wait=True)
        assert ckpt.all_steps() == [2, 3]


def test_restore_empty_raises(tmp_path):
    with Checkpointer(tmp_path / "ck") as ckpt:
        with pytest.raises(FileNotFoundError):
            ckpt.restore()
        ckpt.save(1, {"x": torch.zeros(2)}, wait=True)
        with pytest.raises(FileNotFoundError, match="step 7"):
            ckpt.restore(step=7)
    with pytest.raises(FileNotFoundError):
        restore_pytree(tmp_path / "absent")
    assert not (tmp_path / "absent").exists()


# -- the port's own contract -------------------------------------------------


def test_layout_on_disk_and_key_names(tmp_path):
    """``<step>/state.safetensors`` + ``metadata.json``; keys are the
    pytree paths joined with '.', dict keys and list indices alike."""
    state = {"params": {"heads": [{"w": torch.ones(2)},
                                  {"w": torch.zeros(3)}],
                        "stem": {"b": torch.arange(4)}}}
    with Checkpointer(tmp_path / "ck") as ckpt:
        ckpt.save(5, state, metadata={"note": "x"}, wait=True)
    step = tmp_path / "ck" / "5"
    assert sorted(p.name for p in step.iterdir()) == [
        "metadata.json", "state.safetensors"]
    assert json.loads((step / "metadata.json").read_text())["note"] == "x"
    names = _safetensors.SafetensorsFile(step / "state.safetensors").keys()
    assert names == ["params.heads.0.w", "params.heads.1.w",
                     "params.stem.b"]
    restored = restore_pytree(tmp_path / "ck", device="cpu")
    assert isinstance(restored["params"]["heads"], list)
    assert _bitwise(restored["params"]["heads"][1]["w"], torch.zeros(3))
    assert _bitwise(restored["params"]["stem"]["b"], torch.arange(4))


@pytest.mark.parametrize("change", ["shape", "dtype", "missing", "extra"])
def test_template_mismatch_names_the_leaf(tmp_path, change):
    save_pytree(tmp_path / "ck", {"a": torch.zeros(4), "b": torch.ones(2)})
    template = {"a": torch.zeros(4), "b": torch.ones(2)}
    named = "leaf 'b'"
    if change == "shape":
        template["b"] = torch.ones(3)
    elif change == "dtype":
        template["b"] = torch.ones(2, dtype=torch.bfloat16)
    elif change == "missing":
        del template["b"]
        named = r"not in the template \['b'\]"
    else:
        template["c"] = torch.ones(1)
        named = r"missing \['c'\]"
    with pytest.raises(ValueError, match=named):
        restore_pytree(tmp_path / "ck", template=template)


def test_async_save_then_in_place_change(tmp_path):
    """``save`` returns with every leaf on the host; the caller changes
    its tensors at once, and the step holds the values at the call."""
    params = llama.init_params(1, llama.LlamaConfig.tiny(), device="cpu")
    before = {name: leaf.clone()
              for name, leaf in flatten({"params": params}).items()}
    ckpt = Checkpointer(tmp_path / "ck")
    ckpt.save(3, {"params": params})
    for leaf in flatten(params).values():
        leaf.add_(1)
    ckpt.wait()
    restored = ckpt.restore(device="cpu")
    ckpt.close()
    for name, value in flatten(restored).items():
        assert _bitwise(value, before[name]), name


def test_background_write_error_surfaces_at_wait(tmp_path):
    ckpt = Checkpointer(tmp_path / "ck")
    ckpt.save(1, {"x": torch.zeros(2, dtype=torch.complex64)})
    with pytest.raises(ValueError, match="complex64"):
        ckpt.wait()


def test_restore_keeps_the_template_memory_format(tmp_path):
    """A ``channels_last`` template leaf (the detector's kernels) comes
    back ``channels_last`` with the same values."""
    weight = _random(torch.float32, (4, 3, 3, 3)).contiguous(
        memory_format=torch.channels_last)
    save_pytree(tmp_path / "ck", {"params": {"w": weight}})
    template = torch.empty((4, 3, 3, 3), device="meta").contiguous(
        memory_format=torch.channels_last)
    restored = maybe_restore({"w": template}, str(tmp_path / "ck"),
                             device="cpu")["w"]
    assert restored.is_contiguous(memory_format=torch.channels_last)
    assert _bitwise(restored, weight)


def test_maybe_restore_without_checkpoint_keeps_params():
    params = {"w": torch.ones(2)}
    assert maybe_restore(params, None) is params
    assert maybe_restore(params, "") is params


def test_restore_or_init_draws_without_checkpoint(tmp_path):
    """No checkpoint: ``init_params`` on the seed; a checkpoint of those
    weights restores them bit for bit from a meta template."""
    from aiko_services_tpu_torch.models.checkpoint import restore_or_init
    config = llama.LlamaConfig.tiny()
    drawn = restore_or_init(llama, config, 4, None, "cpu")
    reference = llama.init_params(4, config, device="cpu")
    save_pytree(tmp_path / "ck", {"params": drawn})
    restored = restore_or_init(llama, config, 0, str(tmp_path / "ck"),
                               "cpu")
    for name, value in flatten(reference).items():
        assert _bitwise(flatten(drawn)[name], value), name
        assert _bitwise(flatten(restored)[name], value), name


def test_bridged_jax_tree_round_trips(tmp_path):
    """The way across from the JAX package: its numpy-bridged tree saved
    by the port restores equal to the bridge's tensors."""
    import jax
    from aiko_services_tpu.models import llama as jax_llama
    config = llama.LlamaConfig.tiny(vocab_size=64)
    jax_config = jax_llama.LlamaConfig.tiny(vocab_size=64)
    tree = jax.tree_util.tree_map(
        lambda leaf: (np.asarray(leaf).view(np.uint16), "bfloat16"),
        jax_llama.init_params(jax.random.PRNGKey(0), jax_config))
    params = bridge.params_from_numpy(tree, config, device="cpu")
    save_pytree(tmp_path / "ck", {"params": params})
    restored = maybe_restore(llama.abstract_params(config),
                             str(tmp_path / "ck"), device="cpu")
    for name, value in flatten(params).items():
        assert _bitwise(flatten(restored)[name], value), name


# -- the format against the safetensors package ------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_port_writer_read_by_safetensors_package(tmp_path, dtype):
    from safetensors.torch import load_file
    tensors = {"m": _random(dtype, (3, 5)), "s": _random(dtype, (), 1),
               "e": _random(dtype, (0, 4), 2), "v": _random(dtype, (7,), 3)}
    _safetensors.write_file(tmp_path / "x.safetensors", tensors,
                            metadata={"k": "v"})
    loaded = load_file(str(tmp_path / "x.safetensors"))
    assert sorted(loaded) == sorted(tensors)
    for name, value in tensors.items():
        assert _bitwise(loaded[name], value), name
    from safetensors import safe_open
    with safe_open(str(tmp_path / "x.safetensors"), "pt") as fh:
        assert fh.metadata() == {"k": "v"}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_safetensors_package_file_read_by_port(tmp_path, dtype):
    from safetensors.torch import save_file
    tensors = {"a": _random(dtype, (4, 2, 3)), "b": _random(dtype, (1,), 1),
               "z": _random(dtype, (), 2)}
    save_file(tensors, str(tmp_path / "y.safetensors"),
              metadata={"format": "pt"})
    reader = _safetensors.SafetensorsFile(tmp_path / "y.safetensors")
    assert sorted(reader.keys()) == ["a", "b", "z"]
    assert reader.metadata() == {"format": "pt"}
    for name, value in tensors.items():
        assert reader.shape(name) == tuple(value.shape)
        assert reader.dtype(name) == dtype
        got = reader.get_tensor(name)
        assert _bitwise(got, value), name
        got.zero_() if got.numel() else None    # copy-on-write mapping
    again = _safetensors.SafetensorsFile(tmp_path / "y.safetensors")
    for name, value in tensors.items():
        assert _bitwise(again.get_tensor(name), value), name


def test_safetensors_numpy_file_read_by_port(tmp_path):
    """A file written from numpy (the JAX tests' writer) reads the same
    through the port."""
    from safetensors.numpy import save_file
    arrays = {"f": np.arange(12, dtype=np.float32).reshape(3, 4),
              "i": np.arange(5, dtype=np.int64)}
    save_file(arrays, str(tmp_path / "n.safetensors"))
    reader = _safetensors.SafetensorsFile(tmp_path / "n.safetensors")
    for name, value in arrays.items():
        np.testing.assert_array_equal(reader.get_tensor(name).numpy(),
                                      value)


def test_reader_rejects_a_truncated_file(tmp_path):
    _safetensors.write_file(tmp_path / "t.safetensors",
                            {"x": torch.ones(64)})
    data = (tmp_path / "t.safetensors").read_bytes()
    (tmp_path / "t.safetensors").write_bytes(data[:-8])
    with pytest.raises(ValueError, match="data_offsets"):
        _safetensors.SafetensorsFile(tmp_path / "t.safetensors")
