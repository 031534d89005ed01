"""The port's weight ingestion (``aiko_services_tpu_torch/models/convert.py``)
and the serving elements' ``checkpoint`` / ``tokenizer`` parameters:
twins of ``tests/test_convert.py``, each also holding the port's leaves
bitwise equal to the JAX package's ``llama_params_from_hf`` /
``convert_detector`` on the same file (bf16 and float32, from float32
and bf16 sources); an ``(LLM)`` pipeline of each package, each loaded
from its own conversion of one tiny HF file, giving equal token ids at
temperature 0 in float32; the ``Detector``, ``ASR`` and ``TTS`` elements
restored from port checkpoints of bridged JAX trees against the JAX
outputs; a tokenizer directory built here with ``tokenizers``, loading
to the same ids in both packages; and a tokenizer path that does not
load failing the frame (the JAX package falls back to bytes in
silence).

Tolerances: the Detector in float32 as ``tests/test_torch_detector.py``
holds it (classes exact, boxes and scores within 1e-4); the TTS mel
within 1e-4 of its peak (float32 summation order); the ASR's text and
the LLMs' token ids exactly."""

import dataclasses
import json
import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_until
from test_convert import _fabricate_hf_llama
from test_torch_asr import _numpy_tree
from test_torch_llm_element import (_float32_tiny, _port_runtime,
                                    _port_teardown, _recording_collector)
from torch_pipeline_elements import cpu_pool  # noqa: F401

from aiko_services_tpu.models import convert as jax_convert
from aiko_services_tpu.models import detector as jax_detector
from aiko_services_tpu.models import llama as jax_llama
from aiko_services_tpu_torch.elements import llm as port_llm
from aiko_services_tpu_torch.models import (bridge, convert, detector,
                                            llama)
from aiko_services_tpu_torch.models.checkpoint import (flatten,
                                                       maybe_restore,
                                                       save_pytree)
from aiko_services_tpu_torch.pipeline import create_pipeline

DETECT_TOL = 1e-4
F32_TOL = 1e-4


@pytest.fixture
def runtime():
    rt = _port_runtime()
    yield rt
    _port_teardown(rt)


def _save_safetensors(path, tensors):
    from safetensors.numpy import save_file
    save_file(tensors, str(path))


def _jax_bits(leaf) -> np.ndarray:
    array = np.asarray(leaf)
    return array.view(np.uint16) if array.dtype == jnp.bfloat16 else array


def _port_bits(tensor: torch.Tensor) -> np.ndarray:
    tensor = tensor.contiguous()
    if tensor.dtype == torch.bfloat16:
        return tensor.view(torch.int16).numpy().view(np.uint16)
    return tensor.numpy()


def assert_leaves_bitwise(port_tree, jax_tree):
    ours, theirs = flatten(port_tree), flatten(jax_tree)
    assert sorted(ours) == sorted(theirs)
    for name, leaf in ours.items():
        want = _jax_bits(theirs[name])
        got = _port_bits(leaf)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert np.array_equal(got, want), name


def _hf_from_tree(tree: dict) -> dict:
    """A layer-stacked numpy tree ([in, out] projections) in the HF
    naming and layout ([out, in] Linears, one tensor a layer)."""
    attn = {"wq": "q", "wk": "k", "wv": "v", "wo": "o"}
    mlp = {"w_gate": "gate", "w_up": "up", "w_down": "down"}
    tensors = {"model.embed_tokens.weight": tree["embed"],
               "model.norm.weight": tree["final_norm"],
               "lm_head.weight": np.ascontiguousarray(tree["unembed"].T)}
    layers = tree["layers"]
    for i in range(layers["wq"].shape[0]):
        p = f"model.layers.{i}"
        for name, short in attn.items():
            tensors[f"{p}.self_attn.{short}_proj.weight"] = \
                np.ascontiguousarray(layers[name][i].T)
        for name, short in mlp.items():
            tensors[f"{p}.mlp.{short}_proj.weight"] = \
                np.ascontiguousarray(layers[name][i].T)
        tensors[f"{p}.input_layernorm.weight"] = layers["attn_norm"][i]
        tensors[f"{p}.post_attention_layernorm.weight"] = \
            layers["mlp_norm"][i]
    return tensors


def _init_scale_hf(config, seed=0) -> dict:
    """HF tensors at the init scale (standard normal x fan_in^-0.5,
    norms at one), float32: logits far enough apart that greedy decoding
    does not hang on float32 summation order."""
    rng = np.random.default_rng(seed)
    tree = llama.param_shapes(config)

    def draw(layout):
        out = {}
        for name, value in layout.items():
            if isinstance(value, dict):
                out[name] = draw(value)
                continue
            shape, fan_in = value
            out[name] = np.ones(shape, np.float32) if fan_in is None else \
                (rng.standard_normal(shape) * fan_in ** -0.5).astype(
                    np.float32)
        return out
    return _hf_from_tree(draw(tree))


# -- twins of tests/test_convert.py ------------------------------------------


def test_llama_roundtrip_through_checkpoint(tmp_path, runtime):
    """Fabricated safetensors -> convert_llama -> LLMService(checkpoint=)
    generates, the converted projections equal the transposed HF
    tensors, and every leaf equals the JAX package's bit for bit.  (The
    vocabulary is 512, not the JAX test's 128: the byte tokenizer's BOS
    is 257, which a JAX gather clamps and a torch index refuses.)"""
    from aiko_services_tpu_torch.elements import LLMService

    config = llama.LlamaConfig.tiny(vocab_size=512, max_seq=64)
    tensors = _fabricate_hf_llama(config)
    src = tmp_path / "model.safetensors"
    _save_safetensors(src, tensors)

    ckpt = tmp_path / "converted"
    out_config = convert.convert_llama(src, ckpt, config)
    assert out_config is config

    params = convert.llama_params_from_hf(
        convert.load_safetensors(src), config)
    np.testing.assert_allclose(
        params["layers"]["wq"][1].float().numpy(),
        tensors["model.layers.1.self_attn.q_proj.weight"].T,
        rtol=1e-2, atol=1e-2)  # bf16 cast
    np.testing.assert_allclose(
        params["unembed"].float().numpy(),
        tensors["lm_head.weight"].T, rtol=1e-2, atol=1e-2)
    jax_config = jax_llama.LlamaConfig.tiny(vocab_size=512, max_seq=64)
    assert_leaves_bitwise(params, jax_convert.llama_params_from_hf(
        jax_convert.load_safetensors(src), jax_config))

    from aiko_services_tpu_torch.elements import llm
    service = LLMService(runtime=runtime, config=config,
                         checkpoint=str(ckpt), device="cpu")
    text = service.generate_local("ab", max_new_tokens=4)
    assert isinstance(text, str)
    # The served params are the converted ones, not random init.
    assert torch.equal(service.batcher.params["layers"]["wk"],
                       params["layers"]["wk"])
    assert llm.LLMService is LLMService


def test_llama_tied_embeddings_and_sharded_dir(tmp_path):
    """lm_head absent -> unembed = embed.T; shards in a directory merge,
    and the leaves equal the JAX package's."""
    config = llama.LlamaConfig.tiny(vocab_size=64, max_seq=32)
    tensors = _fabricate_hf_llama(config)
    del tensors["lm_head.weight"]
    shard_dir = tmp_path / "shards"
    shard_dir.mkdir()
    names = sorted(tensors)
    half = len(names) // 2
    _save_safetensors(shard_dir / "model-00001.safetensors",
                      {n: tensors[n] for n in names[:half]})
    _save_safetensors(shard_dir / "model-00002.safetensors",
                      {n: tensors[n] for n in names[half:]})

    params = convert.llama_params_from_hf(
        convert.load_safetensors(shard_dir), config)
    assert torch.equal(params["unembed"], params["embed"].T)
    assert_leaves_bitwise(params, jax_convert.llama_params_from_hf(
        jax_convert.load_safetensors(shard_dir),
        jax_llama.LlamaConfig.tiny(vocab_size=64, max_seq=32)))


def test_infer_llama_config_from_shapes():
    config = llama.LlamaConfig(vocab_size=128, dim=64, n_layers=3,
                               n_heads=32, n_kv_heads=8, hidden_dim=96,
                               max_seq=64)
    tensors = _fabricate_hf_llama(config)
    inferred = convert.infer_llama_config(
        {name: torch.from_numpy(value) for name, value in tensors.items()})
    assert inferred.vocab_size == 128
    assert inferred.dim == 64
    assert inferred.n_layers == 3
    assert inferred.hidden_dim == 96
    assert inferred.n_heads == 32          # Llama convention default
    assert inferred.n_kv_heads == 8
    theirs = jax_convert.infer_llama_config(tensors)
    assert dataclasses.asdict(inferred) == dataclasses.asdict(theirs)


def test_hf_config_json_overrides_shape_guess(tmp_path):
    """config.json next to the safetensors is authoritative for head
    counts (shapes alone cannot distinguish n_heads)."""
    config = llama.LlamaConfig.tiny(vocab_size=64, max_seq=32)  # 4 heads
    tensors = _fabricate_hf_llama(config)
    src_dir = tmp_path / "snapshot"
    src_dir.mkdir()
    _save_safetensors(src_dir / "model.safetensors", tensors)
    (src_dir / "config.json").write_text(json.dumps(
        {"num_attention_heads": config.n_heads,
         "num_key_value_heads": config.n_kv_heads,
         "rope_theta": config.rope_theta,
         "rope_scaling": {"rope_type": "llama3", "factor": 32.0}}))

    out = convert.convert_llama(src_dir, tmp_path / "ckpt", max_seq=32)
    assert out.n_heads == config.n_heads
    assert out.n_kv_heads == config.n_kv_heads
    assert out.rope_theta == config.rope_theta
    theirs = jax_convert.convert_llama(src_dir, tmp_path / "jax_ckpt",
                                       max_seq=32)
    # rope_scaling is read by neither package (a reference fact).
    assert dataclasses.asdict(out) == dataclasses.asdict(theirs)
    meta = json.loads((tmp_path / "ckpt" / "0" / "metadata.json")
                      .read_text())
    assert meta["config"]["n_heads"] == config.n_heads


def test_convert_rejects_wrong_shapes(tmp_path):
    config = llama.LlamaConfig.tiny(vocab_size=128, max_seq=64)
    # Uniformly wrong: every layer's up_proj truncated -> caught by the
    # post-stack shape check, named by pytree path.
    tensors = _fabricate_hf_llama(config)
    for i in range(config.n_layers):
        name = f"model.layers.{i}.mlp.up_proj.weight"
        tensors[name] = np.ascontiguousarray(tensors[name][:, :-1])
    src = tmp_path / "bad.safetensors"
    _save_safetensors(src, tensors)
    with pytest.raises(ValueError, match="w_up"):
        convert.llama_params_from_hf(convert.load_safetensors(src),
                                     config)

    # Ragged: only layer 0 wrong -> caught at stack time, named by the
    # HF template.
    tensors = _fabricate_hf_llama(config)
    tensors["model.layers.0.mlp.up_proj.weight"] = np.ascontiguousarray(
        tensors["model.layers.0.mlp.up_proj.weight"][:, :-1])
    src2 = tmp_path / "ragged.safetensors"
    _save_safetensors(src2, tensors)
    with pytest.raises(ValueError, match="up_proj"):
        convert.llama_params_from_hf(convert.load_safetensors(src2),
                                     config)
    # A missing layer tensor is named.
    del tensors["model.layers.1.self_attn.k_proj.weight"]
    with pytest.raises(KeyError, match="layers.1.self_attn.k_proj"):
        convert.llama_params_from_hf(
            {name: torch.from_numpy(value)
             for name, value in tensors.items()}, config)


def test_detector_roundtrip(tmp_path):
    """Detector export format: the JAX tree's paths joined with '.' ->
    port checkpoint -> restore equals the source, bit for bit equal to
    the JAX package's conversion of the same file."""
    config = detector.DetectorConfig.tiny()
    jax_config = jax_detector.DetectorConfig.tiny()
    reference = jax_detector.init_params(jax.random.PRNGKey(7), jax_config)

    flat = {name: np.asarray(leaf, dtype=np.float32)
            for name, leaf in flatten(reference).items()}
    src = tmp_path / "detector.safetensors"
    _save_safetensors(src, flat)

    ckpt = tmp_path / "det_ckpt"
    assert convert.convert_detector(src, ckpt, config) is config
    restored = maybe_restore(detector.abstract_params(config), str(ckpt),
                             device="cpu")
    jax_convert.convert_detector(src, tmp_path / "jax_det_ckpt",
                                 jax_config)
    from aiko_services_tpu.models.checkpoint import \
        maybe_restore as jax_maybe_restore
    theirs = jax_maybe_restore(
        jax_detector.init_params(jax.random.PRNGKey(0), jax_config),
        str(tmp_path / "jax_det_ckpt"))
    hwio = {name: leaf.permute(2, 3, 1, 0) if leaf.dim() == 4 else leaf
            for name, leaf in flatten(restored).items()}
    assert_leaves_bitwise(hwio, theirs)
    assert restored["stem"]["w"].is_contiguous(
        memory_format=torch.channels_last)
    with pytest.raises(KeyError, match="stem.w"):
        del flat["stem.w"]
        _save_safetensors(src, flat)
        convert.convert_detector(src, tmp_path / "bad", config)


# -- bitwise leaves across dtypes --------------------------------------------


@pytest.mark.parametrize("source", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_llama_leaves_bitwise_equal_jax(tmp_path, source, dtype):
    """The same HF file (float32 or bf16 tensors, as a checkpoint is
    published) converts to the same bits in both packages, in the
    config's bf16 or float32."""
    from safetensors.torch import save_file
    config = dataclasses.replace(
        llama.LlamaConfig.tiny(vocab_size=96, max_seq=32), dtype=dtype)
    jax_config = dataclasses.replace(
        jax_llama.LlamaConfig.tiny(vocab_size=96, max_seq=32), dtype=dtype)
    tensors = {name: torch.from_numpy(value).to(getattr(torch, source))
               for name, value in _init_scale_hf(config).items()}
    save_file(tensors, str(tmp_path / "m.safetensors"))
    ours = convert.llama_params_from_hf(
        convert.load_safetensors(tmp_path / "m.safetensors"), config)
    theirs = jax_convert.llama_params_from_hf(
        jax_convert.load_safetensors(tmp_path / "m.safetensors"),
        jax_config)
    assert ours["embed"].dtype == getattr(torch, dtype)
    assert_leaves_bitwise(ours, theirs)
    # The checkpoint holds those leaves unchanged.
    convert.convert_llama(tmp_path / "m.safetensors", tmp_path / "ck",
                          config)
    restored = maybe_restore(llama.abstract_params(config),
                             str(tmp_path / "ck"), device="cpu")
    assert_leaves_bitwise(restored, theirs)


def test_load_safetensors_keeps_bf16_and_maps_the_file(tmp_path):
    from safetensors.torch import save_file
    weight = torch.randn(8, 4).to(torch.bfloat16)
    save_file({"w": weight}, str(tmp_path / "x.safetensors"))
    loaded = convert.load_safetensors(tmp_path / "x.safetensors")["w"]
    assert loaded.dtype == torch.bfloat16 and torch.equal(loaded, weight)
    with pytest.raises(FileNotFoundError):
        convert.load_safetensors(tmp_path / "empty_dir_that_is_absent")


# -- (LLM) pipelines, each from its own package's conversion -----------------


def _llm_definition(path, module_root, runtime, parameters):
    definition = {
        "version": 0, "name": f"llm_{runtime}", "runtime": runtime,
        "graph": ["(LLM)"],
        "elements": [{
            "name": "LLM", "input": [{"name": "text"}],
            "output": [{"name": "text"}], "parameters": parameters,
            "deploy": {"local": {"module": f"{module_root}.elements.llm",
                                 "class_name": "LLM"}}}]}
    path.write_text(json.dumps(definition))
    return str(path)


PROMPTS = ["hello there", "a red car", "", "the quick brown fox jumps"]
LLM_SETTINGS = {"max_new_tokens": 8, "max_seq": 64, "temperature": 0}


def _run_texts(rt, path, create) -> tuple:
    responses = queue.Queue()
    pipeline = create(path, runtime=rt)
    stream = pipeline.create_stream_local("1", queue_response=responses)
    for prompt in PROMPTS:
        pipeline.create_frame_local(stream, {"text": prompt})
    assert run_until(rt, lambda: responses.qsize() >= len(PROMPTS),
                     timeout=120.0)
    texts = {}
    while not responses.empty():
        _, frame_id, swag, _, okay, diagnostic = responses.get()
        assert okay, diagnostic
        texts[frame_id] = swag["text"]
    return pipeline, texts


def test_llm_pipelines_from_their_own_conversions_agree(tmp_path,
                                                        monkeypatch):
    """One tiny HF file, converted by each package into its own
    checkpoint (float32), served by each package's (LLM) pipeline: equal
    token ids and text, frame by frame, at temperature 0."""
    from aiko_services_tpu.elements import llm as jax_llm
    from aiko_services_tpu.pipeline import create_pipeline as jax_create
    from aiko_services_tpu.runtime import init_process, reset_process
    from aiko_services_tpu.services.share import reset_services_cache
    from aiko_services_tpu.transport import reset_broker

    monkeypatch.setattr(jax_llama.LlamaConfig, "tiny",
                        _float32_tiny(jax_llama))
    monkeypatch.setattr(llama.LlamaConfig, "tiny", _float32_tiny(llama))
    config = llama.LlamaConfig.tiny(vocab_size=512, max_seq=64)
    src = tmp_path / "hf"
    src.mkdir()
    _save_safetensors(src / "model.safetensors", _init_scale_hf(config, 3))
    convert.convert_llama(src, tmp_path / "port_ck", config)
    jax_convert.convert_llama(
        src, tmp_path / "jax_ck",
        jax_llama.LlamaConfig.tiny(vocab_size=512, max_seq=64))

    their_tokens, our_tokens = {}, {}
    monkeypatch.setattr(jax_llm, "_collector",
                        _recording_collector(jax_llm, their_tokens))
    monkeypatch.setattr(port_llm, "_collector",
                        _recording_collector(port_llm, our_tokens))
    reset_broker()
    reset_services_cache()
    rt = init_process(transport="loopback")
    rt.initialize()
    try:
        pipeline, theirs = _run_texts(rt, _llm_definition(
            tmp_path / "jax.json", "aiko_services_tpu", "jax",
            dict(LLM_SETTINGS, decode_block=1,
                 checkpoint=str(tmp_path / "jax_ck"))), jax_create)
        pipeline.stop()
    finally:
        rt.engine.terminate()
        reset_process()
        reset_services_cache()
        reset_broker()
    rt = _port_runtime()
    try:
        pipeline, ours = _run_texts(rt, _llm_definition(
            tmp_path / "port.json", "aiko_services_tpu_torch", "torch",
            dict(LLM_SETTINGS, device="cpu",
                 checkpoint=str(tmp_path / "port_ck"))), create_pipeline)
        element = pipeline.graph.get_node("LLM").element
        served = element._batcher.params
        pipeline.stop()
        element.close()
    finally:
        _port_teardown(rt)
    assert served["embed"].dtype == torch.float32
    assert len(ours) == len(PROMPTS)
    assert ours == theirs
    assert our_tokens == their_tokens
    assert sum(len(ids) for ids in our_tokens.values()) > len(PROMPTS)


def test_llm_build_from_checkpoint_draws_nothing(tmp_path, runtime,
                                                 monkeypatch):
    """The element's build from a checkpoint starts from shapes alone:
    ``init_params`` is never called, and the served leaves are the
    checkpoint's."""
    config = llama.LlamaConfig.tiny(vocab_size=512, max_seq=64)
    weights = llama.init_params(9, config, device="cpu")
    save_pytree(tmp_path / "ck", {"params": weights})

    def refuse(*args, **kwargs):
        raise AssertionError("init_params drew a tree beside the restore")
    monkeypatch.setattr(llama, "init_params", refuse)
    responses = queue.Queue()
    pipeline = create_pipeline(_llm_definition(
        tmp_path / "p.json", "aiko_services_tpu_torch", "torch",
        dict(LLM_SETTINGS, device="cpu", checkpoint=str(tmp_path / "ck"))),
        runtime=runtime)
    stream = pipeline.create_stream_local("1", queue_response=responses)
    pipeline.create_frame_local(stream, {"text": "hi"})
    assert run_until(runtime, lambda: not responses.empty(), timeout=60.0)
    *_, okay, diagnostic = responses.get()
    assert okay, diagnostic
    element = pipeline.graph.get_node("LLM").element
    for name, leaf in flatten(weights).items():
        assert torch.equal(flatten(element._batcher.params)[name], leaf)
    pipeline.stop()
    element.close()


# -- Detector, ASR and TTS from port checkpoints of bridged JAX trees --------


def _float32_detector_config(module):
    cls = module.DetectorConfig

    def factory(*args, **kwargs):
        return dataclasses.replace(cls(*args, **kwargs), dtype="float32")
    return factory


def _detector_definition(module_root, runtime, parameters):
    return {"version": 0, "name": f"p_detect_{runtime}", "runtime": runtime,
            "graph": ["(Detect)"], "parameters": {},
            "elements": [{
                "name": "Detect", "input": [{"name": "image"}],
                "output": [{"name": "detections"}],
                "parameters": parameters,
                "deploy": {"local": {
                    "module": f"{module_root}.elements.detect",
                    "class_name": "Detector"}}}]}


def _detections(rt, pipeline, image):
    responses = queue.Queue()
    pipeline.process_frame_local({"image": image}, queue_response=responses)
    assert run_until(rt, lambda: not responses.empty(), timeout=60.0)
    _, _, swag, _, okay, diagnostic = responses.get()
    assert okay, diagnostic
    return swag["detections"]


def test_detector_restored_from_bridged_jax_tree(tmp_path, runtime,
                                                 cpu_pool, monkeypatch):
    """The JAX Detector element's weights, bridged and saved as a port
    checkpoint, served by the port's Detector: the same detections as
    the JAX element's, and again after ``on_replacement`` (the weights
    rebuild from the checkpoint, not from the seed)."""
    from aiko_services_tpu.elements import detect as jax_detect
    from aiko_services_tpu.pipeline import Pipeline as JaxPipeline
    from aiko_services_tpu.runtime import init_process, reset_process
    from aiko_services_tpu.services.share import reset_services_cache
    from aiko_services_tpu.transport import reset_broker
    from aiko_services_tpu_torch.elements import detect as port_detect
    from aiko_services_tpu_torch.pipeline import Pipeline

    monkeypatch.setattr(jax_detect.detector, "DetectorConfig",
                        _float32_detector_config(jax_detector))
    monkeypatch.setattr(port_detect.detector, "DetectorConfig",
                        _float32_detector_config(detector))
    parameters = {"score_threshold": 0.0, "synchronous": True, "seed": 3}
    image = np.random.default_rng(4).integers(0, 256, (64, 64, 3),
                                              dtype=np.uint8)
    reset_broker()
    reset_services_cache()
    jax_rt = init_process(transport="loopback")
    jax_rt.initialize()
    try:
        theirs_pipeline = JaxPipeline(_detector_definition(
            "aiko_services_tpu", "jax", parameters), runtime=jax_rt)
        theirs = _detections(jax_rt, theirs_pipeline, image)
        element = theirs_pipeline.graph.get_node("Detect").element
        tree = jax.tree_util.tree_map(lambda leaf: np.asarray(leaf),
                                      element._params)
        jax_config = element._config
        theirs_pipeline.stop()
    finally:
        jax_rt.engine.terminate()
        reset_process()
        reset_services_cache()
        reset_broker()
    config = detector.DetectorConfig(
        num_classes=jax_config.num_classes, width=jax_config.width,
        score_threshold=jax_config.score_threshold, max_detections=32)
    assert config.dtype == "float32"
    save_pytree(tmp_path / "ck", {"params": bridge.detector_params_from_numpy(
        tree, config, device="cpu")})
    pipeline = Pipeline(_detector_definition(
        "aiko_services_tpu_torch", "torch",
        dict(parameters, seed=0, checkpoint=str(tmp_path / "ck"))),
        runtime=runtime)
    ours = _detections(runtime, pipeline, image)

    def assert_same(ours):
        assert len(ours) == len(theirs) > 0
        for got, want in zip(ours, theirs):
            assert got["class"] == want["class"]
            for key in got:
                if isinstance(got[key], float):
                    assert abs(got[key] - want[key]) <= DETECT_TOL, key
    assert_same(ours)
    element = pipeline.graph.get_node("Detect").element
    element.on_replacement()
    assert element._params is None
    assert_same(_detections(runtime, pipeline, image))
    pipeline.stop()


class _FakePipeline:
    def current_stream(self):
        return None

    def get_pipeline_parameter(self, name, default=None):
        return default


def _float32_sizes(cls):
    tiny = cls.tiny

    def factory(*args, **kwargs):
        return dataclasses.replace(tiny(*args, **kwargs), dtype="float32")
    return factory


def test_asr_restored_from_bridged_jax_tree(tmp_path, monkeypatch):
    from aiko_services_tpu.elements.speech import ASR as JaxASR
    from aiko_services_tpu.models import asr as jax_asr
    from aiko_services_tpu.pipeline.element import \
        ElementContext as JaxContext
    from aiko_services_tpu_torch.elements.speech import ASR
    from aiko_services_tpu_torch.models import asr
    from aiko_services_tpu_torch.pipeline.element import ElementContext

    monkeypatch.setitem(JaxASR._SIZES, "tiny",
                        _float32_sizes(jax_asr.AsrConfig))
    monkeypatch.setitem(ASR._SIZES, "tiny", _float32_sizes(asr.AsrConfig))
    rate = 16000
    theirs = JaxASR(JaxContext("a", None, _FakePipeline(),
                               {"model_size": "tiny", "seed": 2}))
    audio = (np.random.default_rng(5).standard_normal(rate * 3 // 2)
             * 0.2).astype(np.float32)
    _, want = theirs.process_frame(None, audio=audio, sample_rate=rate)
    config = ASR._SIZES["tiny"]()
    save_pytree(tmp_path / "ck", {"params": bridge.asr_params_from_numpy(
        _numpy_tree(theirs._params), config, device="cpu")})
    ours = ASR(ElementContext("a", None, _FakePipeline(), {
        "model_size": "tiny", "device": "cpu",
        "checkpoint": str(tmp_path / "ck")}))
    _, got = ours.process_frame(None, audio=audio, sample_rate=rate)
    assert got["text"] == want["text"]
    assert ours._params["embed"].dtype == torch.float32


def test_tts_restored_from_bridged_jax_tree(tmp_path, monkeypatch):
    """The mel the restored TTS computes equals the JAX element's model
    on the same weights; the element's waveform is the port's own
    ``synthesize`` of those weights (each package draws its own
    Griffin-Lim start phase)."""
    from aiko_services_tpu.elements.speech import TTS as JaxTTS
    from aiko_services_tpu.models import tts as jax_tts
    from aiko_services_tpu.pipeline.element import \
        ElementContext as JaxContext
    from aiko_services_tpu_torch.elements.speech import TTS
    from aiko_services_tpu_torch.models import tts
    from aiko_services_tpu_torch.pipeline.element import ElementContext

    monkeypatch.setitem(JaxTTS._SIZES, "tiny",
                        _float32_sizes(jax_tts.TtsConfig))
    monkeypatch.setitem(TTS._SIZES, "tiny", _float32_sizes(tts.TtsConfig))
    theirs = JaxTTS(JaxContext("t", None, _FakePipeline(),
                               {"model_size": "tiny", "seed": 4}))
    theirs.process_frame(None, text="hello")
    config = TTS._SIZES["tiny"]()
    weights = bridge.tts_params_from_numpy(_numpy_tree(theirs._params),
                                           config, device="cpu")
    save_pytree(tmp_path / "ck", {"params": weights})
    ours = TTS(ElementContext("t", None, _FakePipeline(), {
        "model_size": "tiny", "device": "cpu",
        "checkpoint": str(tmp_path / "ck")}))
    event, out = ours.process_frame(None, text="hello")
    tokens = np.stack([tts.encode_text(config, "hello")])
    want = np.asarray(jax_tts.synthesize_mel(
        theirs._params, theirs._config, jnp.asarray(tokens)))
    got = tts.synthesize_mel(ours._params, config, torch.from_numpy(tokens))
    assert float(np.abs(got.numpy() - want).max()
                 / np.abs(want).max()) <= F32_TOL
    np.testing.assert_array_equal(
        out["audio"], tts.synthesize(weights, config, "hello"))


# -- tokenizers ----------------------------------------------------------------


@pytest.fixture
def tokenizer_dir(tmp_path):
    """A WordLevel HF tokenizer directory built here with
    ``tokenizers`` (no download)."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast
    words = ["<unk>", "<s>", "</s>", "a", "red", "car", "hello", "there",
             "the", "quick", "brown", "fox"]
    tokenizer = Tokenizer(models.WordLevel(
        {word: index for index, word in enumerate(words)},
        unk_token="<unk>"))
    tokenizer.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = PreTrainedTokenizerFast(tokenizer_object=tokenizer,
                                   unk_token="<unk>", bos_token="<s>",
                                   eos_token="</s>")
    path = tmp_path / "tokenizer"
    fast.save_pretrained(str(path))
    return str(path)


def test_tokenizer_directory_loads_to_the_same_ids(tokenizer_dir):
    from aiko_services_tpu.models.tokenizer import \
        load_tokenizer as jax_load
    from aiko_services_tpu_torch.models.tokenizer import load_tokenizer
    ours, theirs = load_tokenizer(tokenizer_dir), jax_load(tokenizer_dir)
    assert type(ours).__name__ == type(theirs).__name__ == "_HFTokenizer"
    for text in ("hello there", "the quick brown fox", "a red bus"):
        for add_bos in (True, False):
            assert ours.encode(text, add_bos) == theirs.encode(text,
                                                               add_bos)
        ids = ours.encode(text)
        assert ours.decode(ids) == theirs.decode(ids)
    assert ours.vocab_size == theirs.vocab_size == 12
    assert ours.eos_tokens == theirs.eos_tokens == (2,)


def test_llm_serves_with_a_tokenizer_directory(tokenizer_dir, tmp_path,
                                               runtime):
    responses = queue.Queue()
    pipeline = create_pipeline(_llm_definition(
        tmp_path / "tok.json", "aiko_services_tpu_torch", "torch",
        dict(LLM_SETTINGS, device="cpu", tokenizer=tokenizer_dir)),
        runtime=runtime)
    stream = pipeline.create_stream_local("1", queue_response=responses)
    pipeline.create_frame_local(stream, {"text": "hello there"})
    assert run_until(runtime, lambda: not responses.empty(), timeout=60.0)
    *_, okay, diagnostic = responses.get()
    assert okay, diagnostic
    element = pipeline.graph.get_node("LLM").element
    assert element._tokenizer.vocab_size == 12
    assert element._batcher.config.vocab_size == 12   # tiny follows it
    pipeline.stop()
    element.close()


def test_bad_tokenizer_path_fails_the_frame(tmp_path, runtime):
    """A directory that holds no tokenizer fails the frame in the port;
    the JAX package falls back to ``ByteTokenizer`` in silence."""
    from aiko_services_tpu.models.tokenizer import \
        load_tokenizer as jax_load
    empty = tmp_path / "not_a_tokenizer"
    empty.mkdir()
    assert type(jax_load(str(empty))).__name__ == "ByteTokenizer"
    responses = queue.Queue()
    pipeline = create_pipeline(_llm_definition(
        tmp_path / "bad.json", "aiko_services_tpu_torch", "torch",
        dict(LLM_SETTINGS, device="cpu", tokenizer=str(empty))),
        runtime=runtime)
    stream = pipeline.create_stream_local("1", queue_response=responses)
    pipeline.create_frame_local(stream, {"text": "hi"})
    assert run_until(runtime, lambda: not responses.empty(), timeout=60.0)
    *_, okay, diagnostic = responses.get()
    assert not okay and "Unrecognized model" in diagnostic
    element = pipeline.graph.get_node("LLM").element
    assert element._batcher is None
    pipeline.stop()
    element.close()
