"""The port's engine is a COPY of the JAX package's jax-free modules with
the package name as the only change; this test keeps it so.

For every copied module, the port's text is compared line by line with
the reference's text after the rename (``aiko_services_tpu`` ->
``aiko_services_tpu_torch``).  Every difference must fall inside an
entry of :data:`ALLOWED` -- a span of the REFERENCE's lines with the
reason the port cannot keep them -- and every entry must still cover a
difference (a fixed reference or a reverted port makes it stale).

The rewritten modules (``pipeline/overlap.py``, ``pipeline/fusion.py``,
``pipeline/tensor.py``, ``models/batching.py``, ``models/detector.py``,
``tpu/health.py``, ``models/asr.py``, ``models/tts.py``,
``elements/audio.py``, ``elements/speech.py``, ``elements/image.py``)
are ports, not copies;
the definitions they keep verbatim are held to the reference one by one
(:data:`KEPT_DEFINITIONS`).  Copied imports that name what the port
does not have yet are listed in :data:`UNRESOLVED_IMPORTS`, each with
why the copy may keep it."""

import ast
import difflib
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
REFERENCE = ROOT / "aiko_services_tpu"
PORT = ROOT / "aiko_services_tpu_torch"

COPIED_DIRECTORIES = ("utils", "runtime", "transport", "services",
                      "gateway", "observability", "orchestration",
                      "faults", "analysis")
COPIED_FILES = (
    "pipeline/__init__.py", "pipeline/codec.py", "pipeline/data_plane.py",
    "pipeline/definition.py", "pipeline/element.py", "pipeline/journal.py",
    "pipeline/scheme.py", "pipeline/stages.py", "pipeline/stream.py",
    "pipeline/pipeline.py", "elements/common.py", "elements/control.py",
    # control.py's Loop evaluates its condition here:
    "elements/expression.py",
    # the speech path's gate, its file scheme and the live audio
    # endpoints:
    "elements/text.py", "elements/scheme_file.py",
    "elements/audio_live.py",
    # the rest of the element library and the media conversions:
    "elements/observe.py", "elements/scheme_tty.py", "elements/vision.py",
    "elements/video.py", "elements/scheme_zmq.py",
    "elements/scheme_tensor.py", "elements/scheme_rtsp.py",
    "media_convert.py",
    # the command line and the terminal dashboard (stdlib curses):
    "cli.py", "__main__.py", "dashboard.py")

#: module -> [((first, last) reference lines, reason)].  An insertion
#: sits at the reference line it precedes.
ALLOWED = {
    "analysis/params.py": [
        ((348, 348), "ELEMENT_PARAMETERS gains the port LLM's `device` "
                     "parameter (the port's device rule, device.py)"),
        ((349, 349), "ELEMENT_PARAMETERS gains `device` rows for the "
                     "port's ASR, TTS, AudioFraming, AudioResampler, "
                     "AudioFFT and ImageResize (the same rule)")],
    "elements/text.py": [
        ((89, 89), "TextFilter counts an array gate's elements from its "
                   "shape: a torch tensor's `size` is a method, so "
                   "`int(value.size)` raises on one")],
    "elements/audio_live.py": [
        ((24, 25), "the port imports no jax"),
        ((225, 225), "a microphone block stays the host array it was "
                     "captured as (host values stay on the host; an "
                     "element that computes on it uploads it)")],
    "analysis/residency.py": [
        ((36, 36), "the host-force rule learns torch's host copies "
                   "(.cpu(), .numpy(), .tolist(), .to('cpu')) beside "
                   ".item(); without them undeclared-host-input passes "
                   "a port element that forces a host copy"),
        ((235, 238), "undeclared-host-input: the tensor host copies, "
                     "through _tensor_host_copy"),
        ((282, 285), "device-fn-host-call: the tensor host copies, "
                     "through _tensor_host_copy")],
    "pipeline/codec.py": [
        ((4, 118), "ml_dtypes is not on the card machine: bf16 and the "
                   "other dtypes numpy cannot hold are tagged by torch "
                   "dtype and round-trip as raw bytes (a CPU tensor of "
                   "that dtype on decode)")],
    "pipeline/data_plane.py": [
        ((43, 43), "imports the codec's host_only"),
        ((82, 82), "split_arrays refuses a tensor on a card (host_only): "
                   "its __array__ would copy it to the host uncounted; "
                   "the engine fetches a frame's device leaves first"),
        ((316, 316), "the sender hands each array to tag_view as it is: "
                     "a bf16 host tensor (the fetch's form of a dtype "
                     "numpy cannot hold) has no numpy array to take")],
    "pipeline/definition.py": [
        ((24, 24), "the port's runtimes are python and torch; 'jax' is "
                   "refused and the message names torch (ROADMAP "
                   "Queue 3)"),
        ((218, 218), "torch is the default runtime")],
    "elements/video.py": [
        ((5, 6), "decoded frames are numpy arrays in the port"),
        ((18, 19), "the port imports no jax"),
        ((58, 58), "a decoded file frame stays the host array it was "
                   "decoded as (host values stay on the host until an "
                   "element computes on them)"),
        ((163, 163), "the same for a webcam frame")],
    "elements/scheme_zmq.py": [
        ((9, 9), "arrays arrive as numpy in the port"),
        ((22, 23), "the port imports no jax"),
        ((53, 53), "a received array stays on the host (numpy), where "
                   "the reference puts it on the device")],
    "elements/scheme_tensor.py": [
        ((9, 9), "arrays arrive as numpy in the port"),
        ((13, 14), "the port imports no jax"),
        ((65, 65), "a received array stays on the host (numpy), where "
                   "the reference puts it on the device")],
    "elements/scheme_rtsp.py": [
        ((10, 10), "decoded frames are numpy arrays in the port"),
        ((30, 31), "the port imports no jax"),
        ((205, 205), "a decoded network frame stays on the host "
                     "(numpy)")],
    "media_convert.py": [
        ((65, 65), "the conversion pipelines run on the torch runtime; "
                   "the port refuses 'jax'"),
        ((90, 90), "the same for video_to_images")],
    "faults/chaos.py": [
        ((74, 74), "the chaos fleet's pipelines run on the torch runtime; "
                   "the port refuses 'jax'"),
        ((161, 161), "the spawned pipelines carve their placements from "
                     "eight CPU descriptors (AIKO_CPU_DEVICES, device.py), "
                     "as the JAX package's force eight host devices")],
    "cli.py": [
        ((127, 128), "--profile writes a torch.profiler Chrome trace "
                     "with per-element spans (tpu/profiling.py), not a "
                     "jax.profiler trace for TensorBoard/xprof"),
        ((535, 535), "the loadgen pipeline runs on the torch runtime; "
                     "the port refuses 'jax'"),
        ((792, 792), "convert writes the port's safetensors checkpoints "
                     "(models/checkpoint.py): the port has no orbax"),
        ((800, 800), "convert llama: the same (the command calls the "
                     "port's models/convert.py)"),
        ((816, 816), "convert detector: the same")],
    "pipeline/pipeline.py": [
        ((688, 688), "the bring-up is torch.distributed's "
                     "(parallel/distributed.py)"),
        ((702, 702), "the bring-up error names torch.distributed and the "
                     "coordinator"),
        ((1872, 1872), "the claimed pipe arrays go onto the head "
                       "stage's lead card through pinned memory, counted "
                       "(StagePlacement.upload): the port's stage hop "
                       "leaves host values on the host"),
        ((3661, 3661), "the hop site starts with no handles (a stage of "
                       "another process yields them)"),
        ((3672, 3676), "in a real multi-host mesh the hop runs over the "
                       "process group (StagePlacement.hop_across) and a "
                       "failed hop fails the frame; the virtual mesh keeps "
                       "the reference's transfer"),
        ((3686, 3686), "a stage of another process is not called here: "
                       "its outputs are handles naming that process, as "
                       "a JAX array of another host is not addressable")],
    "observability/recorder.py": [
        ((53, 53), "exports the process ring (SpanRecorder, "
                   "process_recorder, PROCESS_CAPACITY)"),
        ((90, 90), "EVENT_TYPES names the spans the port's serving paths "
                   "write to the process ring"),
        ((248, 248), "the process-wide ring of spans: the port's batcher, "
                     "device loop, micro-batcher and LLM worker record "
                     "where a request's and a frame's time goes")],
    "pipeline/journal.py": [
        ((83, 87), "_encodable skips torch-typed leaves (the exact "
                   "translation of the jax test): a CUDA tensor would "
                   "pass the jax test, and the journal would copy every "
                   "device input to the host at ingest")],
}

#: (module, imported module, name) -> why the copy keeps an import the
#: port cannot resolve yet.
UNRESOLVED_IMPORTS = {}

#: rewritten module -> definitions it keeps verbatim.
KEPT_DEFINITIONS = {
    "pipeline/fusion.py": ("FusionError", "DeviceFn", "_Step", "fusable",
                           "qualified_reads", "partition"),
    "pipeline/tensor.py": ("distributed_mesh_spec",),
    # (MicroBatcher is the JAX package's with its spans added.)
    "models/batching.py": ("complete_error", "MicroBatchElement"),
    "models/detector.py": ("DetectorConfig", "_bottleneck", "_run_stage"),
    "tpu/health.py": ("probe_devices",),
    "elements/audio.py": ("read_wav", "write_wav", "AudioWriteFile",
                          "AudioGraphXY", "AudioOutput"),
    "elements/image.py": ("image_to_array", "ImageOutput"),
    "elements/speech.py": ("_chunk_rows",),
    "models/asr.py": ("AsrConfig", "_mel_filterbank", "pad_audio",
                      "_sinusoid", "decode_text", "encode_text"),
    "models/tts.py": ("TtsConfig", "encode_text", "_mel_filterbank_for"),
}


def _copied() -> list[str]:
    modules = [str(path.relative_to(REFERENCE))
               for directory in COPIED_DIRECTORIES
               for path in sorted((REFERENCE / directory).glob("*.py"))]
    return modules + list(COPIED_FILES)


def _renamed(path: Path) -> str:
    return path.read_text().replace("aiko_services_tpu",
                                    "aiko_services_tpu_torch")


def _hunks(module: str) -> list[tuple[int, int]]:
    """Reference line spans where the port's copy differs."""
    reference = _renamed(REFERENCE / module).splitlines()
    port = (PORT / module).read_text().splitlines()
    matcher = difflib.SequenceMatcher(None, reference, port,
                                      autojunk=False)
    return [(first + 1, max(last, first + 1))
            for tag, first, last, _, _ in matcher.get_opcodes()
            if tag != "equal"]


@pytest.mark.parametrize("module", _copied())
def test_copy_matches_reference(module):
    assert (PORT / module).is_file(), f"{module} is not copied"
    hunks = _hunks(module)
    allowed = ALLOWED.get(module, [])

    def covered(hunk, span):
        return span[0] <= hunk[0] and hunk[1] <= span[1]
    unlisted = [hunk for hunk in hunks
                if not any(covered(hunk, span) for span, _ in allowed)]
    assert not unlisted, (f"{module}: reference lines {unlisted} differ "
                          f"from the copy and are not allowlisted")
    stale = [span for span, _ in allowed
             if not any(covered(hunk, span) for hunk in hunks)]
    assert not stale, f"{module}: allowlist entries {stale} differ no more"
    assert all(reason.strip() for _, reason in allowed)


def test_allowlist_names_copied_modules():
    assert set(ALLOWED) <= set(_copied())
    assert {module for module, _, _ in UNRESOLVED_IMPORTS} <= set(_copied())


def _relative_imports(module: str):
    tree = ast.parse((PORT / module).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            for alias in node.names:
                yield "." * node.level + (node.module or ""), alias.name


@pytest.mark.parametrize("module", _copied())
def test_copied_imports_resolve_in_port(module):
    package = "aiko_services_tpu_torch." + ".".join(
        Path(module).with_suffix("").parts[:-1])
    if module.endswith("__init__.py"):
        package = "aiko_services_tpu_torch." + ".".join(
            Path(module).parts[:-1])
    missing = []
    for source, name in _relative_imports(module):
        if (module, source, name) in UNRESOLVED_IMPORTS:
            continue
        try:
            target = importlib.import_module(source, package.rstrip("."))
        except ImportError:
            missing.append((source, name))
            continue
        if name != "*" and not hasattr(target, name):
            try:
                importlib.import_module(f"{target.__name__}.{name}")
            except ImportError:
                missing.append((source, name))
    assert not missing, f"{module}: unresolved imports {missing}"


def test_unresolved_imports_are_still_copied_and_unresolved():
    for (module, source, name), reason in UNRESOLVED_IMPORTS.items():
        assert reason.strip()
        assert (source, name) in set(_relative_imports(module))


def _definitions(path: Path, text: str) -> dict:
    tree = ast.parse(text)
    return {node.name: ast.get_source_segment(text, node)
            for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.ClassDef))}


@pytest.mark.parametrize("module, name", [
    (module, name) for module, names in KEPT_DEFINITIONS.items()
    for name in names])
def test_rewritten_module_keeps_definition(module, name):
    reference = _definitions(REFERENCE / module,
                             _renamed(REFERENCE / module))
    port = _definitions(PORT / module, (PORT / module).read_text())
    assert name in port, f"{module}: {name} is missing from the port"
    assert port[name] == reference[name]
