"""The port's engine is a COPY of the JAX package's jax-free modules with
the package name as the only change; this test keeps it so.

For every copied module, the port's text is compared line by line with
the reference's text after the rename (``aiko_services_tpu`` ->
``aiko_services_tpu_torch``).  Every difference must fall inside an
entry of :data:`ALLOWED` -- a span of the REFERENCE's lines with the
reason the port cannot keep them -- and every entry must still cover a
difference (a fixed reference or a reverted port makes it stale).

The rewritten modules (``pipeline/overlap.py``, ``pipeline/fusion.py``,
``pipeline/tensor.py``) are ports, not copies; the definitions they
keep verbatim are held to the reference one by one
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
    "elements/expression.py")

#: module -> [((first, last) reference lines, reason)].  An insertion
#: sits at the reference line it precedes.
ALLOWED = {
    "utils/__init__.py": [
        ((12, 12), "exports not_ported, the error the port raises for an "
                   "option of the JAX package that waits for a ROADMAP "
                   "item (earlier slices of the port use it)")],
    "utils/misc.py": [
        ((19, 30), "adds not_ported (see utils/__init__.py)")],
    "analysis/params.py": [
        ((348, 348), "ELEMENT_PARAMETERS gains the port LLM's `device` "
                     "parameter (the port's device rule, device.py)")],
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
    "pipeline/definition.py": [
        ((24, 24), "the port's runtimes are python and torch; 'jax' is "
                   "refused and the message names torch (ROADMAP "
                   "Queue 3)"),
        ((218, 218), "torch is the default runtime")],
    "pipeline/journal.py": [
        ((83, 87), "_encodable skips torch-typed leaves (the exact "
                   "translation of the jax test): a CUDA tensor would "
                   "pass the jax test, and the journal would copy every "
                   "device input to the host at ingest")],
    "pipeline/pipeline.py": [
        ((710, 710), "any placement block raises DefinitionError "
                     "(not_ported, ROADMAP Queue 1 item 6) instead of "
                     "placing the stage; the rest of _build_placement "
                     "stays as copied and is unreachable until then")],
    "pipeline/__init__.py": [
        ((17, 18), "TPUElement, JitCache, StagePlacement and "
                   "tree_device_put are not in the port's tensor.py "
                   "yet (ROADMAP Queue 1 item 6)")],
    "elements/common.py": [
        ((6, 12), "StageWork (a TPUElement) and its imports wait for "
                  "the port's placed element base (ROADMAP Queue 1 "
                  "item 6)"),
        ((46, 68), "StageWork itself, for the same reason")],
}

#: (module, imported module, name) -> why the copy keeps an import the
#: port cannot resolve yet.
UNRESOLVED_IMPORTS = {
    ("pipeline/pipeline.py", "..tpu.health", "probe_devices"):
        "the device-health probe runs only for a placed pipeline, and a "
        "placement block raises first",
    ("pipeline/pipeline.py", "..tpu.health", "default_prober"):
        "the device-health probe runs only for a placed pipeline",
    ("pipeline/pipeline.py", ".tensor", "StagePlacement"):
        "reached only from a placement block, which raises first",
    ("pipeline/pipeline.py", ".tensor", "TPUElement"):
        "reached only by device replacement and replica paths of a "
        "placed pipeline",
}

#: rewritten module -> definitions it keeps verbatim.
KEPT_DEFINITIONS = {
    "pipeline/fusion.py": ("FusionError", "DeviceFn", "_Step", "fusable",
                           "qualified_reads", "partition"),
    "pipeline/tensor.py": ("distributed_mesh_spec",),
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
