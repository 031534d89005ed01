"""Pipeline definitions: typed dataclasses + JSON validation (reference:
src/aiko_services/main/pipeline.py:222-258 dataclasses and the inline Avro
schema at pipeline.py:1693-1822).

The reference validates with Avro; this build uses a hand-rolled validator
with precise error paths (no extra dependency) over the same information:
name, version, runtime, graph (S-expression strings), optional default
parameters, and one entry per element with input/output signatures and a
deploy descriptor (local module / remote service filter).

TPU extension: element definitions may carry a ``placement`` block --
``{"devices": 4, "mesh": {"tp": 4}}`` -- consumed by the tpu substrate to
place the element's compute onto a submesh.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

__all__ = ["PipelineDefinition", "ElementDefinition", "DefinitionError",
           "parse_pipeline_definition", "load_pipeline_definition"]

RUNTIMES = ("python", "torch")


class DefinitionError(ValueError):
    pass


@dataclass
class ElementDefinition:
    name: str
    input: list          # [{"name": ..., "type": ...}]
    output: list
    deploy_local: dict | None = None      # {"module": ..., "class_name": ...}
    deploy_remote: dict | None = None     # ServiceFilter fields
    parameters: dict = field(default_factory=dict)
    placement: dict = field(default_factory=dict)
    # Degraded-mode failover (ISSUE 5): the name of another (locally
    # deployed, off-graph) element definition to run in place of this
    # remote stage while its circuit breaker is open.
    fallback: str | None = None
    # Static-analysis escape hatch (ISSUE 6): ``"lint": ["dead-output"]``
    # suppresses those rules for THIS element in aiko_lint/pre-flight.
    lint_disable: tuple = ()

    @property
    def input_names(self) -> list[str]:
        return [io["name"] for io in self.input]

    @property
    def output_names(self) -> list[str]:
        return [io["name"] for io in self.output]


@dataclass
class PipelineDefinition:
    name: str
    version: int
    runtime: str
    graph: list[str]
    parameters: dict = field(default_factory=dict)
    elements: list[ElementDefinition] = field(default_factory=list)
    # Pipeline-wide lint suppressions (``"lint": [...]`` at top level).
    lint_disable: tuple = ()

    def element(self, name: str) -> ElementDefinition:
        for element in self.elements:
            if element.name == name:
                return element
        raise DefinitionError(
            f"pipeline {self.name!r}: graph node {name!r} has no "
            f"element definition (defined: {self.element_names()})")

    def element_names(self) -> list[str]:
        return [e.name for e in self.elements]


def _require(data: dict, key: str, kind, path: str):
    if key not in data:
        raise DefinitionError(f"{path}: missing required field {key!r}")
    value = data[key]
    if kind is not None and not isinstance(value, kind):
        raise DefinitionError(
            f"{path}.{key}: expected {getattr(kind, '__name__', kind)}, "
            f"got {type(value).__name__}")
    return value


def _parse_io(entries, path: str) -> list:
    if not isinstance(entries, list):
        raise DefinitionError(f"{path}: expected a list")
    result = []
    for i, entry in enumerate(entries):
        if not isinstance(entry, dict):
            raise DefinitionError(f"{path}[{i}]: expected an object")
        name = _require(entry, "name", str, f"{path}[{i}]")
        io_type = entry.get("type", "any")
        result.append({"name": name, "type": io_type})
    return result


def _parse_lint(value, path: str) -> tuple:
    """``"lint": ["rule-a", ...]`` -- per-definition static-analysis
    suppressions (the JSON twin of ``# aiko-lint: disable=...``).
    Unknown rule ids are rejected: a typo'd suppression that silently
    does nothing is exactly the kind of frame-N surprise lint exists
    to prevent."""
    if value is None:
        return ()
    if not isinstance(value, list) \
            or not all(isinstance(rule, str) for rule in value):
        raise DefinitionError(
            f"{path}.lint: expected a list of rule-id strings")
    from ..analysis.findings import RULES     # dependency-free module

    unknown = sorted(set(value) - set(RULES))
    if unknown:
        raise DefinitionError(
            f"{path}.lint: unknown rule(s) {unknown}; see "
            f"'aiko_lint --rules' for the catalogue")
    return tuple(value)


def _replicas_error(spec) -> str | None:
    """Why a placement ``replicas`` spec is malformed, or None.  Domain:
    a count (int >= 1), ``"auto"`` (the control loop scales 1..pool),
    or ``{"min": lo, "max": hi}`` autoscale bounds with 1 <= lo <= hi."""
    if isinstance(spec, bool):
        return f"replicas must be a count >= 1, 'auto' or " \
               f"{{min, max}}, got {spec!r}"
    if isinstance(spec, int):
        if spec < 1:
            return f"replicas must be >= 1, got {spec}"
        return None
    if isinstance(spec, str):
        if spec.strip().lower() != "auto":
            return f"replicas must be a count >= 1, 'auto' or " \
                   f"{{min, max}}, got {spec!r}"
        return None
    if isinstance(spec, dict):
        if not set(spec) <= {"min", "max"}:
            return f"replicas bounds accept only min/max, " \
                   f"got {sorted(spec)}"
        low, high = spec.get("min", 1), spec.get("max")
        for name, value in (("min", low), ("max", high)):
            if value is not None and (not isinstance(value, int)
                                      or isinstance(value, bool)
                                      or value < 1):
                return f"replicas {name} must be an int >= 1, " \
                       f"got {value!r}"
        if high is not None and low > high:
            return f"replicas min ({low}) must be <= max ({high})"
        return None
    return f"replicas must be a count >= 1, 'auto' or {{min, max}}, " \
           f"got {spec!r}"


def placement_error(block: dict) -> str | None:
    """Why this placement block is malformed, or None.  The ONE
    authority shared by ``Pipeline._build_placement`` (create-time
    raise) and the dataflow analyzer's ``bad-placement`` rule, so the
    two can never drift."""
    if "replicas" in block:
        problem = _replicas_error(block["replicas"])
        if problem:
            return problem
    if "host" in block:
        # Mesh mode (ISSUE 9): pins the stage to one host group of a
        # ``mesh: {hosts: N}`` pipeline; range-checked at carve time
        # (the group count depends on the live mesh).
        host = block["host"]
        if not isinstance(host, int) or isinstance(host, bool) \
                or host < 0:
            return (f"placement host must be a non-negative host "
                    f"index, got {host!r}")
    if "mesh" in block:
        mesh = block["mesh"]
        if not isinstance(mesh, dict) or not mesh or not all(
                isinstance(v, int) and not isinstance(v, bool) and v > 0
                for v in mesh.values()):
            return (f"mesh must map axis names to positive chip "
                    f"counts, got {mesh!r}")
        return None
    if "devices" in block:
        want = block["devices"]
        if isinstance(want, str):
            if want.strip().lower() != "auto":
                return (f"placement devices must be a chip count or "
                        f"'auto', got {want!r}")
        elif not isinstance(want, int) or isinstance(want, bool) \
                or want <= 0:
            return (f"placement devices must be a positive chip "
                    f"count or 'auto', got {want!r}")
        return None
    if "replicas" in block:
        # ``replicas`` without mesh/devices places nothing -- legal at
        # create (the ``replicas-on-unplaced`` lint rule warns), so a
        # definition can declare bounds before committing chips.
        return None
    return f"placement needs 'mesh' or 'devices', got {sorted(block)}"


def parse_pipeline_definition(data: dict | str,
                              source: str = "<definition>") \
        -> PipelineDefinition:
    if isinstance(data, str):
        try:
            data = json.loads(data)
        except json.JSONDecodeError as error:
            raise DefinitionError(f"{source}: invalid JSON: {error}")
    if not isinstance(data, dict):
        raise DefinitionError(f"{source}: definition must be an object")

    name = _require(data, "name", str, source)
    version = data.get("version", 0)
    runtime = data.get("runtime", "torch")
    if runtime not in RUNTIMES:
        raise DefinitionError(
            f"{source}.runtime: {runtime!r} not one of {RUNTIMES}")
    graph = _require(data, "graph", list, source)
    if not graph or not all(isinstance(g, str) for g in graph):
        raise DefinitionError(
            f"{source}.graph: expected non-empty list of S-expression "
            f"strings")
    parameters = data.get("parameters", {})
    if not isinstance(parameters, dict):
        raise DefinitionError(f"{source}.parameters: expected an object")
    lint_disable = _parse_lint(data.get("lint"), source)

    elements_data = _require(data, "elements", list, source)
    elements = []
    seen = set()
    for i, entry in enumerate(elements_data):
        path = f"{source}.elements[{i}]"
        if not isinstance(entry, dict):
            raise DefinitionError(f"{path}: expected an object")
        element_name = _require(entry, "name", str, path)
        if element_name in seen:
            raise DefinitionError(f"{path}: duplicate element "
                                  f"{element_name!r}")
        seen.add(element_name)
        deploy = entry.get("deploy", {})
        deploy_local = deploy.get("local")
        deploy_remote = deploy.get("remote")
        if deploy_local is None and deploy_remote is None:
            raise DefinitionError(
                f"{path}.deploy: needs 'local' (module[, class_name]) or "
                f"'remote' (service filter)")
        if deploy_local is not None:
            _require(deploy_local, "module", str, f"{path}.deploy.local")
        fallback = entry.get("fallback")
        if fallback is not None:
            if not isinstance(fallback, str):
                raise DefinitionError(f"{path}.fallback: expected an "
                                      f"element name string")
            if deploy_remote is None:
                raise DefinitionError(
                    f"{path}.fallback: only remote-deployed elements "
                    f"may declare a fallback")
        elements.append(ElementDefinition(
            name=element_name,
            input=_parse_io(entry.get("input", []), f"{path}.input"),
            output=_parse_io(entry.get("output", []), f"{path}.output"),
            deploy_local=deploy_local,
            deploy_remote=deploy_remote,
            parameters=entry.get("parameters", {}),
            placement=entry.get("placement", {}),
            fallback=fallback,
            lint_disable=_parse_lint(entry.get("lint"), path)))

    names = {element.name for element in elements}
    for element in elements:
        if element.fallback is None:
            continue
        if element.fallback not in names:
            raise DefinitionError(
                f"{source}: element {element.name!r} fallback "
                f"{element.fallback!r} is not a defined element")
        target = next(e for e in elements if e.name == element.fallback)
        if target.deploy_local is None:
            raise DefinitionError(
                f"{source}: fallback {element.fallback!r} must be "
                f"locally deployed (it runs when the remote is down)")

    return PipelineDefinition(name=name, version=version, runtime=runtime,
                              graph=list(graph), parameters=parameters,
                              elements=elements,
                              lint_disable=lint_disable)


def load_pipeline_definition(pathname: str) -> PipelineDefinition:
    with open(pathname) as fh:
        return parse_pipeline_definition(fh.read(), source=pathname)
