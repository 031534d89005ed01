"""Dataflow analysis over a pipeline definition (ISSUE 6 layer 1).

Statically replays the engine's walk: for every graph path (head), the
nodes execute in ``Graph.get_path`` topological order and each node's
outputs enter the swag under both the bare key and the
producer-qualified ``Node.key`` alias (mirroring
``Pipeline._map_out``).  Propagating that availability set through the
path decides, at *create* time, exactly what today only fails at frame
N: unbound inputs, mappings onto producers that never ran, colliding
parallel writers, signature-mismatched fallbacks, dead outputs, and
malformed placement/parameter blocks.

Everything here is definition-only -- no element class is loaded, no
module imported; the residency layer (analysis/residency.py) is the
one that looks inside element sources.
"""

from __future__ import annotations

from .findings import Finding
from .params import validate_element_parameters, validate_parameters
from ..utils import Graph, GraphError

__all__ = ["analyze_dataflow", "build_graph", "node_path_context"]


def build_graph(definition):
    """The definition's Graph, or a ``bad-graph`` finding list."""
    try:
        graph = Graph.traverse(definition.graph)
        graph.validate_acyclic()
        return graph, []
    except GraphError as error:
        return None, [Finding("bad-graph", str(error), definition.name)]


def node_path_context(definition, path_names, node_name: str) -> str:
    """``pipeline: head->...->node`` -- the graph-path-qualified prefix
    every definition finding (and pre-flight DefinitionError) carries."""
    if node_name in path_names:
        path_names = path_names[:path_names.index(node_name) + 1]
    return f"{definition.name}: {'->'.join(path_names)}"


def _required(io: dict) -> bool:
    return not str(io.get("type", "")).endswith("?") \
        and "default" not in io


def _ancestors(graph) -> dict:
    """node name -> set of names reachable FROM it (descendants)."""
    reach: dict[str, set] = {}

    def visit(node):
        if node.name in reach:
            return reach[node.name]
        reach[node.name] = set()        # cycle guard (validated acyclic)
        descendants = set()
        for successor in node.successors:
            descendants.add(successor.name)
            descendants |= visit(successor)
        reach[node.name] = descendants
        return descendants

    for node in graph.nodes():
        visit(node)
    return reach


class _Disables:
    def __init__(self, definition):
        self.pipeline = set(getattr(definition, "lint_disable", ()) or ())
        self.per_element = {}
        for element in definition.elements:
            disabled = getattr(element, "lint_disable", ()) or ()
            if disabled:
                self.per_element[element.name] = set(disabled)

    def active(self, rule: str, element: str | None) -> bool:
        if rule in self.pipeline:
            return False
        if element is not None \
                and rule in self.per_element.get(element, ()):
            return False
        return True


def analyze_dataflow(definition) -> list:
    findings: list[Finding] = []
    disables = _Disables(definition)

    def add(rule, message, where, element=None):
        if disables.active(rule, element):
            findings.append(Finding(rule, message, where))

    defs = {element.name: element for element in definition.elements}
    source = definition.name

    # -- placement + parameter sanity (graph-independent) --------------
    findings.extend(
        f for f in validate_parameters(definition.parameters, source)
        if disables.active("bad-parameter", None))
    # Element-level knob domains (ELEMENT_PARAMETERS, keyed by class):
    # a typo'd ``speculative`` mode or a negative page size fails here
    # at create time, not at frame N on the device worker.
    for element in definition.elements:
        deploy = element.deploy_local or {}
        class_name = deploy.get("class_name")
        if not class_name or not element.parameters:
            continue
        findings.extend(
            f for f in validate_element_parameters(
                class_name, element.parameters,
                f"{source}: {element.name}",
                module=deploy.get("module", ""))
            if disables.active("bad-parameter", element.name))
    # Binary data plane (ISSUE 9): forcing the tensor pipe on a
    # pipeline whose every element is local binds a socket no frame
    # will ever cross -- almost always a leftover from splitting a
    # definition, not intent (``auto`` negotiates per peer and is the
    # right default everywhere).
    if str(definition.parameters.get("data_plane", "")).strip().lower() \
            == "tensor_pipe" \
            and not any(element.deploy_remote is not None
                        for element in definition.elements):
        add("data-plane-on-local",
            "data_plane: tensor_pipe, but no element is "
            "remote-deployed -- no frame ever leaves this process, so "
            "the pipe endpoint serves nothing (use 'auto', which "
            "negotiates per peer)",
            f"{source}.parameters.data_plane")

    # Placement validity itself comes from the ONE shared authority
    # (definition.placement_error), which _build_placement also raises
    # from -- the rule here only adds the lint packaging.
    from ..pipeline.definition import placement_error

    for element in definition.elements:
        block = element.placement
        spot = f"{source}: {element.name}.placement"
        if not block:
            continue
        if element.deploy_remote is not None:
            add("placement-remote",
                f"element {element.name!r} is remote-deployed; its "
                f"placement block places nothing locally", spot,
                element.name)
        problem = placement_error(block)
        if problem is not None:
            add("bad-placement", problem, spot, element.name)
        elif "replicas" in block and "mesh" not in block \
                and "devices" not in block:
            add("replicas-on-unplaced",
                f"element {element.name!r} declares "
                f"replicas={block['replicas']!r} but no mesh/devices "
                f"-- the stage is unplaced, so the replica group "
                f"never forms", spot, element.name)

    # -- fallback signature parity --------------------------------------
    for element in definition.elements:
        if not element.fallback or element.fallback not in defs:
            continue                    # existence: definition.py's job
        target = defs[element.fallback]
        # By-name comparison: the engine binds inputs/outputs by name
        # (mappings, **inputs), so declaration order is irrelevant.
        if set(target.input_names) != set(element.input_names) \
                or set(target.output_names) != set(element.output_names):
            add("fallback-mismatch",
                f"fallback {element.fallback!r} "
                f"({target.input_names}->{target.output_names}) does "
                f"not match remote stage {element.name!r} "
                f"({element.input_names}->{element.output_names}); "
                f"downstream mappings would break in degraded mode",
                f"{source}: {element.name}.fallback", element.name)

    graph, graph_findings = build_graph(definition)
    findings.extend(graph_findings)
    if graph is None:
        return findings

    # -- unknown graph nodes / unused element definitions ---------------
    fallback_targets = {element.fallback
                        for element in definition.elements
                        if element.fallback}
    for node in graph.nodes():
        if node.name not in defs:
            add("unknown-element",
                f"no element definition for {node.name!r}",
                f"{source}: {node.name}")
    for element in definition.elements:
        if element.name not in graph \
                and element.name not in fallback_targets:
            add("unused-element",
                f"element {element.name!r} appears in no graph path "
                f"and is no fallback target",
                f"{source}: {element.name}", element.name)

    descendants = _ancestors(graph)

    def unordered(a: str, b: str) -> bool:
        return b not in descendants.get(a, ()) \
            and a not in descendants.get(b, ())

    consumed: set[tuple] = set()        # (producer node, output name)
    bare_reads: list[tuple] = []        # (reader, bare key, path nodes)
    # (node, input) -> list of (bad message | None, context) per path:
    # a shared tail node may map from a producer that only exists on
    # SOME of its paths -- that is the multi-path idiom, not a bug, so
    # bad-mapping fires only when the mapping is dead on EVERY path.
    qualified_maps: dict[tuple, list] = {}

    for head in graph.heads:
        path = [node for node in graph.get_path(head.name)
                if node.name in defs]
        path_names = [node.name for node in path]
        if not path:
            continue
        head_inputs = set(defs[path_names[0]].input_names)
        available: dict[str, list] = {}  # swag key -> writers, walk order
        for index, node in enumerate(path):
            element = defs[node.name]
            context = node_path_context(definition, path_names,
                                        node.name)
            mapping = node.properties or {}
            for io in element.input:
                input_name = io["name"]
                key = mapping.get(input_name, input_name)
                if not isinstance(key, str):
                    continue
                if "." in key:
                    producer_name, _, out = key.partition(".")
                    producer = defs.get(producer_name)
                    verdicts = qualified_maps.setdefault(
                        (node.name, input_name), [])
                    where = f"{context}: {node.name}.input.{input_name}"
                    if producer is None \
                            or producer_name not in path_names[:index]:
                        verdicts.append((
                            f"input {input_name!r} maps from {key!r}, "
                            f"but {producer_name!r} runs nowhere "
                            f"upstream on this path", where))
                    elif out not in producer.output_names:
                        verdicts.append((
                            f"input {input_name!r} maps from {key!r}, "
                            f"but {producer_name!r} declares no "
                            f"output {out!r} (outputs: "
                            f"{producer.output_names})", where))
                    else:
                        verdicts.append((None, where))
                        consumed.add((producer_name, out))
                    continue
                if key in available:
                    # A bare read is satisfied by the latest writer in
                    # walk order, but ANY prior writer may be the one
                    # the author meant -- all count as consumed.
                    for producer_name in available[key]:
                        consumed.add((producer_name, key))
                    bare_reads.append((node.name, key,
                                       frozenset(path_names)))
                elif index == 0 or key in head_inputs:
                    pass                # frame data feeds the head
                elif _required(io):
                    add("unbound-input",
                        f"required input {input_name!r} (swag key "
                        f"{key!r}) is produced by no upstream element "
                        f"and is not a declared input of head "
                        f"{path_names[0]!r} -- only ad-hoc frame data "
                        f"could satisfy it",
                        f"{context}: {node.name}.input.{input_name}",
                        node.name)
            for out in element.output_names:
                writers = available.setdefault(out, [])
                if node.name not in writers:
                    writers.append(node.name)
                available.setdefault(f"{node.name}.{out}",
                                     []).append(node.name)

    # -- qualified mappings dead on every path ---------------------------
    for (node_name, _input_name), verdicts in sorted(
            qualified_maps.items()):
        if any(message is None for message, _ in verdicts):
            continue                    # satisfiable on some path
        message, where = verdicts[0]
        add("bad-mapping", message, where, node_name)

    # -- parallel branches racing for a bare key at a join ---------------
    # The engine's walk order is a deterministic total order, so a
    # sibling-sequence graph ("(read resample asr ...)") that reuses a
    # key is fine: each read binds to the latest prior writer.  The
    # genuinely ambiguous shape is a JOIN -- a reader downstream of two
    # writers that have no ordering between THEM; then sibling listing
    # order, not dataflow, decides which branch's value wins.
    # A stream runs ONE graph path, so only writers on the reader's
    # own path can race -- alternative heads sharing a tail never
    # co-execute.
    reported: set[tuple] = set()
    for reader, key, path_nodes in bare_reads:
        ancestors = sorted(
            name for name, below in descendants.items()
            if reader in below and name in path_nodes and name in defs
            and key in defs[name].output_names)
        for i in range(len(ancestors)):
            for j in range(i + 1, len(ancestors)):
                first, second = ancestors[i], ancestors[j]
                if not unordered(first, second):
                    continue
                mark = (key, first, second)
                if mark in reported:
                    continue
                reported.add(mark)
                add("key-collision",
                    f"{first!r} and {second!r} both write swag key "
                    f"{key!r} on parallel branches joined at "
                    f"{reader!r}; which value wins depends on graph "
                    f"listing order, not dataflow",
                    f"{source}: {second}.output.{key}", second)

    # -- dead outputs ----------------------------------------------------
    for node in graph.nodes():
        if not node.successors or node.name not in defs:
            continue                    # terminal outputs ARE the result
        element = defs[node.name]
        for out in element.output_names:
            if (node.name, out) not in consumed:
                add("dead-output",
                    f"output {out!r} of {node.name!r} is consumed by "
                    f"no downstream element",
                    f"{source}: {node.name}.output.{out}", node.name)
    return findings
