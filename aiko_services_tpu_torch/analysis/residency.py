"""Residency & fusion analysis: AST inspection of element classes
(ISSUE 6 layer 2).

The device-resident swag contract (PR 1) and fused segments (PR 2) are
enforced at runtime by the transfer guard -- which means an element
that quietly calls ``np.asarray`` on a device input only fails at
frame N under ``transfer_guard: disallow``, and a ``DeviceFn`` whose
trace body syncs only poisons its segment on first trace.  This module
finds both *without importing the element module*: sources are
``ast``-parsed (jax never loads), class attribute chains
(``host_inputs``, ``device_resident``) are resolved across modules by
following import statements, and host-materializing calls are traced
through one level of module-local helper functions (``as_uint8``,
``write_wav``-style wrappers).

Rules produced here: ``undeclared-host-input``,
``device-fn-host-call``, ``unread-parameter``, ``donation-alias``.
"""

from __future__ import annotations

import ast
import os
from pathlib import Path

from .dataflow import build_graph, node_path_context, _Disables
from .findings import Finding, disabled_rules_for_line

__all__ = ["ModuleIndex", "analyze_definition_residency",
           "analyze_element_sources"]

REPO_ROOT = Path(__file__).resolve().parents[2]

#: numpy entry points that materialize their argument on host.
_NP_FORCING = {"asarray", "array", "ascontiguousarray", "frombuffer"}
#: tensor methods that copy their tensor to the host (no arguments).
_TENSOR_FORCING = {"item", "cpu", "numpy", "tolist"}


def _tensor_host_copy(call: ast.Call) -> str | None:
    """``x.item()``, ``x.cpu()``, ``x.numpy()``, ``x.tolist()`` or
    ``x.to("cpu")`` (also ``device="cpu"``): the description of the
    host copy ``call`` makes, else None."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return None
    if func.attr in _TENSOR_FORCING and not call.args:
        return f".{func.attr}()"
    if func.attr == "to":
        targets = call.args[:1] + [keyword.value
                                   for keyword in call.keywords
                                   if keyword.arg == "device"]
        if any(isinstance(target, ast.Constant)
               and str(target.value).split(":")[0] == "cpu"
               for target in targets):
            return '.to("cpu")'
    return None
#: classes that mark "this is a pipeline element" when found in a
#: resolved base chain (or, unresolved, by bare base name).
_ELEMENT_BASES = {"PipelineElement", "PipelineElementLoop", "TPUElement",
                  "DataSource", "DataTarget", "MicroBatchElement"}
#: non-input leading parameters of the element entry points.
_CONTROL_PARAMS = {"self", "cls", "stream", "complete"}
_ENTRY_METHODS = ("process_frame", "process_frame_start")


class _ClassInfo:
    __slots__ = ("name", "lineno", "bases", "attrs", "attr_strings",
                 "methods", "module")

    def __init__(self, node: ast.ClassDef, module: "_ModuleInfo"):
        self.name = node.name
        self.lineno = node.lineno
        self.module = module
        self.bases = []
        for base in node.bases:
            if isinstance(base, ast.Name):
                self.bases.append(base.id)
            elif isinstance(base, ast.Attribute):
                self.bases.append(base.attr)
        self.attrs: dict[str, ast.expr] = {}
        self.attr_strings: set[str] = set()
        self.methods: dict[str, ast.FunctionDef] = {}
        for statement in node.body:
            if isinstance(statement, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                self.methods[statement.name] = statement
            elif isinstance(statement, ast.Assign):
                for target in statement.targets:
                    if isinstance(target, ast.Name):
                        self.attrs[target.id] = statement.value
                for constant in ast.walk(statement.value):
                    if isinstance(constant, ast.Constant) \
                            and isinstance(constant.value, str):
                        self.attr_strings.add(constant.value)
            elif isinstance(statement, ast.AnnAssign) \
                    and isinstance(statement.target, ast.Name) \
                    and statement.value is not None:
                self.attrs[statement.target.id] = statement.value


class _ModuleInfo:
    def __init__(self, path: Path, index: "ModuleIndex"):
        self.path = path
        self.index = index
        text = path.read_text()
        self.lines = text.splitlines()
        self.tree = ast.parse(text)
        self.classes: dict[str, _ClassInfo] = {}
        self.functions: dict[str, ast.FunctionDef] = {}
        #: local name -> dotted module (``import numpy as np``)
        self.module_aliases: dict[str, str] = {}
        #: local name -> (resolved file, original name) for
        #: ``from X import Y [as Z]``
        self.imports: dict[str, tuple] = {}
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef):
                self.classes[node.name] = _ClassInfo(node, self)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    self.module_aliases[alias.asname or
                                        alias.name.split(".")[0]] = \
                        alias.name
            elif isinstance(node, ast.ImportFrom):
                target = index.resolve_spec(node.module or "",
                                            level=node.level,
                                            relative_to=path)
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    self.imports[alias.asname or alias.name] = \
                        (target, alias.name)
        self._forcing: set | None = None

    # -- name resolution ---------------------------------------------------

    def numpy_alias(self, root: str) -> bool:
        return self.module_aliases.get(root, root) == "numpy"

    def jax_alias(self, root: str) -> bool:
        return self.module_aliases.get(root, root) == "jax"

    def line_disables(self, lineno: int) -> set:
        if 1 <= lineno <= len(self.lines):
            return disabled_rules_for_line(self.lines[lineno - 1])
        return set()

    # -- host-forcing helper functions --------------------------------------

    def forcing_callables(self) -> set:
        """Names callable from this module whose body host-materializes
        an argument: imported functions (one hop) seeded FIRST, then a
        fixpoint over local functions -- so a local wrapper around an
        imported forcing helper is caught too."""
        if self._forcing is not None:
            return self._forcing
        self._forcing = set()           # cycle guard
        forcing: set[str] = set()
        for name, (target, original) in self.imports.items():
            if target is None:
                continue
            module = self.index.module(target)
            if module is None or module is self:
                continue
            if original in module.forcing_callables():
                forcing.add(name)
        changed = True
        while changed:
            changed = False
            for name, func in self.functions.items():
                if name in forcing:
                    continue
                params = {arg.arg for arg in func.args.args
                          if arg.arg not in _CONTROL_PARAMS}
                if _host_force_hits(self, func, params,
                                    extra_forcing=forcing):
                    forcing.add(name)
                    changed = True
        self._forcing = forcing
        return forcing

    def forcing_fast(self) -> set:
        """The computed forcing set if the fixpoint has run, else empty
        -- what _host_force_hits may consult while the fixpoint is
        still in progress (callers then pass the in-progress set via
        ``extra_forcing``)."""
        return self._forcing if self._forcing is not None else set()


def _call_root(node: ast.expr):
    """('np', 'asarray') for ``np.asarray``; (None, 'float') for bare
    names; follows one attribute level only."""
    if isinstance(node, ast.Attribute) and isinstance(node.value,
                                                      ast.Name):
        return node.value.id, node.attr
    if isinstance(node, ast.Name):
        return None, node.id
    return None, None


def _is_self_method_call(node: ast.expr) -> bool:
    """``self._dispatch(image)``-style: the call RESULT is a new value
    (e.g. a device computation's output), not the input itself, so a
    host fetch of it is not a fetch of the input."""
    return isinstance(node, ast.Call) \
        and isinstance(node.func, ast.Attribute) \
        and isinstance(node.func.value, ast.Name) \
        and node.func.value.id == "self"


def _tracked_arg(call: ast.Call, tracked: set):
    for arg in call.args:
        if isinstance(arg, ast.Name) and arg.id in tracked:
            return arg.id
        if isinstance(arg, ast.Call) \
                and not _is_self_method_call(arg):
            # np.asarray(np.stack(image)) still forces image; but the
            # result of a self-method is a different value entirely.
            inner = _tracked_arg(arg, tracked)
            if inner is not None:
                return inner
    for keyword in call.keywords:
        if isinstance(keyword.value, ast.Name) \
                and keyword.value.id in tracked:
            return keyword.value.id
    return None


def _host_force_hits(module: _ModuleInfo, func, tracked: set,
                     extra_forcing: set = frozenset()) -> list:
    """(lineno, input name, call description) for every
    host-materializing call applied to a tracked input inside
    ``func``."""
    hits = []
    tracked = set(tracked)
    forcing = extra_forcing | module.forcing_fast()
    for node in ast.walk(func):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            value = node.value
            if isinstance(value, ast.Name) and value.id in tracked:
                tracked.add(node.targets[0].id)
        if not isinstance(node, ast.Call):
            continue
        root, attr = _call_root(node.func)
        name = None
        if root is not None and module.numpy_alias(root) \
                and attr in _NP_FORCING:
            name = _tracked_arg(node, tracked)
            description = f"{root}.{attr}()"
        elif root is not None and module.jax_alias(root) \
                and attr == "device_get":
            name = _tracked_arg(node, tracked)
            description = f"{root}.device_get()"
        elif (host_copy := _tensor_host_copy(node)) is not None \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id in tracked:
            name, description = node.func.value.id, host_copy
        elif root is None and attr in forcing:
            name = _tracked_arg(node, tracked)
            description = f"{attr}() (host-materializing helper)"
        if name is not None:
            hits.append((node.lineno, name, description))
    return hits


def _device_fn_hits(module: _ModuleInfo, method) -> list:
    """Host-transfer calls inside the device-pure trace bodies a
    ``device_fn`` method builds (the ``fn=`` of each DeviceFn)."""
    nested = {node.name: node for node in ast.walk(method)
              if isinstance(node, ast.FunctionDef)
              and node is not method}
    bodies = []
    for node in ast.walk(method):
        if not isinstance(node, ast.Call):
            continue
        _, attr = _call_root(node.func)
        if attr != "DeviceFn":
            continue
        for keyword in node.keywords:
            if keyword.arg != "fn":
                continue
            if isinstance(keyword.value, ast.Lambda):
                bodies.append(keyword.value)
            elif isinstance(keyword.value, ast.Name) \
                    and keyword.value.id in nested:
                bodies.append(nested[keyword.value.id])
    hits = []
    for body in bodies:
        for node in ast.walk(body):
            if not isinstance(node, ast.Call):
                continue
            root, attr = _call_root(node.func)
            if root is not None and module.numpy_alias(root) \
                    and attr in _NP_FORCING:
                hits.append((node.lineno, f"{root}.{attr}()"))
            elif root is not None and module.jax_alias(root) \
                    and attr == "device_get":
                hits.append((node.lineno, f"{root}.device_get()"))
            elif root is None and attr in ("float", "int"):
                hits.append((node.lineno, f"{attr}()"))
            elif (host_copy := _tensor_host_copy(node)) is not None:
                hits.append((node.lineno, host_copy))
    return hits


class ModuleIndex:
    """Shared, process-wide cache of parsed modules (Pipeline pre-flight
    and the CLI both go through one instance; parsing an element module
    costs ~ms and happens once)."""

    def __init__(self, root: Path | None = None):
        self.root = Path(root) if root else REPO_ROOT
        #: path -> (mtime_ns at parse, parsed module or None)
        self._modules: dict[Path, tuple] = {}

    # -- module spec -> source file -----------------------------------------

    def resolve_spec(self, spec: str, level: int = 0,
                     relative_to: Path | None = None) -> Path | None:
        if level and relative_to is not None:
            base = relative_to.parent
            for _ in range(level - 1):
                base = base.parent
            parts = [p for p in spec.split(".") if p]
            return self._module_file(base.joinpath(*parts)) \
                if parts else self._module_file(base)
        if spec.endswith(".py") or os.sep in spec:
            path = Path(spec)
            for candidate in (Path(os.path.abspath(spec)),
                              self.root / path):
                if candidate.is_file():
                    return candidate.resolve()
            return None
        parts = spec.split(".")
        return self._module_file(self.root.joinpath(*parts))

    @staticmethod
    def _module_file(base: Path) -> Path | None:
        for candidate in (base.with_suffix(".py"), base / "__init__.py"):
            if candidate.is_file():
                return candidate.resolve()
        return None

    def module(self, path: Path | None) -> _ModuleInfo | None:
        if path is None:
            return None
        path = Path(path).resolve()
        # mtime-keyed: a long-lived process (the _SHARED_INDEX lives
        # for the process) must re-lint an element source the operator
        # edited between two `pipeline create`s, not its stale AST.
        try:
            mtime = path.stat().st_mtime_ns
        except OSError:
            mtime = None
        cached = self._modules.get(path)
        if cached is not None and cached[0] == mtime:
            return cached[1]
        info = None
        if mtime is not None:
            try:
                info = _ModuleInfo(path, self)
            except (OSError, SyntaxError):
                info = None
        self._modules[path] = (mtime, info)
        return info

    # -- class lineage -------------------------------------------------------

    def resolve_class(self, module: _ModuleInfo, name: str,
                      depth: int = 8) -> _ClassInfo | None:
        if depth <= 0 or module is None:
            return None
        if name in module.classes:
            return module.classes[name]
        imported = module.imports.get(name)
        if imported is not None:
            target = self.module(imported[0])
            if target is not None and target is not module:
                return self.resolve_class(target, imported[1],
                                          depth - 1)
        return None

    def base_chain(self, cls: _ClassInfo) -> tuple:
        """(ordered class chain, every base resolved?) -- breadth-first
        over the declared bases."""
        chain, complete, queue, seen = [], True, [cls], set()
        while queue:
            current = queue.pop(0)
            if id(current) in seen:
                continue
            seen.add(id(current))
            chain.append(current)
            for base in current.bases:
                if base == "object":
                    continue
                resolved = self.resolve_class(current.module, base)
                if resolved is None:
                    if base not in _ELEMENT_BASES:
                        complete = False
                    continue
                queue.append(resolved)
        return chain, complete

    def is_element_class(self, cls: _ClassInfo) -> bool:
        chain, _ = self.base_chain(cls)
        names = {info.name for info in chain}
        declared = {base for info in chain for base in info.bases}
        return bool((names | declared) & _ELEMENT_BASES)

    def class_attr_literal(self, chain, name, default):
        for info in chain:
            if name in info.attrs:
                try:
                    return ast.literal_eval(info.attrs[name])
                except (ValueError, SyntaxError):
                    return default
        return default

    def parameter_reads(self, chain) -> set:
        """Every parameter name the class (or its bases) can read:
        ``get_parameter("x")`` literals in any method, plus string
        constants in class-level assigns (`_MODEL_PARAMS` tuples,
        ``PARAMETER = "data_sources"`` markers)."""
        reads: set[str] = set()
        for info in chain:
            reads |= info.attr_strings
            for method in info.methods.values():
                for node in ast.walk(method):
                    if not isinstance(node, ast.Call):
                        continue
                    _, attr = _call_root(node.func)
                    if attr != "get_parameter" or not node.args:
                        continue
                    first = node.args[0]
                    if isinstance(first, ast.Constant) \
                            and isinstance(first.value, str):
                        reads.add(first.value)
        return reads


_SHARED_INDEX = ModuleIndex()


def _entry_findings(index: ModuleIndex, module: _ModuleInfo,
                    cls: _ClassInfo, context: str,
                    host_typed: set = frozenset(),
                    disabled=lambda rule: False) -> list:
    """undeclared-host-input + device-fn-host-call for one class."""
    findings = []
    chain, _ = index.base_chain(cls)
    host_inputs = index.class_attr_literal(chain, "host_inputs", ())
    host_inputs = set(host_inputs if isinstance(host_inputs,
                                                (tuple, list)) else ())
    class_disables = module.line_disables(cls.lineno)

    def suppressed(rule: str, lineno: int, method) -> bool:
        return rule in class_disables \
            or rule in module.line_disables(lineno) \
            or rule in module.line_disables(method.lineno) \
            or disabled(rule)

    # Warm the host-forcing helper set BEFORE scanning entry methods:
    # forcing_fast() only reflects an already-computed fixpoint, so
    # without this a module-local wrapper (``as_uint8`` around
    # np.asarray) would never count as host-materializing here.
    module.forcing_callables()
    for method_name in _ENTRY_METHODS:
        method = None
        for info in chain:
            if method_name in info.methods:
                method = info.methods[method_name]
                owner = info
                break
        if method is None or owner is not cls:
            continue                    # inherited bodies: owner's lint
        tracked = {arg.arg for arg in method.args.args
                   if arg.arg not in _CONTROL_PARAMS}
        for lineno, input_name, description in _host_force_hits(
                module, method, tracked):
            if input_name in host_inputs or input_name in host_typed:
                continue
            if suppressed("undeclared-host-input", lineno, method):
                continue
            findings.append(Finding(
                "undeclared-host-input",
                f"{cls.name}.{method_name} calls {description} on "
                f"input {input_name!r}; declare it in host_inputs "
                f"(or \"type\": \"host\") so the engine fetches it "
                f"with one counted device_get",
                f"{context}{module.path}:{lineno}"))
    if "device_fn" in cls.methods:
        method = cls.methods["device_fn"]
        for lineno, description in _device_fn_hits(module, method):
            if suppressed("device-fn-host-call", lineno, method):
                continue
            findings.append(Finding(
                "device-fn-host-call",
                f"{cls.name}.device_fn trace body calls "
                f"{description}: a DeviceFn fn must be pure device "
                f"math (host work belongs in finalize)",
                f"{context}{module.path}:{lineno}"))
    return findings


def analyze_element_sources(paths, index: ModuleIndex | None = None) \
        -> list:
    """Standalone element lint: every PipelineElement-lineage class in
    the given ``.py`` files / directories."""
    index = index or _SHARED_INDEX
    findings = []
    files: list[Path] = []
    for path in paths:
        path = Path(path)
        if path.is_dir():
            files.extend(sorted(path.rglob("*.py")))
        else:
            files.append(path)
    for file_path in files:
        module = index.module(file_path)
        if module is None:
            findings.append(Finding(
                "bad-source",
                "element source is missing or does not parse",
                str(file_path)))
            continue
        for cls in module.classes.values():
            if index.is_element_class(cls):
                findings.extend(_entry_findings(index, module, cls,
                                                context=""))
    return findings


def analyze_definition_residency(definition,
                                 index: ModuleIndex | None = None) \
        -> list:
    """Definition-aware residency layer: host-input/device-fn rules for
    each locally-deployed element, unread declared parameters, and
    donation-alias hazards from the graph's qualified reads."""
    index = index or _SHARED_INDEX
    findings: list[Finding] = []
    disables = _Disables(definition)
    graph, _ = build_graph(definition)
    resolved: dict[str, tuple] = {}     # element -> (module, cls)

    for element in definition.elements:
        if element.deploy_local is None:
            continue
        module = index.module(
            index.resolve_spec(element.deploy_local["module"]))
        if module is None:
            continue
        cls = index.resolve_class(
            module, element.deploy_local.get("class_name", ""))
        if cls is None:
            continue
        resolved[element.name] = (module, cls)
        host_typed = {io["name"] for io in element.input
                      if str(io.get("type", "")).rstrip("?") == "host"}
        context = f"{definition.name}: {element.name}: "
        findings.extend(_entry_findings(
            index, cls.module, cls, context, host_typed,
            disabled=lambda rule, name=element.name:
                not disables.active(rule, name)))
        if element.parameters and disables.active("unread-parameter",
                                                  element.name):
            chain, complete = index.base_chain(cls)
            if complete:
                reads = index.parameter_reads(chain)
                for name in element.parameters:
                    if name not in reads:
                        findings.append(Finding(
                            "unread-parameter",
                            f"element {element.name!r} declares "
                            f"parameter {name!r}, but "
                            f"{cls.name} (and its bases) never read "
                            f"it", f"{definition.name}: "
                                   f"{element.name}.parameters.{name}"))

    if graph is not None:
        defs = {element.name: element
                for element in definition.elements}
        producer_counts: dict[str, set] = {}
        for node in graph.nodes():
            element = defs.get(node.name)
            if element is None:
                continue
            for out in element.output_names:
                producer_counts.setdefault(out, set()).add(node.name)
        for node in graph.nodes():
            for input_name, key in (node.properties or {}).items():
                if not isinstance(key, str) or "." not in key:
                    continue
                producer_name, _, out = key.partition(".")
                info = resolved.get(producer_name)
                if info is None:
                    continue
                chain, _ = index.base_chain(info[1])
                if not index.class_attr_literal(chain,
                                                "device_resident",
                                                False):
                    continue
                overwriters = producer_counts.get(out, set()) \
                    - {producer_name}
                if overwriters \
                        and disables.active("donation-alias",
                                            node.name):
                    findings.append(Finding(
                        "donation-alias",
                        f"{node.name!r} reads qualified {key!r} while "
                        f"{sorted(overwriters)} overwrite bare "
                        f"{out!r}: the alias pins the device buffer "
                        f"and blocks HBM donation for any fused "
                        f"segment containing {producer_name!r}",
                        f"{definition.name}: {node.name}.input."
                        f"{input_name}"))
    return findings
