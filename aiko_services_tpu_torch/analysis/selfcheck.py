"""Framework self-check: the engine's own invariants as lint rules
(ISSUE 6 layer 3).

``tests/test_hook_consistency.py`` (PR 4) proved the idea for hooks;
this generalizes it into a rule engine run by ``aiko_lint --self`` and
tier-1.  Each rule scans the package *source* (regex/AST -- nothing is
imported, so the check stays jax-free and runs in milliseconds) and
returns :class:`~.findings.Finding`s:

- ``hook-parity``     every ``add_hook`` name has a ``run_hook`` site
                      and vice versa.
- ``handler-liveness`` every ``add_hook_handler`` literal and CLI hook
                      alias points at a hook something runs.
- ``span-sync``       the xprof profiler and the telemetry plane
                      consume the same span-bearing pipeline hooks.
- ``resume-identity`` every mailbox resume post (``post_self("resume_*"
                      ...)``) carries both the Frame object and its
                      ``replay_epoch`` -- the PR 5 staleness contract
                      that keeps a dead frame's continuation from
                      resuming its replacement.
- ``parameter-registry`` every pipeline-parameter literal the engine
                      reads is registered in ``analysis.params`` and
                      documented in README.md, and every registered
                      parameter is still read somewhere.
- ``metric-registry`` every counter/gauge/histogram series name the
                      package emits (``registry.observe/count/gauge``
                      literals, f-string families as wildcards)
                      appears in the README metrics table (the
                      ``<!-- metrics-table -->`` fenced region) and
                      every table row is still emitted somewhere --
                      the replica/LLM/data-plane gauges of PRs 7-9
                      drifted from the docs exactly this way.
- ``kernel-test``     every ``pl.pallas_call`` kernel entry point is
                      registered in its module's
                      ``KERNEL_EQUIVALENCE_TESTS`` with a test that
                      actually exists in tests/ -- an untested kernel
                      fails ``--self`` (ISSUE 11: the static-analysis
                      discipline applied to the kernel plane).
- ``kernel-table``    the registered kernel entries and the README
                      kernel-plane table (the ``<!-- kernel-table -->``
                      fenced region) agree both ways, so the per-kernel
                      shapes/support/fallback table cannot drift from
                      the code.

All rules accept an explicit root so the fixture corpus can point them
at deliberately broken trees.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from .findings import Finding
from .params import PIPELINE_PARAMETERS

__all__ = ["analyze_framework", "SPAN_HOOKS"]

PACKAGE = Path(__file__).resolve().parents[1]

# "component.hook_name:version" -- the naming convention every hook in
# the tree follows (runtime/hooks.py).
_HOOK_NAME = r"[a-z_][a-z0-9_.]*:\d+"
_LITERAL = rf'"({_HOOK_NAME})"'
# HOOK_MESSAGE_IN = "actor.message_in:0" style constants, so hook
# registrations/invocations through self.HOOK_*-style names resolve too.
_CONSTANT = re.compile(rf'\b(HOOK_[A-Z_0-9]+)\s*=\s*{_LITERAL}')

#: the span-bearing pipeline hooks both the profiler and the telemetry
#: plane must consume (drift on either side breaks spans silently).
SPAN_HOOKS = frozenset({
    "pipeline.process_element:0", "pipeline.process_element_post:0",
    "pipeline.process_segment:0", "pipeline.process_segment_post:0",
    "pipeline.process_stage:0", "pipeline.process_stage_post:0",
    "pipeline.stage_hop:0"})

#: pipeline-parameter read idioms in engine source.  Multi-line calls
#: (black puts the literal on the next line) are matched over the full
#: text, not per line.
_PARAMETER_READS = re.compile(
    r'(?:get_pipeline_parameter|_pipeline_parameters\.get'
    r'|definition\.parameters\.get|\(parameters or \{\}\)\.get)'
    r'\(\s*"([a-z_0-9]+)"', re.S)


def _sources(root: Path):
    for path in sorted(root.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        yield path, path.read_text()


def _collect(root: Path, call: str):
    """hook name -> set of 'file:line' sites for ``call(...)``; also
    returns unresolved-constant findings."""
    findings: list[Finding] = []
    constants: dict[str, str] = {}
    for _, text in _sources(root):
        for name, value in _CONSTANT.findall(text):
            constants[name] = value
    sites: dict[str, set] = {}
    # Matched over the FULL text (like _PARAMETER_READS): `\s*` spans
    # newlines, so a call whose hook literal wraps to the next line
    # still counts -- a formatting change must not fabricate a
    # dead-hook finding.
    pattern = re.compile(
        rf'\b{call}\(\s*(?:{_LITERAL}|(?:self|cls)\.(HOOK_[A-Z_0-9]+))')
    for path, text in _sources(root):
        for match in pattern.finditer(text):
            literal, constant = match.group(1), match.group(2)
            line_number = text.count("\n", 0, match.start()) + 1
            name = literal or constants.get(constant)
            where = f"{path.relative_to(root)}:{line_number}"
            if name is None:
                findings.append(Finding(
                    "hook-parity",
                    f"{call} uses unresolved constant "
                    f"{constant!r}", where))
                continue
            sites.setdefault(name, set()).add(where)
    return sites, findings


def _check_hooks(root: Path) -> list:
    registered, findings = _collect(root, "add_hook")
    invoked, more = _collect(root, "run_hook")
    findings.extend(more)
    if not registered:
        findings.append(Finding(
            "hook-parity", "no add_hook sites found -- pattern drift?",
            str(root)))
        return findings
    for name, sites in sorted(registered.items()):
        if name not in invoked:
            findings.append(Finding(
                "hook-parity",
                f"hook {name!r} is registered but never run (dead "
                f"hook)", sorted(sites)[0]))
    for name, sites in sorted(invoked.items()):
        if name not in registered:
            findings.append(Finding(
                "hook-parity",
                f"hook {name!r} is run but never registered (silent "
                f"no-op)", sorted(sites)[0]))

    attachments, more = _collect(root, "add_hook_handler")
    findings.extend(more)
    for name, sites in sorted(attachments.items()):
        if name not in invoked:
            findings.append(Finding(
                "handler-liveness",
                f"handler attached to hook {name!r}, which nothing "
                f"runs", sorted(sites)[0]))
    cli = root / "cli.py"
    if cli.is_file():
        aliases = re.findall(rf'"[a-z]+":\s*{_LITERAL}', cli.read_text())
        for name in aliases:
            if name not in invoked:
                findings.append(Finding(
                    "handler-liveness",
                    f"CLI hook alias targets {name!r}, which nothing "
                    f"runs", str(cli.relative_to(root.parent))))
    return findings


def _check_spans(root: Path) -> list:
    """The telemetry plane and the xprof profiler must stay in sync on
    the span-bearing hooks -- a hook one consumes and the other misses
    is exactly the drift this rule exists to catch."""
    findings = []
    consumers = {"profiling.py": set(), "telemetry.py": set()}
    for path, text in _sources(root):
        if path.name in consumers:
            consumers[path.name] = set(
                re.findall(rf'"(pipeline\.[a-z_]+:\d+)"', text))
    for filename, names in consumers.items():
        if not names:
            findings.append(Finding(
                "span-sync",
                f"no pipeline hook literals found in {filename} -- "
                f"file missing or pattern drift", str(root)))
            continue
        for hook in sorted(SPAN_HOOKS - names):
            findings.append(Finding(
                "span-sync",
                f"span hook {hook!r} is not consumed by {filename}",
                filename))
    return findings


def _post_list_names(node: ast.expr):
    """Every Name/Attribute mentioned inside a post_self argument
    list (one level of Call like ``list(waiter)`` included)."""
    names, attrs = set(), set()
    for inner in ast.walk(node):
        if isinstance(inner, ast.Name):
            names.add(inner.id)
        elif isinstance(inner, ast.Attribute):
            attrs.add(inner.attr)
    return names, attrs


def _check_resume_identity(root: Path) -> list:
    """Every ``post_self("resume_*", [...])`` must carry the Frame
    object (``frame``/``frame_ref``) AND the epoch captured from
    ``frame.replay_epoch`` -- otherwise a stale continuation from a
    destroyed or replayed frame could resume its same-id replacement."""
    findings = []
    for path, text in _sources(root):
        try:
            tree = ast.parse(text)
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            attr = func.attr if isinstance(func, ast.Attribute) \
                else (func.id if isinstance(func, ast.Name) else None)
            if attr != "post_self" or not node.args:
                continue
            first = node.args[0]
            if not (isinstance(first, ast.Constant)
                    and isinstance(first.value, str)
                    and first.value.startswith("resume_")):
                continue
            where = f"{path.relative_to(root)}:{node.lineno}"
            if len(node.args) < 2:
                findings.append(Finding(
                    "resume-identity",
                    f"post_self({first.value!r}) has no argument "
                    f"list to carry Frame identity", where))
                continue
            names, attrs = _post_list_names(node.args[1])
            if not ({"frame", "frame_ref"} & names):
                findings.append(Finding(
                    "resume-identity",
                    f"resume post {first.value!r} does not carry the "
                    f"Frame object (stale posts from a destroyed "
                    f"same-id stream could resume a replacement "
                    f"frame)", where))
            if "epoch" not in names and "replay_epoch" not in attrs:
                findings.append(Finding(
                    "resume-identity",
                    f"resume post {first.value!r} does not carry "
                    f"replay_epoch (a pre-replay continuation could "
                    f"resume the replayed frame)", where))
    return findings


def _check_parameter_registry(root: Path, readme: Path | None,
                              registry: dict | None = None) -> list:
    registry = PIPELINE_PARAMETERS if registry is None else registry
    findings = []
    reads: dict[str, str] = {}
    for path, text in _sources(root):
        if "analysis" in path.parts or path.name.startswith("test"):
            continue
        for match in _PARAMETER_READS.finditer(text):
            line = text.count("\n", 0, match.start()) + 1
            reads.setdefault(match.group(1),
                             f"{path.relative_to(root)}:{line}")
    for name, where in sorted(reads.items()):
        if name not in registry:
            findings.append(Finding(
                "parameter-registry",
                f"engine reads pipeline parameter {name!r}, which is "
                f"not registered in analysis/params.py (lint cannot "
                f"validate it and README cannot document it)", where))
    readme_text = readme.read_text() if readme and readme.is_file() \
        else ""
    for name in sorted(registry):
        if name == "preflight":
            pass                        # read via analysis/lint.py
        elif name not in reads:
            findings.append(Finding(
                "parameter-registry",
                f"parameter {name!r} is registered but no engine "
                f"source reads it", "analysis/params.py"))
        if readme_text and name not in readme_text:
            findings.append(Finding(
                "parameter-registry",
                f"registered parameter {name!r} is not documented in "
                f"README.md", "README.md"))
    return findings


#: metric-series emission idioms: a direct string literal (or f-string
#: family) right after .observe(/.count(/.gauge( -- matched over the
#: full text so black's line wrapping cannot hide a name.  Telemetry
#: deliberately keeps every emission name a DIRECT literal at the call
#: site (see PipelineTelemetry._exit) so this collection is complete.
_METRIC_EMITS = re.compile(
    r'\.(?:observe|count|gauge)\(\s*(f?)"([a-z_0-9{}]+)"', re.S)
#: README metrics-table rows inside the fenced region: | `name` | ...
_METRIC_REGION = re.compile(
    r"<!--\s*metrics-table\s*-->(.*?)<!--\s*/metrics-table\s*-->", re.S)
_METRIC_ROW = re.compile(r"^\|\s*`([a-z_0-9]+)`", re.M)


def _check_metric_registry(root: Path, readme: Path | None) -> list:
    """Every emitted series name must be a row of the README metrics
    table, and every row must still be emitted.  f-string families
    (``f"frame_{bucket}_ms"``) are wildcards: they must match at least
    one row, and a row matching a family counts as emitted."""
    findings = []
    literals: dict[str, str] = {}
    families: dict[str, str] = {}
    for path, text in _sources(root):
        if "analysis" in path.parts or path.name.startswith("test"):
            continue
        for match in _METRIC_EMITS.finditer(text):
            prefixed, name = match.group(1), match.group(2)
            line = text.count("\n", 0, match.start()) + 1
            where = f"{path.relative_to(root)}:{line}"
            if prefixed and "{" in name:
                families.setdefault(name, where)
            elif "{" not in name:
                literals.setdefault(name, where)
    family_patterns = {
        name: re.compile(
            "^" + re.sub(r"\\\{[^}]*\\\}", "[a-z0-9_]+",
                         re.escape(name)) + "$")
        for name in families}
    readme_text = readme.read_text() if readme and readme.is_file() \
        else ""
    region = _METRIC_REGION.search(readme_text)
    documented = set(_METRIC_ROW.findall(region.group(1))) if region \
        else set()
    for name, where in sorted(literals.items()):
        if name not in documented:
            findings.append(Finding(
                "metric-registry",
                f"metric series {name!r} is emitted but not a row of "
                f"the README metrics table "
                f"(<!-- metrics-table --> region)", where))
    for name, where in sorted(families.items()):
        pattern = family_patterns[name]
        if not any(pattern.match(row) for row in documented):
            findings.append(Finding(
                "metric-registry",
                f"metric family {name!r} is emitted but no README "
                f"metrics-table row matches it", where))
    for row in sorted(documented):
        if row in literals:
            continue
        if any(pattern.match(row)
               for pattern in family_patterns.values()):
            continue
        findings.append(Finding(
            "metric-registry",
            f"README metrics table documents {row!r}, which nothing "
            f"emits", "README.md"))
    return findings


#: module-level registry literal the kernel rules read (AST, never
#: imported): ``KERNEL_EQUIVALENCE_TESTS = {"entry": "file::test"}``.
_KERNEL_REGISTRY = "KERNEL_EQUIVALENCE_TESTS"
#: README kernel-plane table rows inside the fenced region: | `name` |
_KERNEL_REGION = re.compile(
    r"<!--\s*kernel-table\s*-->(.*?)<!--\s*/kernel-table\s*-->", re.S)
_KERNEL_ROW = re.compile(r"^\|\s*`([a-z_0-9]+)`", re.M)


def _kernel_module_facts(tree: ast.Module):
    """(top-level defs, defs containing a ``pl.pallas_call`` with line
    numbers, the KERNEL_EQUIVALENCE_TESTS literal or None)."""
    defs: dict[str, int] = {}
    entries: dict[str, int] = {}
    registry = None
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            defs[node.name] = node.lineno
            for inner in ast.walk(node):
                if isinstance(inner, ast.Call) \
                        and isinstance(inner.func, ast.Attribute) \
                        and inner.func.attr == "pallas_call":
                    entries[node.name] = inner.lineno
        elif isinstance(node, ast.Assign) \
                and any(isinstance(t, ast.Name)
                        and t.id == _KERNEL_REGISTRY
                        for t in node.targets) \
                and isinstance(node.value, ast.Dict):
            registry = {}
            for key, value in zip(node.value.keys, node.value.values):
                if isinstance(key, ast.Constant) \
                        and isinstance(value, ast.Constant):
                    registry[str(key.value)] = (str(value.value),
                                                key.lineno)
    return defs, entries, registry


def _check_kernel_registry(root: Path, readme: Path | None) -> list:
    """``kernel-test``: every pl.pallas_call entry point must be
    registered with an equivalence test that exists (name-matched in
    tests/); ``kernel-table``: registered entries and the README
    kernel-plane table agree both ways."""
    findings = []
    tests_dir = root / "tests"
    if not tests_dir.is_dir():
        tests_dir = root.parent / "tests"
    registered: dict[str, str] = {}
    for path, text in _sources(root):
        # Relative to the scanned root: a fixture tree may itself live
        # under a tests/ directory.
        if "tests" in path.relative_to(root).parts \
                or path.name.startswith("test"):
            continue
        try:
            tree = ast.parse(text)
        except SyntaxError:
            continue
        defs, entries, registry = _kernel_module_facts(tree)
        where = str(path.relative_to(root))
        for name, line in sorted(entries.items()):
            if registry is None or name not in registry:
                findings.append(Finding(
                    "kernel-test",
                    f"pl.pallas_call entry {name!r} has no registered "
                    f"equivalence test ({_KERNEL_REGISTRY} in its "
                    f"module) -- an untested kernel cannot gate PRs",
                    f"{where}:{line}"))
        for name, (ref, line) in sorted((registry or {}).items()):
            spot = f"{where}:{line}"
            if name not in defs:
                findings.append(Finding(
                    "kernel-test",
                    f"{_KERNEL_REGISTRY} registers {name!r}, which the "
                    f"module does not define", spot))
                continue
            test_file, sep, test_name = ref.partition("::")
            test_path = tests_dir / test_file
            if not sep or not test_path.is_file() \
                    or f"def {test_name}(" not in test_path.read_text():
                findings.append(Finding(
                    "kernel-test",
                    f"kernel {name!r} registers equivalence test "
                    f"{ref!r}, which does not exist under "
                    f"{tests_dir.name}/", spot))
            registered[name] = spot
    if readme is None:
        candidate = root / "README.md"
        readme = candidate if candidate.is_file() else None
    readme_text = readme.read_text() if readme and readme.is_file() \
        else ""
    region = _KERNEL_REGION.search(readme_text)
    documented = set(_KERNEL_ROW.findall(region.group(1))) if region \
        else set()
    for name, spot in sorted(registered.items()):
        if name not in documented:
            findings.append(Finding(
                "kernel-table",
                f"kernel {name!r} is registered but not a row of the "
                f"README kernel-plane table "
                f"(<!-- kernel-table --> region)", spot))
    for row in sorted(documented - set(registered)):
        findings.append(Finding(
            "kernel-table",
            f"README kernel-plane table documents {row!r}, which no "
            f"module registers", "README.md"))
    return findings


def analyze_framework(package_root: Path | str | None = None,
                      readme: Path | str | None = None,
                      registry: dict | None = None) -> list:
    """Run every self-check rule over the package tree (defaults to the
    installed ``aiko_services_tpu_torch`` sources and the repo README)."""
    root = Path(package_root) if package_root else PACKAGE
    if readme is None:
        candidate = root.parent / "README.md"
        readme = candidate if candidate.is_file() else None
    else:
        readme = Path(readme)
    findings = []
    findings.extend(_check_hooks(root))
    findings.extend(_check_spans(root))
    findings.extend(_check_resume_identity(root))
    findings.extend(_check_parameter_registry(root, readme, registry))
    findings.extend(_check_metric_registry(root, readme))
    findings.extend(_check_kernel_registry(root, readme))
    return findings
