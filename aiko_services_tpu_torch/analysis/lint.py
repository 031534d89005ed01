"""``aiko_lint`` orchestration + the ``Pipeline.__init__`` pre-flight
(ISSUE 6).

One entry point per consumer:

- :func:`lint_definition` -- dataflow + residency findings for one
  parsed definition (what the CLI prints, what pre-flight gates on).
- :func:`lint_paths` -- CLI driver: ``.json`` paths lint as pipeline
  definitions, ``.py`` files/directories lint every element class.
- :func:`analyze_framework` (re-exported) -- ``aiko_lint --self``.
- :func:`preflight` -- fail-fast gate wired into ``Pipeline.__init__``:
  raises a graph-path-qualified ``DefinitionError`` on error-severity
  findings (and warnings too under strict mode / ``pipeline create
  --check``).  ``preflight: off`` restores the old behavior of
  discovering problems at frame N.

Everything here is jax-free: definitions are parsed dataclasses,
element sources are AST-inspected, nothing is imported or dispatched.
"""

from __future__ import annotations

import time
from pathlib import Path

from .dataflow import analyze_dataflow
from .findings import ERROR, Finding
from .residency import (ModuleIndex, analyze_definition_residency,
                        analyze_element_sources)
from .selfcheck import analyze_framework

__all__ = ["LintReport", "lint_definition", "lint_paths", "preflight",
           "run_lint"]

PREFLIGHT_MODES = ("on", "strict", "off")


class LintReport:
    """Findings plus the wall time it took to produce them."""

    def __init__(self, findings, elapsed_ms: float = 0.0):
        self.findings = list(findings)
        self.elapsed_ms = elapsed_ms

    @property
    def errors(self):
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self):
        return [f for f in self.findings if f.severity != ERROR]

    def fatal(self, strict: bool = False):
        return self.findings if strict else self.errors

    def render(self) -> str:
        return "\n".join(f.render() for f in self.findings)

    def __bool__(self):
        return bool(self.findings)


def lint_definition(definition, index: ModuleIndex | None = None) \
        -> LintReport:
    """Dataflow + residency findings for one parsed
    :class:`~..pipeline.definition.PipelineDefinition`."""
    start = time.perf_counter()
    findings = analyze_dataflow(definition)
    findings.extend(analyze_definition_residency(definition, index))
    return LintReport(findings,
                      (time.perf_counter() - start) * 1000.0)


def preflight(definition, index: ModuleIndex | None = None,
              mode: str | None = None):
    """The ``pipeline create`` gate.  ``mode`` defaults to the
    definition's ``preflight`` parameter (``on``): error findings raise
    ``DefinitionError``; ``strict`` makes warnings fatal too; ``off``
    skips analysis entirely.  Returns the LintReport (or None when
    off) so the pipeline can log surviving warnings."""
    from ..pipeline.definition import DefinitionError

    if mode is None:
        mode = str(definition.parameters.get("preflight",
                                             "on")).strip().lower()
    if mode not in PREFLIGHT_MODES:
        raise DefinitionError(
            f"{definition.name}: parameters.preflight: {mode!r} not "
            f"one of {'|'.join(PREFLIGHT_MODES)}")
    if mode == "off":
        return None
    report = lint_definition(definition, index)
    fatal = report.fatal(strict=(mode == "strict"))
    if fatal:
        lines = "\n  ".join(f.render() for f in fatal)
        raise DefinitionError(
            f"pre-flight failed for pipeline {definition.name!r} "
            f"({len(fatal)} finding(s); 'preflight: off' to bypass, "
            f"# aiko-lint: disable=<rule> / \"lint\": [...] to "
            f"suppress one):\n  {lines}")
    return report


def lint_paths(paths, self_check: bool = False,
               index: ModuleIndex | None = None) -> LintReport:
    """CLI driver over a mixed list of definition files and element
    sources."""
    from ..pipeline.definition import DefinitionError, \
        load_pipeline_definition

    start = time.perf_counter()
    index = index or ModuleIndex()
    findings: list[Finding] = []
    element_paths = []
    for path in paths:
        path = Path(path)
        if path.suffix == ".json":
            try:
                definition = load_pipeline_definition(str(path))
            except (OSError, DefinitionError) as error:
                # Missing/unreadable/schema-rejected definition file:
                # a source problem, not a graph-shape one.
                findings.append(Finding("bad-source", str(error),
                                        str(path)))
                continue
            findings.extend(
                lint_definition(definition, index).findings)
        else:
            element_paths.append(path)
    if element_paths:
        findings.extend(analyze_element_sources(element_paths, index))
    if self_check:
        findings.extend(analyze_framework())
    return LintReport(findings, (time.perf_counter() - start) * 1000.0)


def run_lint(paths, self_check: bool = False, strict: bool = False,
             echo=print) -> int:
    """``aiko_lint`` process body: print findings, return the exit
    code (0 clean, 1 findings at the gated severity)."""
    report = lint_paths(paths, self_check=self_check)
    for finding in report.findings:
        echo(finding.render())
    gated = report.fatal(strict=strict)
    summary = (f"aiko_lint: {len(report.errors)} error(s), "
               f"{len(report.warnings)} warning(s) "
               f"in {report.elapsed_ms:.0f} ms")
    echo(summary)
    return 1 if gated else 0
