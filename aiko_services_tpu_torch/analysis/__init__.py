"""Static analysis for pipelines (ISSUE 6): catch at ``pipeline
create`` what today only fails at frame N.

Three jax-free analyzer layers over a pipeline definition + its
element sources:

- :mod:`.dataflow` -- propagate producer-qualified output keys through
  the graph (unbound inputs, dead outputs, key collisions, bad
  mappings, fallback signature parity, placement/parameter sanity).
- :mod:`.residency` -- AST-inspect element classes without importing
  them (undeclared host transfers, impure DeviceFn trace bodies,
  unread declared parameters, donation-alias hazards).
- :mod:`.selfcheck` -- the engine's own invariants as rules over the
  codebase (hook parity, handler liveness, span sync, resume-post
  identity, parameter registry).

``lint.py`` orchestrates all three behind the ``aiko_lint`` CLI
(``python -m aiko_services_tpu_torch lint``) and the ``Pipeline.__init__``
pre-flight (``preflight: on|strict|off`` pipeline parameter,
``pipeline create --check`` for strict mode).
"""

from .findings import ERROR, WARNING, Finding, RULES
from .params import PIPELINE_PARAMETERS, validate_parameters
from .dataflow import analyze_dataflow
from .residency import (ModuleIndex, analyze_definition_residency,
                        analyze_element_sources)
from .selfcheck import analyze_framework
from .lint import (LintReport, lint_definition, lint_paths, preflight,
                   run_lint)

__all__ = ["ERROR", "WARNING", "Finding", "RULES",
           "PIPELINE_PARAMETERS", "validate_parameters",
           "analyze_dataflow", "ModuleIndex",
           "analyze_definition_residency", "analyze_element_sources",
           "analyze_framework", "LintReport", "lint_definition",
           "lint_paths", "preflight", "run_lint"]
