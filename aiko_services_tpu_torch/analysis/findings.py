"""Finding model + rule catalogue for the static analyzers (ISSUE 6).

A :class:`Finding` is one diagnosed violation: a rule id, a severity,
a human message, and *where* -- the graph-path-qualified location
(``pipeline: head->...->node: node.field``) for definition findings, or
``file:line`` for source findings.  The catalogue below is the single
authority on which rules exist, what severity they carry, and what they
mean; the CLI ``--rules`` listing, the README rule table, and the
fixture-coverage test all derive from it.

Severity semantics (enforced by ``analysis.lint.preflight``):

- ``error``: the definition/element is structurally broken -- the
  pipeline would fail on every frame (or silently misbehave) at the
  flagged spot.  Fail-fast at ``pipeline create`` by default.
- ``warning``: plausibly-intentional but usually wrong (an input only
  satisfiable by ad-hoc frame data, a host sync the swag contract
  counts against you).  Fatal only under strict pre-flight
  (``preflight: strict`` / ``pipeline create --check``).

Escape hatch for the truly intentional: a ``# aiko-lint:
disable=rule-a,rule-b`` comment on the offending line, its ``def``
line, or the ``class`` line suppresses those rules for that scope in
Python sources; an element entry ``"lint": ["rule-a"]`` (or the same
key at the definition top level) does it for JSON definitions.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

__all__ = ["ERROR", "WARNING", "Finding", "RULES", "rule_severity",
           "disabled_rules_for_line"]

ERROR = "error"
WARNING = "warning"

#: rule id -> (severity, one-line description).  Kept in catalogue
#: order: dataflow, placement/parameters, residency, self-check.
RULES: dict[str, tuple[str, str]] = {
    # -- dataflow (definition graph) -----------------------------------
    "bad-graph": (ERROR,
                  "graph expression does not parse, or the DAG has a "
                  "cycle"),
    "unknown-element": (ERROR,
                        "graph node has no element definition"),
    "unbound-input": (WARNING,
                      "required input is produced by no upstream "
                      "element and is not a declared head input -- it "
                      "can only come from ad-hoc frame data"),
    "dead-output": (WARNING,
                    "declared output is consumed by no downstream "
                    "element (the response swag still carries it; "
                    "disable if that is the point)"),
    "key-collision": (WARNING,
                      "two parallel (unordered) elements write the "
                      "same bare swag key that a downstream element "
                      "reads -- which value wins depends on walk order"),
    "bad-mapping": (ERROR,
                    "input mapping reads a producer-qualified key "
                    "whose producer is not upstream or does not "
                    "declare that output"),
    "fallback-mismatch": (ERROR,
                          "fallback element's input/output signature "
                          "differs from the remote stage it shadows"),
    "unused-element": (WARNING,
                       "element is defined but appears in no graph "
                       "path (and is no fallback target)"),
    # -- placement + parameters ----------------------------------------
    "bad-placement": (ERROR,
                      "malformed placement block (devices must be a "
                      "positive chip count or 'auto'; mesh axes must "
                      "be positive)"),
    "placement-remote": (ERROR,
                         "placement block on a remote-deployed element "
                         "-- a remote stage head can never be a local "
                         "admission boundary"),
    "replicas-on-unplaced": (WARNING,
                             "placement declares replicas but neither "
                             "mesh nor devices -- nothing is placed, "
                             "so no replica submesh can be carved and "
                             "the group never forms"),
    "bad-parameter": (ERROR,
                      "pipeline parameter value outside its domain "
                      "(unknown enum choice, negative count/deadline, "
                      "unparseable fault plan or mesh spec)"),
    "data-plane-on-local": (WARNING,
                            "data_plane: tensor_pipe forced on a "
                            "pipeline with no remote stages -- the "
                            "pipe binds a socket no frame will ever "
                            "cross"),
    # -- residency & fusion (element AST) ------------------------------
    "bad-source": (ERROR,
                   "source file (element module or definition) is "
                   "missing or does not parse -- nothing in it can be "
                   "analyzed (or run)"),
    "undeclared-host-input": (WARNING,
                              "process_frame host-materializes an "
                              "input (np.asarray/.item()/device_get) "
                              "that is neither in host_inputs nor "
                              "host-typed -- an implicit device->host "
                              "sync under the swag contract"),
    "device-fn-host-call": (ERROR,
                            "host-transfer call (np.asarray, float(), "
                            ".item(), device_get) inside a DeviceFn "
                            "trace body -- the fused trace would sync "
                            "or fail under jax.jit"),
    "donation-alias": (WARNING,
                       "a graph mapping reads a producer-qualified "
                       "alias of a device output that a downstream "
                       "element overwrites -- the alias pins the "
                       "buffer and blocks HBM donation for the fused "
                       "segment"),
    "unread-parameter": (WARNING,
                         "element definition declares a parameter the "
                         "element class (and its bases) never reads"),
    # -- framework self-check (--self) ---------------------------------
    "hook-parity": (ERROR,
                    "hook registered but never run, or run but never "
                    "registered"),
    "handler-liveness": (ERROR,
                         "handler attached (add_hook_handler / CLI "
                         "alias) to a hook nothing runs"),
    "span-sync": (ERROR,
                  "profiler and telemetry disagree on the span-bearing "
                  "pipeline hooks"),
    "resume-identity": (ERROR,
                        "a mailbox resume post does not carry both the "
                        "Frame identity and its replay_epoch"),
    "parameter-registry": (ERROR,
                           "pipeline parameter read in source but "
                           "missing from the registry/README, or "
                           "registered but never read"),
    "metric-registry": (ERROR,
                        "metric series emitted in source but missing "
                        "from the README metrics table, or documented "
                        "there but never emitted"),
    "kernel-test": (ERROR,
                    "a pl.pallas_call kernel entry point has no "
                    "registered equivalence test "
                    "(KERNEL_EQUIVALENCE_TESTS), or registers one "
                    "that does not exist in tests/"),
    "kernel-table": (ERROR,
                     "kernel registered in code but missing from the "
                     "README kernel-plane table, or documented there "
                     "but not registered"),
}


def rule_severity(rule: str) -> str:
    return RULES[rule][0]


@dataclass
class Finding:
    rule: str
    message: str
    where: str = ""                 # graph-path / file:line context
    severity: str = field(default="")

    def __post_init__(self):
        if not self.severity:
            self.severity = rule_severity(self.rule)

    def render(self) -> str:
        where = f"{self.where}: " if self.where else ""
        return f"{where}[{self.rule}] {self.severity}: {self.message}"


_DISABLE_RE = re.compile(r"#\s*aiko-lint:\s*disable=([a-z0-9_,\- ]+)")


def disabled_rules_for_line(line: str) -> set:
    """Rules disabled by an ``# aiko-lint: disable=...`` comment."""
    match = _DISABLE_RE.search(line)
    if not match:
        return set()
    return {part.strip() for part in match.group(1).split(",")
            if part.strip()}
