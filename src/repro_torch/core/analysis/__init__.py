"""``canal_torch.analyze`` — rule-based static analysis over the
interconnect IR.

Public surface:

* :func:`analyze` — run registered rules over an ``Interconnect``,
  returning an :class:`AnalysisReport` of :class:`Diagnostic` findings;
* :func:`register_rule` / :data:`RULES` / :func:`rule_table` — the
  ``AnalysisPass`` registry (the read-only twin of ``DEFAULT_PASSES``);
* ``Severity`` / ``AnalysisError`` — the gating model used by
  ``canal_torch.compile(analyze=...)`` and the DSE pre-screen.

Importing the package registers the built-in rules (``rules`` — the
seven IR rules of ISSUE 6), the post-lowering verification rules
(``lowered`` — the §3.3 checks folded in from ``repro_torch.core.verify``)
and the routed-design rules (``routed`` — deadlock / throughput /
slack / congestion / X-propagation audits over one PnR'd application).
"""
from .diagnostics import (AnalysisError, AnalysisReport, Diagnostic,
                          Severity)
from .framework import (RULES, AnalysisContext, AnalysisPass, analyze,
                        register_rule, rule_set_version, rule_table)
from . import rules as _builtin_rules  # noqa: F401  (registration import)
from . import lowered as _lowered_rules  # noqa: F401
from . import routed as _routed_rules  # noqa: F401
from .routed import DEFAULT_CLOCK_NS, routed_static_metrics  # noqa: F401

__all__ = [
    "AnalysisContext", "AnalysisError", "AnalysisPass", "AnalysisReport",
    "DEFAULT_CLOCK_NS", "Diagnostic", "RULES", "Severity", "analyze",
    "register_rule", "routed_static_metrics", "rule_set_version",
    "rule_table",
]
