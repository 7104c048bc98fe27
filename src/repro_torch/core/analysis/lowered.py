"""Post-lowering analyses: ``verify.py`` folded into the rule framework.

The paper (§3.3) verifies generated hardware two ways — connectivity
against the IR, and an exhaustive configuration sweep. Those checks lived
in ``repro_torch.core.verify`` as bare assert-raising functions, orphaned from
the compile front door. Here they are registered as ``scope="lowered"``
rules so the same driver, report model, CLI and CI plumbing cover them:

* ``structural-equivalence`` — the lowered fabric's gather tables must
  reproduce the IR fan-in lists exactly (order included — select-bit
  semantics);
* ``config-sweep`` — every (mux, input) connection is driven and observed
  once through the batched fabric.

Both need a compiled :class:`FabricModule` (and the sweep needs device
time), so they are *not* part of the default ``scope="ir"`` set — reach
them via ``CompiledFabric.verify()``, ``analyze(..., scope="lowered",
fabric=...)`` or ``python -m canal_torch.lint --lowered``. The
underlying functions stay importable from ``repro_torch.core.verify``.
"""
from __future__ import annotations

from typing import Iterator

from .diagnostics import Diagnostic, Severity
from .framework import AnalysisContext, register_rule


def _has_fabric(ctx: AnalysisContext) -> bool:
    return ctx.fabric is not None


@register_rule(
    "structural-equivalence",
    description="lowered fabric gather tables reproduce the IR fan-in "
                "lists exactly (paper §3.3 RTL-vs-IR check)",
    scope="lowered", when=_has_fabric)
def structural_equivalence(ctx: AnalysisContext) -> Iterator[Diagnostic]:
    from ..verify import verify_structural
    try:
        verify_structural(ctx.ic, ctx.fabric)
    except AssertionError as e:
        yield Diagnostic(
            rule="structural-equivalence", severity=Severity.ERROR,
            message=f"lowered connectivity deviates from the IR: {e}",
            hint="the lowering or a post-freeze IR mutation is buggy; "
                 "re-lower from the frozen IR")


@register_rule(
    "config-sweep",
    description="every (mux, input) connection drives and observes "
                "correctly through the lowered fabric (paper §3.3 "
                "exhaustive configuration test)",
    scope="lowered", when=_has_fabric)
def config_sweep_rule(ctx: AnalysisContext) -> Iterator[Diagnostic]:
    from ..verify import config_sweep
    try:
        checked = config_sweep(ctx.fabric)
    except AssertionError as e:
        yield Diagnostic(
            rule="config-sweep", severity=Severity.ERROR,
            message=f"configuration sweep failed: {e}",
            hint="a mux select routes the wrong source; check the "
                 "config-slot assignment in lowering")
    else:
        yield Diagnostic(
            rule="config-sweep", severity=Severity.INFO,
            message=f"{checked} mux connection(s) verified")
