"""``python -m canal_torch.lint`` — the static analyzer as a CI-friendly
CLI (counterpart of repro/core/analysis/lint.py).

Lints interconnect design points — spec JSON files and/or importable
Python design points — through the same
:func:`repro_torch.core.analysis.analyze` driver the compile front door
and the DSE pre-screen use.

Targets:

* positional arguments: paths to ``InterconnectSpec`` JSON files
  (``spec.to_json()`` output);
* ``--config module:attr``: an importable design point — an
  ``InterconnectSpec``, a ``CompiledFabric``, an ``Interconnect``, a
  spec dict, or a zero-argument callable returning any of those
  (e.g. ``--config repro_torch.configs.cgra_amber:smoke``).

Output: lint-style text (default) or ``--format json`` (one document
covering all targets, the CI artifact shape); ``--output`` writes the
report to a file *in addition to* the terminal summary.

Exit codes (CI contract): ``0`` every target clean at the ``--fail-on``
severity (default ``error``); ``1`` at least one finding reached it;
``2`` usage or load error (unreadable file, unknown rule id, bad
import) — distinct from ``1`` so a misconfigured CI job cannot pass as
"findings found" or vice versa.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from dataclasses import replace
from typing import List, Optional, Tuple

from .diagnostics import AnalysisReport, Diagnostic, Severity
from .framework import RULES, analyze, rule_set_version, rule_table

USAGE_ERROR = 2


class LintError(Exception):
    """A target could not be loaded/analyzed (exit code 2)."""


def _load_config(ref: str):
    """Resolve ``module:attr`` (or ``module.attr``) to a design point."""
    mod_name, sep, attr = ref.partition(":")
    if not sep:
        mod_name, _, attr = ref.rpartition(".")
        if not mod_name:
            raise LintError(f"--config {ref!r}: expected module:attr")
    try:
        mod = importlib.import_module(mod_name)
    except ImportError as e:
        raise LintError(f"--config {ref!r}: cannot import "
                        f"{mod_name!r}: {e}") from e
    try:
        obj = getattr(mod, attr)
    except AttributeError:
        raise LintError(
            f"--config {ref!r}: module {mod_name!r} has no "
            f"attribute {attr!r}") from None
    if callable(obj) and not hasattr(obj, "graphs") \
            and not hasattr(obj, "interconnect"):
        obj = obj()
    return obj


def _to_point(obj, origin: str) -> Tuple[object, Optional[object]]:
    """Normalize a loaded design point to ``(ic, spec)``."""
    from ..graph import Interconnect
    from ..spec import InterconnectSpec

    if isinstance(obj, dict):
        obj = InterconnectSpec.from_dict(obj)
    if isinstance(obj, InterconnectSpec):
        from ..passes import PassManager
        return PassManager().run(obj), obj
    if hasattr(obj, "interconnect") and hasattr(obj, "spec"):
        return obj.interconnect, obj.spec         # CompiledFabric
    if isinstance(obj, Interconnect):
        return obj, getattr(obj, "spec", None)
    raise LintError(
        f"{origin}: cannot lint a {type(obj).__name__} — expected an "
        "InterconnectSpec, spec dict, Interconnect or CompiledFabric")


def _load_spec_file(path: str):
    from ..spec import InterconnectSpec
    try:
        with open(path) as fh:
            text = fh.read()
    except OSError as e:
        raise LintError(f"{path}: {e}") from e
    try:
        return InterconnectSpec.from_json(text)
    except (ValueError, TypeError, KeyError) as e:
        raise LintError(f"{path}: not a spec JSON: {e}") from e


def _list_rules() -> str:
    lines = [f"{'RULE':26s} {'SCOPE':8s} {'SEVERITY':8s} DESCRIPTION"]
    for r in rule_table():
        lines.append(f"{r.name:26s} {r.scope:8s} "
                     f"{r.default_severity.name.lower():8s} "
                     f"{r.description}")
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m canal_torch.lint",
        description="Static analysis over interconnect design points.")
    ap.add_argument("specs", nargs="*", metavar="SPEC.json",
                    help="InterconnectSpec JSON files to lint")
    ap.add_argument("--config", action="append", default=[],
                    metavar="MODULE:ATTR",
                    help="importable design point (spec, CompiledFabric, "
                         "Interconnect, or zero-arg factory); repeatable")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids (default: all IR rules)")
    ap.add_argument("--fail-on", default="error",
                    choices=["info", "warn", "warning", "error"],
                    help="severity that sets exit code 1 — one of "
                         "'info', 'warn'/'warning', 'error' "
                         "(default: error)")
    ap.add_argument("--format", default="text",
                    choices=["text", "json"], help="report format")
    ap.add_argument("--output", "-o", default=None, metavar="FILE",
                    help="also write the report (always JSON) to FILE")
    ap.add_argument("--lowered", action="store_true",
                    help="additionally run the post-lowering verification "
                         "rules (compiles the fabric; costs device time)")
    ap.add_argument("--device", default=None,
                    help="device of --lowered and --routed (default: the "
                         "CUDA card; 'cpu' runs the plain versions of the "
                         "kernels on the host)")
    ap.add_argument("--routed", action="store_true",
                    help="additionally run the routed-scope rules: each "
                         "design point is placed-and-routed on the --app "
                         "benchmark(s) (costs PnR time); with --store, "
                         "also audits the persisted routed verdicts")
    ap.add_argument("--app", action="append", default=[], metavar="NAME",
                    help="benchmark app(s) to place-and-route for "
                         "--routed (default: pointwise; repeatable; see "
                         "repro_torch.core.pnr.app.BENCH_APPS)")
    ap.add_argument("--clock", type=float, default=None, metavar="NS",
                    help="target clock period for the routed sta-slack "
                         "rule (default: no target — slack not gated)")
    ap.add_argument("--store", default=None, metavar="PATH",
                    help="lint the result store at PATH: every record's "
                         "persisted analysis verdict (and, with "
                         "--routed, per-app routed verdicts) becomes a "
                         "target — stale rule-set stamps and non-clean "
                         "stored verdicts are findings")
    ap.add_argument("--per-pass", action="store_true", dest="per_pass",
                    help="attribute each finding to the pipeline pass "
                         "that introduced it (spec targets only; slower)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    return ap


def run(argv: Optional[List[str]] = None,
        out=None) -> int:
    out = out or sys.stdout
    args = build_parser().parse_args(argv)
    if args.list_rules:
        print(_list_rules(), file=out)
        return 0
    if not args.specs and not args.config and not args.store:
        print("error: no targets (pass SPEC.json files, --config "
              "module:attr and/or --store PATH; see --help)",
              file=sys.stderr)
        return USAGE_ERROR
    rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    fail_on = Severity.from_str(
        {"warn": "warning"}.get(args.fail_on, args.fail_on))

    targets: List[Tuple[str, object]] = []
    results = []
    worst_clean = True
    try:
        for path in args.specs:
            targets.append((path, _load_spec_file(path)))
        for ref in args.config:
            targets.append((ref, _load_config(ref)))
        if rules is not None:
            unknown = sorted(set(rules) - set(RULES))
            if unknown:
                raise LintError(f"unknown rule id(s) {unknown}; "
                                f"see --list-rules")
        for origin, obj in targets:
            report = _lint_one(obj, origin, rules, args)
            clean = report.ok(fail_on)
            worst_clean = worst_clean and clean
            results.append((origin, report, clean))
        if args.store:
            for origin, report in _lint_store(args.store, args.routed):
                clean = report.ok(fail_on)
                worst_clean = worst_clean and clean
                results.append((origin, report, clean))
    except LintError as e:
        print(f"error: {e}", file=sys.stderr)
        return USAGE_ERROR

    doc = {"fail_on": fail_on.name.lower(),
           "clean": worst_clean,
           "targets": {origin: rep.to_dict()
                       for origin, rep, _ in results}}
    if args.format == "json":
        print(json.dumps(doc, indent=2, sort_keys=True), file=out)
    else:
        for origin, rep, clean in results:
            verdict = "clean" if clean else "FAILED"
            print(f"== {origin}: {verdict} ==", file=out)
            print(rep.render(), file=out)
    if args.output:
        with open(args.output, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
            fh.write("\n")
    return 0 if worst_clean else 1


def _lint_one(obj, origin: str, rules, args):
    from ..spec import InterconnectSpec

    if isinstance(obj, dict):
        obj = InterconnectSpec.from_dict(obj)
    if args.per_pass and isinstance(obj, InterconnectSpec):
        from ..passes import PassManager
        from ..passes import PassContext, _default_core_fn
        pm = PassManager()
        ctx = PassContext(spec=obj, core_fn=_default_core_fn(obj))
        pm.run(obj, core_fn=ctx.core_fn, ctx=ctx, analyze_per_pass=True)
        report = ctx.analysis_report
        ic, spec = ctx.ic, obj
    else:
        ic, spec = _to_point(obj, origin)
        report = analyze(ic, spec=spec, rules=rules)
    if rules is not None and args.per_pass:
        report.diagnostics = [d for d in report.diagnostics
                              if d.rule in set(rules)]
    if args.lowered:
        if spec is not None and getattr(spec, "ready_valid", False):
            pass  # lowered verification covers the static interconnect
        else:
            from ..lowering import FabricModule
            fabric = FabricModule(ic, device=args.device, use_kernels=True)
            lowered = analyze(ic, spec=spec, scope="lowered", fabric=fabric)
            report.extend(lowered.diagnostics)
            report.rules_run = tuple(report.rules_run) + tuple(
                lowered.rules_run)
    if args.routed:
        report.extend(_routed_findings(ic, spec, args))
        report.rules_run = tuple(report.rules_run) + tuple(
            r.name for r in rule_table(scope="routed"))
    return report


def _routed_findings(ic, spec, args) -> List[Diagnostic]:
    """Place-and-route the requested bench apps on the design point and
    run the routed-scope rules over each result; findings are prefixed
    with the app they came from."""
    from ..pnr import place_and_route
    from ..pnr.app import BENCH_APPS

    names = args.app or ["pointwise"]
    unknown = sorted(set(names) - set(BENCH_APPS))
    if unknown:
        raise LintError(f"unknown app(s) {unknown}; "
                        f"one of {sorted(BENCH_APPS)}")
    diags: List[Diagnostic] = []
    for name in names:
        try:
            r = place_and_route(ic, BENCH_APPS[name](), alphas=(2.0,),
                                sa_steps=60, sa_batch=16,
                                device=args.device)
            error = r.error if not r.success else None
        except ValueError as e:       # unplaceable (app > fabric)
            r, error = None, str(e)
        if error is not None:
            diags.append(Diagnostic(
                "routed-verdict", Severity.WARNING,
                f"app {name!r} could not be routed ({error}): the "
                "routed rules did not run for it"))
            continue
        rep = analyze(ic, spec=spec, scope="routed", pnr=r,
                      clock_ns=args.clock)
        diags.extend(replace(d, message=f"app {name!r}: {d.message}")
                     for d in rep.diagnostics)
    return diags


def _stored_diags(doc: dict) -> List[Diagnostic]:
    """Rehydrate the diagnostics a store record persisted (they were
    serialized with ``Diagnostic.to_dict``); malformed entries are
    skipped — a corrupt record must not abort the audit."""
    out: List[Diagnostic] = []
    for d in doc.get("diagnostics") or []:
        if not isinstance(d, dict):
            continue
        try:
            out.append(Diagnostic(
                rule=str(d.get("rule", "?")),
                severity=Severity.from_str(d.get("severity", "error")),
                message=str(d.get("message", "")),
                width=d.get("width"),
                tile=tuple(d["tile"]) if d.get("tile") else None,
                node=d.get("node"), hint=d.get("hint"),
                pass_name=d.get("pass_name")))
        except (TypeError, ValueError):
            continue
    return out


#: pseudo-rule ids of the store audit (these findings reflect *stored*
#: verdicts, not a fresh analysis run)
_STORE_AUDIT_RULES = ("stale-rule-set", "stored-verdict")


def _lint_store(root: str, routed: bool
                ) -> List[Tuple[str, AnalysisReport]]:
    """Audit the persisted analysis verdicts of a result store: one
    report per record. A record stamped by a different rule set is
    stale (warning — the executor will recompute it on next use); a
    stored non-clean verdict re-surfaces its persisted diagnostics;
    with ``routed``, each routed app's persisted ``routed_analysis``
    verdict is audited the same way."""
    from ..store import ResultStore

    store = ResultStore(root)
    current = rule_set_version()
    out: List[Tuple[str, AnalysisReport]] = []
    for digest in store.digests():
        rec = store.get(digest)
        if rec is None:
            continue
        diags: List[Diagnostic] = []
        analysis = rec.get("analysis")
        if isinstance(analysis, dict):
            stamp = analysis.get("rule_set")
            if stamp != current:
                diags.append(Diagnostic(
                    "stale-rule-set", Severity.WARNING,
                    f"record analyzed under rule set {stamp!r} but the "
                    f"current rule set is {current!r}: the stored "
                    "verdict is stale and will be recomputed on next "
                    "executor use"))
            if not analysis.get("clean", True):
                diags.extend(_stored_diags(analysis))
        if routed:
            for name, entry in sorted((rec.get("apps") or {}).items()):
                if not isinstance(entry, dict) \
                        or not entry.get("success"):
                    continue
                ra = entry.get("routed_analysis")
                if not isinstance(ra, dict):
                    diags.append(Diagnostic(
                        "stored-verdict", Severity.WARNING,
                        f"app {name!r}: routed without a persisted "
                        "routed-analysis verdict (record predates the "
                        "routed analyzer)"))
                elif not ra.get("clean", True):
                    diags.extend(
                        replace(d, message=f"app {name!r}: {d.message}")
                        for d in _stored_diags(ra))
        rules_run = _STORE_AUDIT_RULES + (tuple(
            r.name for r in rule_table(scope="routed")) if routed else ())
        out.append((f"store:{digest[:12]}",
                    AnalysisReport(diagnostics=diags,
                                   rules_run=rules_run)))
    if not out:
        raise LintError(f"--store {root}: no records to audit")
    return out
