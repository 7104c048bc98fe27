"""``python -m canal_torch.search`` — the search-driven DSE CLI.

Runs :func:`repro_torch.core.search.search` over axes given as JSON and
emits the Pareto frontier (plus the scalarized best point and run
stats) as a JSON document, store-backed by default so repeated runs
are pure store hits.

Exit codes: 0 = frontier non-empty, 1 = empty frontier (nothing valid
evaluated), 2 = usage error.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from ..spec import InterconnectSpec


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m canal_torch.search",
        description="Search-driven DSE over InterconnectSpec space: "
                    "selector proposes, the store-backed executor "
                    "evaluates, the Pareto frontier over (area, "
                    "critical-path delay, routability) comes out as "
                    "JSON.")
    g = p.add_argument_group("search space")
    g.add_argument("--base", metavar="FILE",
                   help="base spec as a JSON file (InterconnectSpec "
                        "fields); default: a width x height fabric "
                        "with an IO ring")
    g.add_argument("--width", type=int, default=4,
                   help="base fabric width when --base is not given "
                        "(default 4)")
    g.add_argument("--height", type=int, default=None,
                   help="base fabric height (default: width)")
    g.add_argument("--axes", required=True, metavar="JSON",
                   help="search axes as a JSON object, e.g. "
                        "'{\"num_tracks\": [2, 3, 4]}'")
    g = p.add_argument_group("search policy")
    g.add_argument("--selector", default="greedy",
                   choices=["random", "greedy", "evolutionary"])
    g.add_argument("--objective", default="area",
                   choices=["area", "critical_path_ns", "routability",
                            "throughput", "min_slack_ns"])
    g.add_argument("--max-delay", type=float, default=None,
                   metavar="NS",
                   help="constraint: max critical path (ns)")
    g.add_argument("--max-area", type=float, default=None,
                   help="constraint: max SB+CB area")
    g.add_argument("--min-routability", type=float, default=None,
                   metavar="FRAC",
                   help="constraint: min routed-app fraction")
    g.add_argument("--min-throughput", type=float, default=None,
                   metavar="TOK",
                   help="constraint: min static throughput bound "
                        "(tokens/cycle, from the routed analyzer)")
    g.add_argument("--min-slack", type=float, default=None,
                   metavar="NS",
                   help="constraint: min per-net slack (ns) against "
                        "the reference clock")
    g.add_argument("--budget", type=int, default=32,
                   help="max candidates to evaluate (default 32)")
    g.add_argument("--batch", type=int, default=4,
                   help="candidates per executor batch (default 4)")
    g.add_argument("--seed", type=int, default=0)
    g = p.add_argument_group("evaluation")
    g.add_argument("--apps", default=None, metavar="NAMES",
                   help="comma-separated benchmark apps (default: all "
                        "of repro_torch.core.pnr.app.BENCH_APPS)")
    g.add_argument("--emulate-cycles", type=int, default=0)
    g.add_argument("--store", default=None, metavar="PATH",
                   help="result-store root (default: "
                        "CANAL_TORCH_RESULT_STORE, else "
                        ".canal_torch_store)")
    g.add_argument("--no-store", action="store_true",
                   help="run cold: no persistent memoization")
    g.add_argument("--device", default=None,
                   help="device for PnR and emulation (default: the "
                        "CUDA card, emulating through the hand-written "
                        "kernels; 'cpu' runs their plain versions)")
    p.add_argument("-o", "--output", default=None, metavar="FILE",
                   help="write the JSON document here (default: "
                        "stdout)")
    p.add_argument("--include-records", action="store_true",
                   help="embed the full DSE records in the output")
    return p


def _load_base(ns) -> InterconnectSpec:
    if ns.base:
        with open(ns.base) as f:
            return InterconnectSpec.from_dict(json.load(f))
    h = ns.height if ns.height is not None else ns.width
    return InterconnectSpec(width=ns.width, height=h, io_ring=True,
                            reg_density=1.0)


def run(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    ns = parser.parse_args(argv)
    try:
        axes = json.loads(ns.axes)
        if not isinstance(axes, dict):
            raise ValueError("--axes must be a JSON object")
        base = _load_base(ns)
    except (OSError, ValueError) as e:
        parser.exit(2, f"error: {e}\n")
    constraints = {}
    if ns.max_delay is not None:
        constraints["max_critical_path_ns"] = ns.max_delay
    if ns.max_area is not None:
        constraints["max_area"] = ns.max_area
    if ns.min_routability is not None:
        constraints["min_routability"] = ns.min_routability
    if ns.min_throughput is not None:
        constraints["min_throughput"] = ns.min_throughput
    if ns.min_slack is not None:
        constraints["min_slack_ns"] = ns.min_slack

    apps = None
    if ns.apps:
        from ..pnr.app import BENCH_APPS
        names = [a.strip() for a in ns.apps.split(",") if a.strip()]
        unknown = sorted(set(names) - set(BENCH_APPS))
        if unknown:
            parser.exit(2, f"error: unknown apps {unknown}; "
                           f"one of {sorted(BENCH_APPS)}\n")
        apps = {n: BENCH_APPS[n] for n in names}

    from .driver import search
    from .space import SearchSpace
    try:
        space = SearchSpace(base, axes)
    except (TypeError, ValueError) as e:
        parser.exit(2, f"error: {e}\n")
    store = False if ns.no_store else ns.store
    if store is None and not ns.no_store:
        from ..store import default_store_root
        store = default_store_root()
    result = search(space=space, selector=ns.selector,
                    objective=ns.objective,
                    constraints=constraints or None,
                    budget=ns.budget, batch_size=ns.batch,
                    seed=ns.seed, store=store, apps=apps,
                    emulate_cycles=ns.emulate_cycles,
                    use_kernels=True, device=ns.device)
    best = result.best(ns.objective, constraints or None)
    doc = {"selector": ns.selector,
           "objective": ns.objective,
           "constraints": constraints,
           "space": space.to_dict(),
           "best": (best.to_dict(ns.include_records)
                    if best is not None else None),
           "frontier": [p.to_dict(ns.include_records)
                        for p in result.frontier],
           "evaluated": [p.to_dict(ns.include_records)
                         for p in result.evaluated],
           "stats": result.stats}
    text = json.dumps(doc, indent=2, sort_keys=True, default=str)
    if ns.output:
        with open(ns.output, "w") as f:
            f.write(text + "\n")
    else:
        sys.stdout.write(text + "\n")
    return 0 if result.frontier else 1


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(run())
