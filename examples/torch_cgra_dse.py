"""Design-space exploration on the PyTorch/CUDA port (counterpart of
cgra_dse.py): sweep switch-box topology and track count through the
persistent, store-backed serving front end (``canal_torch.serve``),
report area, routability and critical path, let a search selector walk
the track axis, and run the same Canal router on a pod's traffic.

Re-run it: the second invocation serves every design point from the
on-disk result store (``--store``, default ``.canal_torch_store`` or
``$CANAL_TORCH_RESULT_STORE``) by spec digest, with no PnR.

    PYTHONPATH=src python examples/torch_cgra_dse.py [--device cpu]
        [--store DIR] [--size 8] [--tracks 2,4,6] [--budget 4]

Without ``--device`` it runs on the CUDA card, the fabric through the
hand-written kernels.
"""
import argparse

import numpy as np

import canal_torch
from repro_torch.core.dse import sweep_sb_topology
from repro_torch.core.ici import pod_collective_model, route_traffic_canal
from repro_torch.core.pnr.app import app_butterfly
from repro_torch.device import on_card


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--store", type=str, default=None,
                    help="result store root (default: "
                         "$CANAL_TORCH_RESULT_STORE or .canal_torch_store)")
    ap.add_argument("--size", type=int, default=8,
                    help="fabric width and height")
    ap.add_argument("--tracks", type=str, default="2,4,6",
                    help="track counts of the grid")
    ap.add_argument("--budget", type=int, default=4,
                    help="evaluations the search may spend")
    ap.add_argument("--sa-steps", type=int, default=40)
    args = ap.parse_args(argv)
    tracks = tuple(int(t) for t in args.tracks.split(","))

    # one serving front end for the whole run: coalescing queries
    # over the persistent result store, misses batched through a shared
    # executor on the device
    svc = canal_torch.serve(store=args.store, device=args.device,
                            use_kernels=on_card(args.device),
                            apps={"butterfly3": lambda: app_butterfly(3)})

    print("== topology DSE (Wilton vs Disjoint, Fc=0.5) ==")
    recs = sweep_sb_topology(
        (canal_torch.SwitchBoxType.WILTON, canal_torch.SwitchBoxType.DISJOINT),
        num_tracks=4, width=args.size, height=args.size, track_fc=0.5,
        executor=svc.executor)
    for r in recs:
        print(f"  {r['topology']:9s} routed {r['n_routed']}/{r['n_apps']} "
              f"sb_area={r['sb_area']:.0f}um2")

    print("== track-count DSE (spec grid served by digest) ==")
    base = canal_torch.InterconnectSpec(width=args.size, height=args.size,
                                        io_ring=True, reg_density=1.0,
                                        cb_track_fc=0.5, sb_track_fc=0.5,
                                        sa_steps=args.sa_steps)
    grid = canal_torch.spec_grid(base, {"num_tracks": tracks})
    recs = svc.query([spec for spec, _ in grid])
    for (spec, extra), r in zip(grid, recs):
        ok = [a for a in r["apps"].values() if a["success"]]
        crit = (sum(a["critical_path_ns"] for a in ok) / len(ok)
                if ok else float("nan"))
        print(f"  tracks={extra['num_tracks']} sb={r['sb_area']:.0f}um2 "
              f"cb={r['cb_area']:.0f}um2 routed={len(ok)} "
              f"crit={crit:.2f}ns spec={r['spec_digest'][:10]}")

    # querying the same grid again is pure store/coalesce traffic
    svc.query([spec for spec, _ in grid])
    st = svc.stats()
    print(f"  serve stats: hits={st['hits']} misses={st['misses']} "
          f"hit_rate={st['hit_rate']:.2f} "
          f"warm-query avg {st['latency_avg_s'] * 1e3:.1f} ms "
          f"(store: {st['store']['records']} records on disk)")

    print("== search-driven DSE (greedy selector vs full grid) ==")
    res = svc.recommend(base, {"num_tracks": tuple(range(min(tracks),
                                                         max(tracks) + 1))},
                        objective="area",
                        constraints={"min_routability": 1.0},
                        budget=args.budget, batch_size=2)
    for p in res["frontier"]:
        m = p["metrics"]
        print(f"  frontier: tracks={p['spec']['num_tracks']} "
              f"area={m['area']:.0f}um2 crit={m['critical_path_ns']:.2f}ns "
              f"routability={m['routability']:.2f}")
    best = res["best"]
    label = (f"tracks={best['spec']['num_tracks']}" if best
             else "none feasible")
    print(f"  best (min area, fully routable): {label} "
          f"after {res['stats']['evaluated']} evaluations "
          f"(grid is {res['stats']['space_size']} points; "
          f"{res['stats']['executor']['pnr_computations']} new PnR)")

    print("== pod-fabric DSE (Canal router on the ICI torus) ==")
    rng = np.random.default_rng(0)
    flows = [((int(rng.integers(0, 4)), int(rng.integers(0, 4))),
              (int(rng.integers(0, 4)), int(rng.integers(0, 4))))
             for _ in range(10)]
    flows = [(s, d) for s, d in flows if s != d]
    result, usage = route_traffic_canal(4, 4, flows)
    print(f"  {len(result.nets)} flows routed in "
          f"{result.iterations} PathFinder iterations, "
          f"max transit usage {usage.max()}")
    out = pod_collective_model({"all-reduce": 1e9, "all-gather": 4e8},
                               {"data": 16, "model": 16})
    print(f"  collective model: congestion x{out['congestion_factor']:.2f}"
          f" -> {out['collective_time_s'] * 1e3:.2f} ms "
          f"(naive {out['naive_time_s'] * 1e3:.2f} ms)")
    print("OK")


if __name__ == "__main__":
    main()
