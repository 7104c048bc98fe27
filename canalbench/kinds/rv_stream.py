"""Token streams across the hybrid ready-valid fabric
(``RVFabric.run_with_sources``).

Set-up compiles the configuration (a ready-valid spec) and makes each of
the mix's ``routes`` a configuration: ``east`` is the stream straight
east across every column (``east_route``); an app name (``pointwise``)
is that app placed and routed (the executor's PnR knobs, from the mix)
and bound with its PE program. A route runs ``depth`` sweeps each way a
cycle: in split-FIFO mode the ready chain passes through every stage of
the route combinationally, so one sweep an edge (``len(edges) + 2``);
with full FIFOs the route's register-free depth. The control
(``control="depth"``) runs split FIFOs at the full-FIFO depth, the cut a
later change would be tempted by.

Each unit is one chunk of ``chunk_cycles`` cycles on the next route in
turn: ``tokens`` seeded 16-bit words at the route's source, every sink
ready with probability ``sink_ready`` but for the last ``drain`` cycles,
drawn from ``(--seed, chunk)``.
"""
from __future__ import annotations

import numpy as np

from canalbench import reference, roofline
from canalbench.kinds import (app_graph, fabric_shape, load_apps,
                              load_library, make_spec)


#: the mix shrunk to what the CPU tests run in a second or two
SMALL_TRAFFIC = dict(chunk_cycles=24, tokens=6, drain=12, trace_cycles=2,
                     warm_cycles=1)


class Generator:
    def __init__(self, run, config, traffic, seed, device="cuda",
                 use_kernels=True, control=None):
        self.run, self.config, self.traffic = run, config, traffic
        self.seed, self.device = seed, device
        self.use_kernels, self.control = use_kernels, control
        self._failed = 0           # units the check found wrong
        self.kinds = list(traffic["routes"])
        self.apps = load_apps([k for k in self.kinds if k != "east"])
        self.chunks = []           # (route, chunk index, delivered tokens)

    def setup(self):
        import canal_torch
        from repro_torch.fabric import AppEmulator, east_route

        load_library(self.device, self.use_kernels)
        with self.run.span("rv.compile"):
            self.cf = canal_torch.compile(make_spec(self.config),
                                          device=self.device,
                                          use_kernels=self.use_kernels)
            self.fab = self.cf.fabric()
        fab = self.fab
        io = {tuple(c): i for i, c in enumerate(fab.io_coords)}
        width = fab.ic.dims()[0]
        self.routes = {}
        for kind in self.kinds:
            if kind == "east":
                edges = east_route(fab.ic)
                route = {"config": fab.route_to_config(edges),
                         "pe_cfg": None, "src": io[(0, 1)],
                         "dst": io[(width - 1, 1)]}
            else:
                pnr = self.traffic["pnr"]
                with self.run.span("rv.pnr"):
                    r = self.cf.place_and_route(
                        app_graph(self.apps[kind]),
                        alphas=tuple(pnr["alphas"]),
                        sa_steps=pnr["sa_steps"], sa_batch=pnr["sa_batch"])
                if not r.success:
                    raise RuntimeError(f"{kind}: PnR failed: {r.error}")
                edges = r.route_edges()
                emu = AppEmulator.from_pnr(fab, r.packed, r)
                ins = reference.app_ios(self.apps[kind], "io_in")
                outs = reference.app_ios(self.apps[kind], "io_out")
                route = {"config": emu.config, "pe_cfg": emu.pe_cfg,
                         "src": io[tuple(r.placement[ins[0]])],
                         "dst": io[tuple(r.placement[outs[0]])]}
            split = fab.fifo_mode == "split" and self.control != "depth"
            route["depth"] = (len(edges) + 2 if split
                              else fab.depth_for_route(edges))
            self.routes[kind] = route
        self.shape = fabric_shape(fab)
        self._chunk(self.kinds[0], np.random.default_rng([self.seed, 1 << 40]),
                    int(self.traffic.get("warm_cycles", 8)))

    def _sources(self, route, rng, cycles):
        """The chunk's inputs: tokens at the source, sinks' readiness."""
        n_io, k = self.fab.num_io, int(self.traffic["tokens"])
        streams = np.zeros((cycles, n_io), np.int32)
        lens = np.zeros(n_io, np.int32)
        tokens = rng.integers(1, 1 << 16, k)
        streams[:min(k, cycles), route["src"]] = tokens[:cycles]
        lens[route["src"]] = k
        sink = (rng.random((cycles, n_io))
                < float(self.traffic["sink_ready"])).astype(np.int32)
        drain = int(self.traffic.get("drain", 0))
        if drain:
            sink[-drain:] = 1
        return tokens, streams, lens, sink

    def _chunk(self, kind, rng, cycles):
        route = self.routes[kind]
        tokens, streams, lens, sink = self._sources(route, rng, cycles)
        fab = self.fab
        before = fab.kernel_cycles, fab.graph_replays
        od, ov, acc = (o.cpu().numpy() for o in fab.run_with_sources(
            route["config"], streams, lens, sink, pe_cfg=route["pe_cfg"],
            depth=route["depth"]))
        dst = route["dst"]
        delivered = od[:, dst][acc[:, dst] > 0]
        return tokens, delivered, {
            "kernel_cycles": fab.kernel_cycles - before[0],
            "graph_replays": fab.graph_replays - before[1]}

    # ----------------------------------------------------------- window
    def unit(self, i):
        kind = self.kinds[i % len(self.kinds)]
        cycles = int(self.traffic["chunk_cycles"])
        _, delivered, launches = self._chunk(
            kind, np.random.default_rng([self.seed, i]), cycles)
        self.chunks.append((kind, i, delivered))
        return {"kind": "rv", "cycles": cycles, "route": kind, **launches}

    def trace_units(self):
        cycles = int(self.traffic.get("trace_cycles", 8))
        for j, kind in enumerate(self.kinds):
            def one(kind=kind, j=j):
                self._chunk(kind, np.random.default_rng(
                    [self.seed, 1 << 41, j]), cycles)
                s = self.shape
                return roofline.rv_cycles(
                    s["connections"], s["num_config"], s["fifo_stages"],
                    s["num_io"], self.routes[kind]["depth"], cycles)
            yield {"kind": "rv", "run": one}

    def release(self):
        self.routes = self.fab = self.cf = None

    # ------------------------------------------------------------ check
    def check(self):
        parts = []
        self._failed = 0
        for kind, i, delivered in self.chunks:
            rng = np.random.default_rng([self.seed, i])
            k = int(self.traffic["tokens"])
            tokens = rng.integers(1, 1 << 16, k)
            if kind == "east":
                want = tokens
            else:
                app = self.apps[kind]
                name = reference.app_ios(app, "io_in")[0]
                out = reference.app_ios(app, "io_out")[0]
                want = reference.evaluate(app, {name: tokens})[out]
            f = reference.token_faults(want, delivered)
            parts.append(f)
            self._failed += any(f.values())
        total = reference.sum_faults(parts)
        return {k: (total.get(k, 0), 0)
                for k in ("tokens_missing", "tokens_extra", "tokens_wrong")}

    def outcome(self):
        return len(self.chunks), self._failed
