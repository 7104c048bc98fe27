"""Batched emulation of routed apps through ``run_apps_batch``.

Set-up compiles the configuration, places and routes each of the mix's
apps once (the executor's PnR knobs, from the mix) and binds each to the
fabric (``AppEmulator.from_pnr``). Each unit is one batch of ``lanes``
lanes, the apps taken round-robin, each lane with its own 16-bit
stimulus of ``cycles`` cycles drawn from ``(--seed, batch)``, run as one
``run_apps_batch(..., io_chunk=...)`` call between two CUDA events.
The control (``control="depth"``) binds each app with its routed depth
halved.
"""
from __future__ import annotations

import numpy as np

from canalbench import reference, roofline
from canalbench.kinds import (app_graph, fabric_shape, geometry, load_apps,
                              load_library, make_spec)


#: the mix shrunk to what the CPU tests run in a second or two
SMALL_TRAFFIC = dict(lanes=4, cycles=16, trace_units=1)


class Generator:
    def __init__(self, run, config, traffic, seed, device="cuda",
                 use_kernels=True, control=None):
        self.run, self.config, self.traffic = run, config, traffic
        self.seed, self.device = seed, device
        self.use_kernels, self.control = use_kernels, control
        self._failed = 0           # units the check found wrong
        self.apps = load_apps(traffic["apps"])
        self.names = list(self.apps)
        self.lanes = int(traffic["lanes"])
        self.cycles = int(traffic["cycles"])
        self.batches = []          # each batch's outputs at the apps' outs

    def setup(self):
        import canal_torch
        from repro_torch.fabric import AppEmulator

        load_library(self.device, self.use_kernels)
        with self.run.span("emulate.compile"):
            self.cf = canal_torch.compile(make_spec(self.config),
                                          device=self.device,
                                          use_kernels=self.use_kernels)
            self.fab = self.cf.fabric()
        pnr = self.traffic["pnr"]
        self.routed = {}
        with self.run.span("emulate.pnr"):
            for name, app in self.apps.items():
                r = self.cf.place_and_route(
                    app_graph(app), alphas=tuple(pnr["alphas"]),
                    sa_steps=pnr["sa_steps"], sa_batch=pnr["sa_batch"])
                if not r.success:
                    raise RuntimeError(f"{name}: PnR failed: {r.error}")
                self.routed[name] = r
        with self.run.span("emulate.bind"):
            self.emus = {}
            for name, r in self.routed.items():
                e = AppEmulator.from_pnr(self.fab, r.packed, r)
                if self.control == "depth":
                    e.depth = max(1, e.depth // 2)
                self.emus[name] = e
        self.shape = fabric_shape(self.fab)
        self._batch(np.random.default_rng([self.seed, 1 << 40]))

    def _lane_app(self, lane):
        return self.names[lane % len(self.names)]

    def _stimulus(self, rng):
        """Each lane's {io_in name: (cycles,) words}."""
        return [{i: rng.integers(0, 1 << 16, self.cycles, dtype=np.int64)
                 for i in reference.app_ios(self.apps[self._lane_app(k)],
                                            "io_in")}
                for k in range(self.lanes)]

    def _batch(self, rng):
        import torch
        from repro_torch.fabric import run_apps_batch

        stim = self._stimulus(rng)
        emus, ins = [], []
        for k, s in enumerate(stim):
            name = self._lane_app(k)
            r = self.routed[name]
            emus.append(self.emus[name])
            ins.append({tuple(r.placement[i]): v.astype(np.int32)
                        for i, v in s.items()})
        cuda = self.device.startswith("cuda")
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        outs = run_apps_batch(emus, ins, self.cycles,
                              io_chunk=self.traffic.get("io_chunk"))
        ms = None
        if cuda:
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        return outs, ms, [e.depth for e in emus]

    # ----------------------------------------------------------- window
    def unit(self, i):
        outs, ms, depths = self._batch(np.random.default_rng([self.seed, i]))
        kept = []
        for k, out in enumerate(outs):
            name = self._lane_app(k)
            r = self.routed[name]
            kept.append({o: np.array(out[tuple(r.placement[o])])
                         for o in reference.app_ios(self.apps[name],
                                                    "io_out")})
        self.batches.append(kept)
        return {"kind": "emulate", "lanes": self.lanes,
                "app_cycles": self.lanes * self.cycles, "device_ms": ms}

    def trace_units(self):
        for j in range(int(self.traffic.get("trace_units", 1))):
            def one(j=j):
                _, _, depths = self._batch(
                    np.random.default_rng([self.seed, 1 << 41, j]))
                s = self.shape
                return roofline.emulation_batch(
                    s["connections"], s["num_config"], s["num_pe"],
                    s["num_io"], depths, self.cycles)
            yield {"kind": "emulate", "run": one}

    def release(self):
        self.emus = self.fab = self.cf = None

    # ------------------------------------------------------------ check
    def check(self):
        geo = geometry(self.config)
        placed = sum(reference.placement_faults(self.apps[n], r.placement,
                                                geo)
                     for n, r in self.routed.items())
        wrong = 0
        self._failed = 0
        #: wrong output streams of each app (what PERF.md reports)
        self.wrong_by_app = {}
        for b, kept in enumerate(self.batches):
            stim = self._stimulus(np.random.default_rng([self.seed, b]))
            for k, got in enumerate(kept):
                w = reference.wrong_streams(
                    self.apps[self._lane_app(k)], stim[k], got)
                wrong += w
                self._failed += bool(w)
                if w:
                    name = self._lane_app(k)
                    self.wrong_by_app[name] = self.wrong_by_app.get(
                        name, 0) + w
        return {"placement_faults": (placed, 0),
                "wrong_outputs": (wrong, 0)}

    def outcome(self):
        return (len(self.batches) * self.lanes,
                self._failed)
