"""Cold design points through ``SweepExecutor.run_points``.

Each unit is one design point of the mix's ``points`` (``[sb_type,
num_tracks]`` over the configuration, in a fixed order, repeating) on a
fresh executor (``store=False``, the executor's defaults: ``auto``
strategies, pipelined emulation joined before ``run_points`` returns):
the benchmark first calls ``interconnect`` and ``fabric`` (the
``dse.compile`` span), then ``run_points`` (PnR of the mix's apps, the
record with the point's areas, and the batched emulation of
``emulate_cycles``). PnR seeds are fixed by the point (the spec's
default), so every run does the same PnR work; the executor drives its
own counter stimulus, so ``--seed`` changes nothing here.

The harness observes, for the check, what PnR placed and what the
emulation produced: it wraps ``repro_torch.core.dse.place_and_route``
and ``repro_torch.fabric.run_apps_batch`` (the names the executor calls)
with recorders that pass every call through unchanged. The control
(``control="depth"``) hands the emulation each app's routed depth halved.
"""
from __future__ import annotations

import numpy as np

from canalbench import reference
from canalbench.kinds import (app_graph, geometry, load_apps, load_library,
                              make_spec)


#: the mix shrunk to what the CPU tests run in a second or two
SMALL_TRAFFIC = dict(points=[["wilton", 3], ["imran", 3]],
                     warm_spec={"width": 6, "height": 6})


class Generator:
    def __init__(self, run, config, traffic, seed, device="cuda",
                 use_kernels=True, control=None):
        self.run, self.config, self.traffic = run, config, traffic
        self.device, self.use_kernels = device, use_kernels
        self.control = control
        self._failed = 0           # apps the check found wrong
        self.apps = load_apps(traffic["apps"])
        self.cycles = int(traffic["emulate_cycles"])
        self.done = []          # (point's spec fields, record, pnr, outputs)
        self._restore = []

    # ----------------------------------------------------------- set-up
    def setup(self):
        import repro_torch.fabric as fabric_pkg
        from repro_torch.core import dse

        load_library(self.device, self.use_kernels)
        self.points = [make_spec(self.config, sb_type=sb, num_tracks=t)
                       for sb, t in self.traffic["points"]]
        self._calls = {"pnr": [], "emu": []}
        pnr, emu = dse.place_and_route, fabric_pkg.run_apps_batch
        calls, control = self._calls, self.control

        def place_and_route(*a, **kw):
            r = pnr(*a, **kw)
            calls["pnr"].append(r)
            return r

        def run_apps_batch(emulators, inputs, cycles, **kw):
            if control == "depth":
                for e in emulators:
                    e.depth = max(1, e.depth // 2)
            outs = emu(emulators, inputs, cycles, **kw)
            calls["emu"].append(outs)
            return outs

        dse.place_and_route = place_and_route
        fabric_pkg.run_apps_batch = run_apps_batch
        self._restore = [(dse, "place_and_route", pnr),
                         (fabric_pkg, "run_apps_batch", emu)]
        warm = self.traffic.get("warm_spec")
        if warm is not None:
            self._point(make_spec(self.config, **warm), "dse.warm")

    def _point(self, spec, prefix="dse"):
        from repro_torch.core.dse import SweepExecutor

        builders = {n: (lambda a=a: app_graph(a))
                    for n, a in self.apps.items()}
        ex = SweepExecutor(apps=builders, emulate_cycles=self.cycles,
                           use_kernels=self.use_kernels, store=False,
                           device=self.device)
        self._calls["pnr"].clear()
        self._calls["emu"].clear()
        with self.run.span(prefix + ".compile"):
            ic = ex.interconnect(spec)
            ex.fabric(ic, ex._key(spec))
        with self.run.span(prefix + ".run_points"):
            rec = ex.run_points([(spec, {})], record=False)[0]
        return rec, list(self._calls["pnr"]), list(self._calls["emu"])

    # ----------------------------------------------------------- window
    def unit(self, i):
        spec = self.points[i % len(self.points)]
        rec, pnr, emu = self._point(spec)
        sb, tracks = self.traffic["points"][i % len(self.points)]
        self.done.append((dict(self.config["spec"], sb_type=sb,
                               num_tracks=tracks), rec, pnr, emu))
        return {"kind": "dse", "points": 1,
                "pnr_seconds": [a["seconds"] for a in rec["apps"].values()]}

    def trace_units(self):
        spec = self.points[0]

        def one():
            self._point(spec, "dse.sample")
            return {"points": 1}

        yield {"kind": "dse", "run": one}

    def release(self):
        for mod, name, fn in self._restore:
            setattr(mod, name, fn)
        self._restore = []

    # ------------------------------------------------------------ check
    def check(self):
        geo = geometry(self.config)
        faults = {"area_mismatches": 0, "apps_unrouted": 0,
                  "placement_faults": 0, "wrong_outputs": 0,
                  "record_mismatches": 0}
        self._failed = 0
        #: wrong output streams of each app (what PERF.md reports)
        self.wrong_by_app = {}
        x = np.arange(1, self.cycles + 1, dtype=np.int64)
        for point, rec, pnr, emu in self.done:
            faults["area_mismatches"] += reference.area_mismatch(point, rec)
            names = list(self.apps)
            routed = [r for r in pnr if r.success]
            outs = emu[0] if len(emu) == 1 else None
            if len(pnr) != len(names) or (routed and outs is None):
                faults["record_mismatches"] += 1
                self._failed += len(names)
                continue
            k = 0
            for name, r in zip(names, pnr):
                app = self.apps[name]
                entry = rec["apps"].get(name, {})
                bad = 0
                if not (r.success and entry.get("success")):
                    faults["apps_unrouted"] += 1
                    self._failed += 1
                    continue
                f = reference.placement_faults(app, r.placement, geo)
                faults["placement_faults"] += f
                got = outs[k]
                k += 1
                streams = {o: got.get(tuple(r.placement[o]))
                           for o in reference.app_ios(app, "io_out")}
                ins = {i: x for i in reference.app_ios(app, "io_in")}
                w = reference.wrong_streams(app, ins, streams)
                faults["wrong_outputs"] += w
                if w:
                    self.wrong_by_app[name] = self.wrong_by_app.get(
                        name, 0) + w
                emu_rec = entry.get("emulation", {})
                checksum = int(sum(int(np.asarray(v, np.int64).sum())
                                   for v in got.values()) & 0xFFFFFFFF)
                if (emu_rec.get("out_checksum") != checksum
                        or emu_rec.get("cycles") != self.cycles):
                    faults["record_mismatches"] += 1
                    bad += 1
                if f or w or bad:
                    self._failed += 1
        return {k: (v, 0) for k, v in faults.items()}

    def outcome(self):
        return len(self.done) * len(self.apps), self._failed
