"""The port's PnR against the reference.

* Routing is deterministic: on the reference's placement (carried across
  as plain data), both ``route_strategy="python"`` and ``"minplus"``
  give route trees and a critical path identical to the reference's.
* Global placement's CG agrees with the reference's ``jax.scipy`` CG
  within ``rtol=1e-4``: both run in float32 and sum in another order.
* Batched annealing draws from a torch ``Generator``, not ``jax.random``,
  so it is held to the reference's own gates (``test_batched_place.py``):
  legality, Eq. 2 cost no worse than host SA at equal steps, routes end
  to end, the same placement across processes for a fixed seed.
"""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.core.passes import PassManager as RefPassManager
from repro.core.pnr.global_place import assign_ios as ref_assign_ios
from repro.core.pnr.global_place import global_place as ref_global_place
from repro.core.pnr.global_place import legalize as ref_legalize
from repro.core.pnr.detailed_place import detailed_place as ref_detailed
from repro.core.pnr.packing import pack as ref_pack
from repro.core.pnr.route import RoutingResources as RefResources
from repro.core.pnr.route import route_app as ref_route_app
from repro.core.pnr.timing import sta_critical_path as ref_sta
from repro.core.spec import InterconnectSpec as RefSpec
from repro_torch import interop
from repro_torch.core.compile import compile_spec
from repro_torch.core.passes import PassManager
from repro_torch.core.pnr.app import BENCH_APPS, app_stencil
from repro_torch.core.pnr.batched_anneal import batched_place, eq2_cost
from repro_torch.core.pnr.detailed_place import detailed_place
from repro_torch.core.pnr.global_place import (assign_ios, global_place,
                                               legalize)
from repro_torch.core.pnr.packing import pack
from repro_torch.core.pnr.route import RoutingResources, route_app
from repro_torch.core.pnr.timing import sta_critical_path
from repro_torch.core.spec import InterconnectSpec

SPEC = dict(width=6, height=6, num_tracks=4, io_ring=True,
            sb_type="wilton", reg_density=1.0)


@functools.lru_cache(maxsize=None)
def _ics():
    ref_ic = RefPassManager().run(RefSpec(**SPEC))
    ic = PassManager().run(InterconnectSpec(**SPEC))
    return ref_ic, RefResources(ref_ic), ic, RoutingResources(ic,
                                                              device="cpu")


@functools.lru_cache(maxsize=None)
def _ref_placement(app_name):
    """The reference's placement of a bench app on the 6x6 fabric."""
    packed = ref_pack(BENCH_APPS[app_name]())
    fixed = ref_assign_ios(packed, 6, 6)
    cont = ref_global_place(packed, 6, 6, fixed=fixed, seed=0)
    base = ref_legalize(packed, cont, 6, 6, io_ring=True, fixed=fixed)
    return ref_detailed(packed, base, 6, 6, io_ring=True, n_steps=30,
                        batch=8, seed=0), packed


def _ref_keys(routing):
    """A reference routing as node-key data (what interop carries)."""
    nodes = routing.resources.nodes
    return [(net.name, nodes[net.src].node_key(),
             [nodes[s].node_key() for s in net.sinks],
             sorted((nodes[p].node_key(), nodes[c].node_key())
                    for p, c in net.edges()))
            for net in routing.nets]


@pytest.mark.parametrize("strategy", ["python", "minplus"])
@pytest.mark.parametrize("app_name", ["pointwise", "tree_reduce",
                                      "butterfly"])
def test_routes_identical_on_reference_placement(app_name, strategy):
    ref_ic, ref_res, ic, res = _ics()
    placement, ref_packed = _ref_placement(app_name)
    want = ref_route_app(ref_ic, ref_packed, placement, res=ref_res,
                         strategy=strategy)
    packed = pack(BENCH_APPS[app_name]())
    got = route_app(ic, packed, dict(placement), res=res, strategy=strategy)
    assert got.strategy == want.strategy == strategy
    assert interop.routing_keys(got) == _ref_keys(want)
    assert got.iterations == want.iterations
    assert sta_critical_path(packed, got, placement) == \
        ref_sta(ref_packed, want, placement)


def test_interop_rebuilds_reference_routing():
    """A reference routing carried as node keys rebuilds the same trees,
    delays and timing in the port."""
    ref_ic, ref_res, ic, res = _ics()
    placement, ref_packed = _ref_placement("fir")
    want = ref_route_app(ref_ic, ref_packed, placement, res=ref_res)
    r = interop.pnr_result(ic, BENCH_APPS["fir"](), placement,
                           _ref_keys(want), resources=res)
    assert interop.routing_keys(r.routing) == _ref_keys(want)
    assert [n.delay for n in r.routing.nets] == [n.delay for n in want.nets]
    assert r.timing == ref_sta(ref_packed, want, placement)


@pytest.mark.parametrize("app_name,mem_cols", [("butterfly", ()),
                                               ("stencil", (3,))])
def test_global_place_cg_matches_reference(app_name, mem_cols):
    ref_packed = ref_pack(BENCH_APPS[app_name]())
    packed = pack(BENCH_APPS[app_name]())
    fixed = assign_ios(packed, 8, 8)
    want = ref_global_place(ref_packed, 8, 8, mem_columns=mem_cols,
                               fixed=fixed, seed=3)
    got = global_place(packed, 8, 8, mem_columns=mem_cols, fixed=fixed,
                       seed=3, device="cpu")
    assert got.keys() == want.keys()
    names = sorted(want)
    # float32 CG in another summation order: rtol 1e-4 on positions that
    # lie in [0, 7]
    np.testing.assert_allclose(np.array([got[n] for n in names]),
                               np.array([want[n] for n in names]),
                               rtol=1e-4, atol=1e-4)


def _baseline(app, width, height, mem_columns=(), seed=0):
    packed = pack(app)
    fixed = assign_ios(packed, width, height)
    cont = global_place(packed, width, height, mem_columns=mem_columns,
                        fixed=fixed, seed=seed, device="cpu")
    base = legalize(packed, cont, width, height, mem_columns=mem_columns,
                    io_ring=True, fixed=fixed)
    return packed, base


def _assert_legal(packed, pl, base, width, height, mem_columns=()):
    tiles = list(pl.values())
    assert len(set(tiles)) == len(tiles), "instances share a tile"
    for name, (x, y) in pl.items():
        kind = packed.placeable[name].kind
        if kind in ("pe", "mem"):
            assert 0 < x < width - 1 and 0 < y < height - 1
            if mem_columns:
                assert (x in mem_columns) == (kind == "mem"), name
        else:
            assert pl[name] == base[name], f"io {name} moved"


@pytest.mark.parametrize("width,height,mem_cols,app_name", [
    (4, 4, (2,), "stencil"), (8, 8, (), "butterfly"), (8, 8, (4,), "stencil"),
])
def test_batched_placement_legal(width, height, mem_cols, app_name):
    packed, base = _baseline(BENCH_APPS[app_name](), width, height,
                             mem_columns=mem_cols)
    pl = batched_place(packed, base, width, height, mem_columns=mem_cols,
                       io_ring=True, n_steps=60, n_chains=8, seed=0,
                       device="cpu")
    _assert_legal(packed, pl, base, width, height, mem_columns=mem_cols)


def test_batched_cost_no_worse_than_host_oracle():
    packed, base = _baseline(BENCH_APPS["butterfly"](), 8, 8)
    pl_b, cost_b = batched_place(packed, base, 8, 8, io_ring=True,
                                 n_steps=120, n_chains=16, seed=0,
                                 return_cost=True, device="cpu")
    pl_h = detailed_place(packed, base, 8, 8, io_ring=True, n_steps=120,
                          batch=16, seed=0, strategy="python", device="cpu")
    cost_h = eq2_cost(packed, pl_h, 8, 8, device="cpu")
    assert cost_b <= cost_h + 1e-4, (cost_b, cost_h)
    assert cost_b <= eq2_cost(packed, base, 8, 8, device="cpu") + 1e-4
    assert abs(eq2_cost(packed, pl_b, 8, 8, device="cpu") - cost_b) < 1e-3


def test_batched_placement_routes():
    spec = InterconnectSpec(width=8, height=8, num_tracks=5, io_ring=True,
                            mem_columns=(4,), place_strategy="batched",
                            sa_steps=60, sa_batch=8, seed=0)
    r = compile_spec(spec, device="cpu").place_and_route(app_stencil())
    assert r.success, r.error
    assert r.place_strategy == "batched"
    assert r.routing is not None and len(r.routing.nets) > 0


_DETERMINISM_SNIPPET = """
import json
from repro_torch.core.pnr.app import BENCH_APPS
from repro_torch.core.pnr.batched_anneal import batched_place
from repro_torch.core.pnr.global_place import (assign_ios, global_place,
                                               legalize)
from repro_torch.core.pnr.packing import pack
packed = pack(BENCH_APPS["fir"]())
fixed = assign_ios(packed, 8, 8)
cont = global_place(packed, 8, 8, fixed=fixed, seed=0, device="cpu")
base = legalize(packed, cont, 8, 8, io_ring=True, fixed=fixed)
pl = batched_place(packed, base, 8, 8, io_ring=True, n_steps=40,
                   n_chains=8, seed=7, device="cpu")
print(json.dumps(sorted((k, list(v)) for k, v in pl.items())))
"""


def test_batched_seeded_determinism_across_processes():
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    outs = []
    for _ in range(2):
        p = subprocess.run([sys.executable, "-c", _DETERMINISM_SNIPPET],
                           capture_output=True, text=True, check=True,
                           env=env)
        outs.append(json.loads(p.stdout.strip().splitlines()[-1]))
    assert outs[0] == outs[1]
