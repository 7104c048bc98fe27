"""The port's roofline and pod-ICI models (``repro_torch.roofline``,
``repro_torch.core.ici``) against the JAX package: ``tests/test_ici.py``'s
cases and ``test_route_minplus.py``'s ICI router case on both packages,
with equal link bytes and equal routes, and the roofline terms and
parameter counts equal. Both sides are host code (numpy and the router),
so everything compares exactly.
"""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke as ref_get_smoke
from repro.core import ici as ref_ici
from repro.models import build_model as ref_build_model
from repro.roofline import analysis as ref_analysis
from repro.roofline import hw as ref_hw
from repro_torch import interop
from repro_torch.core import ici
from repro_torch.models import build_model
from repro_torch.roofline import analysis, hw

PACKAGES = {"ref": ref_ici, "port": ici}


def _routes(result):
    return [(n.name, n.src, list(n.sinks), sorted(n.edges()))
            for n in result.nets]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_all_reduce_balanced_on_torus(pkg):
    fab = PACKAGES[pkg].PodFabric(8, 8)
    fab.apply_all_reduce(1e9, "x")
    assert fab.congestion_factor() == pytest.approx(2.0, abs=0.01) or \
        fab.congestion_factor() >= 1.0
    y_loads = [v for (s, d), v in fab.link_bytes.items()
               if fab.coords(s)[0] == fab.coords(d)[0]]
    assert max(y_loads) == 0.0


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_collective_model_congestion_vs_naive(pkg):
    out = PACKAGES[pkg].pod_collective_model(
        {"all-reduce": 1e9, "all-gather": 5e8}, {"data": 16, "model": 16})
    assert out["max_link_bytes"] > 0
    assert out["collective_time_s"] > 0
    assert out["congestion_factor"] >= 1.0


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_canal_router_on_pod(pkg):
    rng = np.random.default_rng(0)
    flows = [((int(rng.integers(0, 4)), int(rng.integers(0, 4))),
              (int(rng.integers(0, 4)), int(rng.integers(0, 4))))
             for _ in range(12)]
    flows = [(s, d) for s, d in flows if s != d]
    result, usage = PACKAGES[pkg].route_traffic_canal(4, 4, flows, lanes=2)
    assert result.overuse_history[-1] == 0
    assert usage.max() <= 2


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_axis_order_dse_changes_congestion(pkg):
    traffic = {"all-gather": 4e9, "all-reduce": 1e8}
    model = PACKAGES[pkg].pod_collective_model
    a = model(traffic, {"data": 16, "model": 16},
              axis_order=("data", "model"))
    b = model(traffic, {"data": 16, "model": 16},
              axis_order=("model", "data"))
    assert a["max_link_bytes"] != b["max_link_bytes"] or \
        a["collective_time_s"] == b["collective_time_s"]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_ici_router_still_green_on_python_path(pkg):
    flows = [((0, 0), (1, 1)), ((1, 0), (0, 1)), ((0, 1), (1, 0))]
    result, usage = PACKAGES[pkg].route_traffic_canal(2, 2, flows, lanes=2)
    assert len(result.nets) == len(flows)
    assert int(usage.max()) <= 2


def test_link_bytes_equal():
    """Every collective schedule puts the same bytes on the same links
    of a torus; a mesh has the same links."""
    assert ici.PodFabric(4, 6, torus=False).link_bytes == \
        ref_ici.PodFabric(4, 6, torus=False).link_bytes
    for shape in ((4, 6), (8, 8)):
        fabs = [m.PodFabric(*shape) for m in (ref_ici, ici)]
        for fab in fabs:
            fab.apply_all_reduce(3e8, "x")
            fab.apply_all_reduce(1e8, "y", bidirectional=False)
            fab.apply_all_gather(2e8, "y")
            fab.apply_all_to_all(5e7, "x")
        assert fabs[0].link_bytes == fabs[1].link_bytes
        for m in ("max_link_bytes", "total_bytes", "congestion_factor"):
            assert getattr(fabs[0], m)() == getattr(fabs[1], m)()
        assert fabs[0].collective_time() == fabs[1].collective_time()
    traffic = {"all-reduce": 1e9, "all-gather": 5e8, "all-to-all": 2e8,
               "collective-permute": 1e7}
    for order in (("data", "model"), ("model", "data")):
        assert ici.pod_collective_model(traffic, {"data": 8, "model": 32},
                                        axis_order=order) == \
            ref_ici.pod_collective_model(traffic, {"data": 8, "model": 32},
                                         axis_order=order)


@pytest.mark.parametrize("seed", [1, 2])
def test_router_routes_equal(seed, n=4, lanes=2):
    """Canal's PathFinder on the pod: the same nets, the same trees, the
    same usage, in both packages."""
    rng = np.random.default_rng(seed)
    flows = [((int(rng.integers(0, n)), int(rng.integers(0, n))),
              (int(rng.integers(0, n)), int(rng.integers(0, n))))
             for _ in range(10)]
    flows = [(s, d) for s, d in flows if s != d]
    ref_res, ref_use = ref_ici.route_traffic_canal(n, n, flows, lanes=lanes)
    res, use = ici.route_traffic_canal(n, n, flows, lanes=lanes)
    assert _routes(res) == _routes(ref_res)
    assert res.overuse_history == ref_res.overuse_history
    np.testing.assert_array_equal(use, ref_use)


def test_roofline_terms_and_model_flops_equal():
    for args in ((1e15, 1e12, 1e9), (3e12, 8e11, 0.0), (0.0, 0.0, 0.0)):
        assert analysis.roofline_terms(*args) == \
            ref_analysis.roofline_terms(*args)
    for kind in ("train", "prefill"):
        assert analysis.model_flops(1.1e9, 16384, kind) == \
            ref_analysis.model_flops(1.1e9, 16384, kind)
    assert hw.TPU_V5E == hw.ChipSpec(**dataclasses.asdict(ref_hw.TPU_V5E))
    h100 = analysis.roofline_terms(6.0e14, 3.35e12, 0.0, chip=hw.H100_SXM)
    assert h100["compute_s"] == 6.0e14 / 989e12
    assert h100["memory_s"] == 1.0
    assert h100["dominant"] == "memory_s"


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "mamba2_1_3b",
                                  "kimi_k2_1t_a32b"])
def test_param_counts_and_active_params_equal(arch):
    """``count_params`` of the port's model (and of a tree of tensors)
    equals the reference's of its parameter tree; ``active_params``
    agrees on every config, MoE included."""
    import jax
    full = ref_get_config(arch)
    ref_total = ref_analysis.count_params(jax.eval_shape(
        ref_build_model(full).init_params, jax.random.PRNGKey(0)))
    assert analysis.active_params(full, ref_total) == \
        ref_analysis.active_params(full, ref_total)
    if arch == "kimi_k2_1t_a32b":
        return                          # its model comes with a later slice
    cfg = interop.lm_config_from_fields(dataclasses.asdict(full))
    model = build_model(cfg, "meta")
    assert analysis.count_params(model) == ref_total
    smoke = ref_get_smoke(arch)
    tree = ref_build_model(smoke).init_params(jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, tree)
    assert analysis.count_params(np_tree) == ref_analysis.count_params(tree)
    port = build_model(interop.lm_config_from_fields(
        dataclasses.asdict(smoke)), "cpu")
    port.load_state_dict(interop.lm_params_from_numpy(port.cfg, np_tree))
    assert analysis.count_params(port) == ref_analysis.count_params(tree)
