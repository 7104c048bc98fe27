"""Canal's public front door, on the PyTorch/CUDA port (counterpart of
:mod:`canal`).

    import canal_torch

    spec = canal_torch.InterconnectSpec(width=8, height=8, num_tracks=5,
                                        sb_type="wilton", io_ring=True)
    fab = canal_torch.compile(spec, use_kernels=True)   # on the CUDA card
    fab = canal_torch.compile(spec, device="cpu")
    result = fab.place_and_route(app)
    outs = fab.emulate(result, {"in0": stream}, cycles=32)
    words = fab.bitstream(result)
    report = fab.verify()                # §3.3 checks on the card

``compile(spec, device=None, use_kernels=False, analyze="warn")`` runs
the pass pipeline and returns a :class:`CompiledFabric`; ``device=None``
is the CUDA card and raises on a host without one. ``use_kernels`` runs
the fabric (single sweeps, the unfused baseline, the fused engine and
the configuration sweep of ``verify``) through the hand-written CUDA
kernels. ``canal_torch.serve(...)`` is the store-backed DSE service,
``canal_torch.search(...)`` the search-driven optimizer and
:class:`ResultStore` the spec-addressed result store (root
``.canal_torch_store`` or ``$CANAL_TORCH_RESULT_STORE``: the port keeps
its records apart from the JAX package's). ``python -m
canal_torch.lint`` and ``python -m canal_torch.search`` are the CLIs.
"""
from repro_torch.core.analysis import (AnalysisError,  # noqa: F401
                                       AnalysisPass, AnalysisReport,
                                       Diagnostic, Severity, analyze,
                                       register_rule, rule_table)
from repro_torch.core.compile import (CompiledFabric,  # noqa: F401
                                      compile_spec as compile)  # noqa: A001
from repro_torch.core.passes import (DEFAULT_PASSES, IRPass,  # noqa: F401
                                     PassContext, PassManager, ir_digest)
from repro_torch.core.spec import (InterconnectSpec,  # noqa: F401
                                   SwitchBoxType, sides_for,
                                   spec_from_kwargs, spec_grid)
from repro_torch.core.store import ResultStore  # noqa: F401


def serve(store=None, **kwargs):
    """Start a DSE serving front end (`repro_torch.serve.DSEService`): a
    coalescing ``query(spec | [specs]) -> records`` service over the
    spec-addressed persistent result store, with one shared
    ``SweepExecutor`` batching the misses.

        svc = canal_torch.serve(store=".canal_torch_store",
                                emulate_cycles=16)
        record = svc.query(canal_torch.InterconnectSpec(width=8, height=8))

    Remaining kwargs go to the executor (``device=`` — ``None`` is the
    CUDA card —, ``use_kernels=``, ``apps=``, ...). Lazy import: serving
    pulls in the execution stack, which spec-only users (digests, grids)
    should not pay for."""
    from repro_torch.serve.dse_service import serve as _serve
    return _serve(store=store, **kwargs)


def search(base=None, axes=None, **kwargs):
    """Search-driven DSE (`repro_torch.core.search.search`): a selector
    (``"random"`` / ``"greedy"`` / ``"evolutionary"``) proposes
    candidate specs over ``axes`` around ``base``, a store-memoized
    executor evaluates them in batches, and the Pareto frontier over
    (area, critical-path delay, routability) comes back as a
    ``SearchResult``.

        result = canal_torch.search(base, {"num_tracks": (2, 3, 4, 5, 6)},
                                    selector="greedy", objective="area",
                                    constraints={"min_routability": 1.0},
                                    budget=8, store=".canal_torch_store")
        best = result.best("area", {"min_routability": 1.0})

    Lazy import, like :func:`serve`. Note ``import canal_torch.search``
    names the CLI *module* (the ``python -m canal_torch.search`` entry
    point) and shadows this function on the package — call
    ``canal_torch.search(...)`` without importing the submodule, or use
    ``repro_torch.core.search.search`` directly."""
    from repro_torch.core.search import search as _search
    return _search(base, axes, **kwargs)


def SearchSpace(base, axes):
    """Build a `repro_torch.core.search.SearchSpace` (lazy import — see
    :func:`search`)."""
    from repro_torch.core.search import SearchSpace as _SearchSpace
    return _SearchSpace(base, axes)


__all__ = [
    "AnalysisError", "AnalysisPass", "AnalysisReport", "CompiledFabric",
    "Diagnostic", "Severity", "analyze", "register_rule", "rule_table",
    "compile", "DEFAULT_PASSES", "IRPass", "PassContext",
    "PassManager", "ir_digest", "InterconnectSpec", "SwitchBoxType",
    "sides_for", "spec_from_kwargs", "spec_grid", "ResultStore", "serve",
    "search", "SearchSpace",
]
