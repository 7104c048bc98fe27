"""Canal's public front door, on the PyTorch/CUDA port (counterpart of
:mod:`canal`).

    import canal_torch

    spec = canal_torch.InterconnectSpec(width=8, height=8, num_tracks=5,
                                        sb_type="wilton", io_ring=True)
    fab = canal_torch.compile(spec)          # on the CUDA card
    fab = canal_torch.compile(spec, device="cpu")
    result = fab.place_and_route(app)
    outs = fab.emulate(result, {"in0": stream}, cycles=32)
    words = fab.bitstream(result)

``compile(spec, device=None, use_kernels=False, analyze="warn")`` runs
the pass pipeline and returns a :class:`CompiledFabric`; ``device=None``
is the CUDA card and raises on a host without one. ``use_kernels`` runs
the fabric's fused engine through the hand-written CUDA kernels.
``serve``, ``search`` and ``ResultStore`` are not ported yet.
"""
from repro_torch.core.analysis import analyze  # noqa: F401
from repro_torch.core.compile import (CompiledFabric,  # noqa: F401
                                      compile_spec as compile)  # noqa: A001
from repro_torch.core.passes import (DEFAULT_PASSES, IRPass,  # noqa: F401
                                     PassManager)
from repro_torch.core.spec import (InterconnectSpec,  # noqa: F401
                                   SwitchBoxType, spec_grid)

__all__ = [
    "CompiledFabric", "DEFAULT_PASSES", "IRPass", "InterconnectSpec",
    "PassManager", "SwitchBoxType", "analyze", "compile", "spec_grid",
]
