"""``emu_fused_cluster``: the mean ``cluster`` attribute of the window's
``emu.fused`` spans: each is one call of a fused kernel's wrapper, and
its ``cluster`` the variant that call launched on the card (blocks a
lane; 0 for the global-memory variant, and for the plain version that
runs instead on the CPU). It reads nothing where the window holds no
such span (a program without it)."""
import statistics


def read(run):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    if not run.units:
        return None
    found = obs.spans("emu.fused", run.units[0]["t0"], run.units[-1]["t1"])
    values = [s.attrs["cluster"] for s in found if "cluster" in s.attrs]
    return statistics.fmean(values) if values else None
