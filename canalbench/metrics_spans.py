"""Readers of the program's own span record (``repro_torch.obs``).

The window runs from the first unit's ``t0`` to the last unit's ``t1``
(the clock of the record and of ``Run`` is ``time.perf_counter``). A
reader sums the seconds of the named spans that lie inside the window
and divides by the window's units: design points, cycles, batches or
apps, as ``run.units`` counts them. It reads nothing, and returns None,
where the program keeps no span record (an older tree), where the
window holds none of the spans, or where the record may have lost some
of the window's spans: the buffer has dropped spans, oldest first, and
the oldest it still holds ended inside the window.
"""
from typing import Iterable, Optional


def per_unit(run, names: Iterable[str], units: float,
             scale: float = 1.0) -> Optional[float]:
    """Seconds (times ``scale``) of the spans ``names`` in the window
    over ``units``."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    if not run.units or not units:
        return None
    since, until = run.units[0]["t0"], run.units[-1]["t1"]
    if obs.dropped():
        kept = obs.spans()
        if not kept or kept[0].t1 >= since:
            return None
    found = [s for n in names for s in obs.spans(n, since, until)]
    if not found:
        return None
    return scale * sum(s.seconds for s in found) / units


def points(run) -> int:
    return sum(u.get("points", 0) for u in run.units)


def apps(run) -> int:
    """Apps placed and routed in the window (the records' entries)."""
    return sum(len(u.get("pnr_seconds", ())) for u in run.units)


def cycles(run) -> int:
    return sum(u.get("cycles", 0) for u in run.units)


def batches(run) -> int:
    return sum(1 for u in run.units if u.get("kind") == "emulate")
