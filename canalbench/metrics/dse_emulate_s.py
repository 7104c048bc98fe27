"""``dse_emulate_s``: host seconds of a design point's batched emulation
(``dse.emulate``, on the emulation queue's thread: binding, staging, the
run on the card and the copy back) a point in the window."""
from canalbench.metrics_spans import per_unit, points


def read(run):
    return per_unit(run, ["dse.emulate"], points(run))
