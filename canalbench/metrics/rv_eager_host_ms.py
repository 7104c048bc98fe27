"""``rv_eager_host_ms``: host milliseconds a ready-valid cycle spends in
its eager tail: the drive and pinned values (``rv.start``) and the FIFO
update with the observation (``rv.clock``), over the window's cycles."""
from canalbench.metrics_spans import cycles, per_unit


def read(run):
    return per_unit(run, ["rv.start", "rv.clock"], cycles(run), scale=1e3)
