"""``rv_sweep_host_ms``: host milliseconds a ready-valid cycle spends in
its sweeps (``rv.sweeps``: enqueueing the graph replays, waiting for
room while the card is behind, or the eager sweeps off the card), over
the window's cycles."""
from canalbench.metrics_spans import cycles, per_unit


def read(run):
    return per_unit(run, ["rv.sweeps"], cycles(run), scale=1e3)
