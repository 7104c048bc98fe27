"""``pnr_route_s``: host seconds of routing (``pnr.route``, every alpha)
a placed and routed app in the window."""
from canalbench.metrics_spans import apps, per_unit


def read(run):
    return per_unit(run, ["pnr.route"], apps(run))
