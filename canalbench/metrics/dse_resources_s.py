"""``dse_resources_s``: host seconds of building a design point's
``RoutingResources`` (``pnr.resources``: adjacency, delays, base costs)
a point in the window."""
from canalbench.metrics_spans import per_unit, points


def read(run):
    return per_unit(run, ["pnr.resources"], points(run))
