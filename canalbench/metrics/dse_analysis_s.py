"""``dse_analysis_s``: host seconds of a design point's static analysis
in the window: the pre-screen (``dse.analysis``) and each routed app's
analysis and static metrics (``dse.routed_analysis``)."""
from canalbench.metrics_spans import per_unit, points


def read(run):
    return per_unit(run, ["dse.analysis", "dse.routed_analysis"],
                    points(run))
