"""``ir_lower_s``: host seconds of the program's ``ir.lower`` span
(``compile_interconnect``: IR -> lowered fabric) a design point in the
window."""
from canalbench.metrics_spans import per_unit, points


def read(run):
    return per_unit(run, ["ir.lower"], points(run))
