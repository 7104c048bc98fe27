"""``roofline.emu``: the least time the card could take for the traced
batches' work (``canalbench/roofline.py``, counted from the problem's
shapes) over the device time of every kernel inside their spans, in %."""
from canalbench.metrics_common import roofline_share


def read(run):
    return roofline_share(run, "trace.emulate")
