"""``pnr_place_s``: host seconds of placement a placed and routed app in
the window: packing (``pnr.pack``), global placement with the IO
assignment and legalization (``pnr.global_place``) and detailed
placement over the alpha sweep (``pnr.detailed_place``)."""
from canalbench.metrics_spans import apps, per_unit


def read(run):
    return per_unit(run, ["pnr.pack", "pnr.global_place",
                          "pnr.detailed_place"], apps(run))
