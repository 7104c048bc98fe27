"""``pnr_app_s``: mean host seconds of one app's place and route, as the
window's records state it (``apps[*].seconds``, ``PnRResult.seconds``)."""


def read(run):
    s = [x for u in run.units for x in u.get("pnr_seconds", ())]
    return sum(s) / len(s) if s else None
