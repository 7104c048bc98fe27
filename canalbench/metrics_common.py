"""Arithmetic shared by the metric readers of the traced sample."""
from canalbench import roofline


def roofline_share(run, span):
    """Least seconds of the spans' work over their device seconds, %."""
    if run.sample is None:
        return None
    units = [u for u in run.sample["units"] if u["name"] == span]
    least = sum(roofline.least_seconds(u["work"]["bytes"], u["work"]["ops"])
                for u in units)
    device = sum(u.get("device_s", 0.0) for u in units)
    return 100.0 * least / device if least > 0 and device > 0 else None


def idle_share(run):
    """Share of the sample with nothing running on the device, %."""
    s = run.sample
    if s is None or s["window_s"] <= 0 or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
