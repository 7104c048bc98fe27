"""``rv_rate``: simulated ready-valid fabric cycles completed over the
window's seconds (host clock)."""


def read(run):
    done = sum(u.get("cycles", 0) for u in run.units if u["kind"] == "rv")
    return done / run.window_s if done else None
