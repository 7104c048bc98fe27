"""``emu_rate``: emulated app-cycles (lanes x cycles) completed over the
window's seconds (host clock)."""


def read(run):
    done = sum(u.get("app_cycles", 0) for u in run.units)
    return done / run.window_s if done else None
