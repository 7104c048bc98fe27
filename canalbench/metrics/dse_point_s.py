"""``dse_point_s``: the window's seconds over the cold design points
completed in it (host clock; the window closes at a point boundary)."""


def read(run):
    points = sum(u.get("points", 0) for u in run.units)
    return run.window_s / points if points else None
