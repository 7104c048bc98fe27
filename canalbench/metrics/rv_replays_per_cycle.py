"""``rv_replays_per_cycle``: sweeps ``RVFabric`` replayed from CUDA
graphs (``graph_replays``, forward and backward) over the window's
cycles: a count."""


def read(run):
    units = [u for u in run.units if u["kind"] == "rv"]
    cycles = sum(u["cycles"] for u in units)
    replays = sum(u["replays"] for u in units)
    return replays / cycles if cycles and replays else None
