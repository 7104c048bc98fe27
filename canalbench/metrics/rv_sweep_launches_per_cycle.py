"""``rv_sweep_launches_per_cycle``: launches that ran the ready-valid
cycles' sweeps over the window's cycles, a count: ``RVFabric``'s
``kernel_cycles`` (one ``rv_sweeps`` launch a cycle) plus its
``graph_replays`` (one a sweep, forward and backward, where the kernel's
size rule sends the fabric to CUDA graphs). 1.0 on the kernel path,
2 x depth (254 at Amber FULL) on the graph path; nothing off the card,
where the sweeps run eagerly and neither counter moves."""


def read(run):
    units = [u for u in run.units if u["kind"] == "rv"]
    cycles = sum(u["cycles"] for u in units)
    launches = sum(u["kernel_cycles"] + u["graph_replays"] for u in units)
    return launches / cycles if cycles and launches else None
