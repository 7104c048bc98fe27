"""``compile_s.dse``: mean seconds of the benchmark's span around
``SweepExecutor.interconnect`` and ``.fabric`` (spec -> passes -> IR ->
lowering) of each design point in the window."""


def read(run):
    s = [x["t1"] - x["t0"] for x in run.spans if x["name"] == "dse.compile"]
    return sum(s) / len(s) if s else None
