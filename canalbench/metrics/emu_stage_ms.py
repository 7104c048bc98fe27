"""``emu_stage_ms``: host milliseconds a window batch spends staging its
inputs (``emu.stage``: the stimulus, configurations and PE programs
stacked) and unpacking its outputs (``emu.unpack``)."""
from canalbench.metrics_spans import batches, per_unit


def read(run):
    return per_unit(run, ["emu.stage", "emu.unpack"], batches(run),
                    scale=1e3)
