"""``device_idle``: share of the traced sample in which no kernel, copy
or memset ran on the card (``torch.profiler``), in %."""
from canalbench.metrics_common import idle_share


def read(run):
    return idle_share(run)
