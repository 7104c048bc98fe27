"""``emu_batch_ms``: median device milliseconds of one window batch, by
CUDA events recorded around ``run_apps_batch``."""
import statistics


def read(run):
    ms = [u["device_ms"] for u in run.units
          if u.get("device_ms") is not None]
    return statistics.median(ms) if ms else None
