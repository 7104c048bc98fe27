import os
import sys

# smoke tests and benches see 1 device (the dry-run sets 512 itself,
# in a subprocess)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# Pinned hypothesis profile for reproducible CI runs: derandomized (fixed
# seed), no per-example deadline (Pallas interpret + scan tracing dwarf the
# default 200ms budget). The _hypothesis_compat shim is deterministic by
# construction, so this only applies when the real engine is installed.
try:
    from hypothesis import HealthCheck, settings

    settings.register_profile(
        "ci", deadline=None, derandomize=True, max_examples=25,
        suppress_health_check=[HealthCheck.too_slow,
                               HealthCheck.data_too_large])
    settings.load_profile("ci")
except ModuleNotFoundError:
    pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (the port's CUDA "
        "kernels); skips on hosts without CUDA")
