from .simulator import AppEmulator, run_apps_batch  # noqa: F401
from .ready_valid import RVFabric, compile_ready_valid, east_route  # noqa: F401
