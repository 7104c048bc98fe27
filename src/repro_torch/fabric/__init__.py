from .simulator import AppEmulator, run_apps_batch  # noqa: F401
