"""Serving front ends of the port: the LM serving engine
(``ServeEngine``, prefill + greedy decode) and the DSE service."""
from .engine import Request, ServeEngine  # noqa: F401
from .dse_service import DSEService, serve  # noqa: F401
