"""Serving front ends of the port. The DSE service is here; the LM
serving engine (the reference's ``serve.engine.ServeEngine``) comes with
the LM slice."""
from .dse_service import DSEService, serve  # noqa: F401
