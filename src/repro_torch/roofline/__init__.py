"""Roofline of the port (counterpart of repro/roofline): the chips'
constants (``hw``), the three-term roofline (``analysis``), the
per-device cost counter that stands for the reference's HLO cost model
(``cost``) and the collective link-traffic model (``hlo_parse``, a copy
of the reference's)."""
from .hw import H100_SXM, TPU_V5E  # noqa: F401
from .analysis import roofline_terms, model_flops  # noqa: F401
