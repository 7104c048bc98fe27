"""Roofline constants and terms of the port (counterpart of
repro/roofline). The HLO cost and parse modules lower XLA programs and
are not ported."""
from .hw import H100_SXM, TPU_V5E  # noqa: F401
from .analysis import roofline_terms, model_flops  # noqa: F401
