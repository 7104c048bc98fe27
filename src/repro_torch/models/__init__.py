from .registry import build_model, ARCH_FAMILIES  # noqa: F401
