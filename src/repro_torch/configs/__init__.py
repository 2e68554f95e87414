from .registry import FASE_ROCKET, FASE_ROCKET_PCIE  # noqa: F401
