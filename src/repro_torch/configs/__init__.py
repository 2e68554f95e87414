from .registry import (CONFIGS, FASE_ROCKET, FASE_ROCKET_PCIE,  # noqa: F401
                       get)
