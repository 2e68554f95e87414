"""Config for musicgen-medium (see registry.py for the full table)."""
from .registry import CONFIGS

CONFIG = CONFIGS["musicgen-medium"]
