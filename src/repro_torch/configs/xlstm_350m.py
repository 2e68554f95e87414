"""Config for xlstm-350m (see registry.py for the full table)."""
from .registry import CONFIGS

CONFIG = CONFIGS["xlstm-350m"]
