"""Config for internvl2-76b (see registry.py for the full table)."""
from .registry import CONFIGS

CONFIG = CONFIGS["internvl2-76b"]
