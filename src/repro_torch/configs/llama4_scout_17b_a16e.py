"""Config for llama4-scout-17b-a16e (see registry.py for the full table)."""
from .registry import CONFIGS

CONFIG = CONFIGS["llama4-scout-17b-a16e"]
