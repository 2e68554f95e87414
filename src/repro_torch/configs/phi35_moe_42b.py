"""Config for phi3.5-moe-42b-a6.6b (see registry.py for the full table)."""
from .registry import CONFIGS

CONFIG = CONFIGS["phi3.5-moe-42b-a6.6b"]
