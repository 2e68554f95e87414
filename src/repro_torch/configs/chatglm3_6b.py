"""Config for chatglm3-6b (see registry.py for the full table)."""
from .registry import CONFIGS

CONFIG = CONFIGS["chatglm3-6b"]
