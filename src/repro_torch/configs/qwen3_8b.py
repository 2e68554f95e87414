"""Config for qwen3-8b (see registry.py for the full table)."""
from .registry import CONFIGS

CONFIG = CONFIGS["qwen3-8b"]
