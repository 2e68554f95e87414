"""Config for deepseek-coder-33b (see registry.py for the full table)."""
from .registry import CONFIGS

CONFIG = CONFIGS["deepseek-coder-33b"]
