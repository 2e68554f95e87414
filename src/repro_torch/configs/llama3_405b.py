"""Config for llama3-405b (see registry.py for the full table)."""
from .registry import CONFIGS

CONFIG = CONFIGS["llama3-405b"]
