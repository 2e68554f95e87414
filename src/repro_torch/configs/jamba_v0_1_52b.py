"""Config for jamba-v0.1-52b (see registry.py for the full table)."""
from .registry import CONFIGS

CONFIG = CONFIGS["jamba-v0.1-52b"]
