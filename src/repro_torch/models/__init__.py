"""Layer B of the port: the model substrate (dense decode for serving)."""
from .config import ModelConfig  # noqa: F401
