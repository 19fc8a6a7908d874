"""Host-side utilities: the config system."""

from .config import (
    DEFAULT_CONFIG, load_config, load_api_config, deep_update,
)

__all__ = ["DEFAULT_CONFIG", "load_config", "load_api_config", "deep_update"]
