"""Host-side utilities: the config system and annotation drawing."""

from .config import (
    DEFAULT_CONFIG, load_config, load_api_config, deep_update,
)
from .drawing import draw_bbox, draw_bbox_info

__all__ = ["DEFAULT_CONFIG", "load_config", "load_api_config", "deep_update",
           "draw_bbox", "draw_bbox_info"]
