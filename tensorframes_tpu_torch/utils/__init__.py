"""Host-side utilities of the port: config, logging, failure taxonomy."""

from .config import Config, get_config, resolve_device, set_config
from .logging import get_logger

__all__ = ["Config", "get_config", "get_logger", "resolve_device", "set_config"]
