from .device import resolve_device
from .misc import bool_flag

__all__ = ["bool_flag", "resolve_device"]
