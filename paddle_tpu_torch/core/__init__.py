from .device import resolve_device
from .flags import flag, get_flags, set_flags

__all__ = ["resolve_device", "flag", "get_flags", "set_flags"]
