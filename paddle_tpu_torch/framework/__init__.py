"""Device and dtype resolution for the port."""
from .device import resolve_device  # noqa: F401
from .dtype import to_torch_dtype  # noqa: F401
