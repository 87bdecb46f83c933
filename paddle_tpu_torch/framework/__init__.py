"""Device and dtype resolution, and ``save``/``load`` in the
reference's checkpoint format (``io``)."""
from .device import (  # noqa: F401
    current_device, get_device, resolve_device, set_device, using_device,
)
from .dtype import to_torch_dtype  # noqa: F401
from . import io  # noqa: F401
