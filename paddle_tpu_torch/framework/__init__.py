"""Device and dtype resolution, and ``save``/``load`` in the
reference's checkpoint format (``io``)."""
from .device import resolve_device  # noqa: F401
from .dtype import to_torch_dtype  # noqa: F401
from . import io  # noqa: F401
