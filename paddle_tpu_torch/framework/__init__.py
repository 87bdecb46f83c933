"""Device and dtype resolution, ``save``/``load`` in the reference's
checkpoint format (``io``), the RNG state (``random``), the flags
(``flags``), the structured errors (``errors``) and the top level's long
tail (``compat``: places, the static-mode flag, ``finfo``, ...)."""
from .device import (  # noqa: F401
    current_device, get_device, resolve_device, set_device, using_device,
)
from .dtype import to_torch_dtype  # noqa: F401
from . import io  # noqa: F401
