"""``paddle.vision``'s ported part (counterpart of
``paddle_tpu/vision``): the models of BASELINE configs 1 and 2."""
from . import models  # noqa: F401
from .models import *  # noqa: F401,F403
from .models import __all__ as _models

__all__ = ["models", *_models]
