"""The mixture-of-experts layer (``MoELayer``) and its gates."""
from .moe_layer import MoELayer  # noqa: F401

__all__ = ["MoELayer"]
