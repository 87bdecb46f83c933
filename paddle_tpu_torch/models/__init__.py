"""The Llama family: the model, its weights loader and greedy decode."""
from .generation import generate  # noqa: F401
from .llama import (  # noqa: F401
    LlamaConfig, LlamaForCausalLM, LlamaModel, load_jax_weights,
)

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "load_jax_weights", "generate"]
