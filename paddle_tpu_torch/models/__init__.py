"""The model families: the Llama causal LM with its greedy decode, and
BERT; ``load_jax_weights`` fills either from the reference's arrays."""
from ._weights import load_jax_weights  # noqa: F401
from .bert import (  # noqa: F401
    BertConfig, BertForMaskedLM, BertForSequenceClassification, BertModel,
)
from .generation import generate  # noqa: F401
from .llama import (  # noqa: F401
    LlamaConfig, LlamaForCausalLM, LlamaModel,
)

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "BertConfig",
           "BertModel", "BertForMaskedLM", "BertForSequenceClassification",
           "load_jax_weights", "generate"]
