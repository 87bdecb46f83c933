"""The model families: the Llama causal LM with its greedy decode, BERT
and ERNIE 3.0; ``load_jax_weights`` fills any of them from the
reference's arrays."""
from ._weights import gather_jax_layout, load_jax_weights  # noqa: F401
from .bert import (  # noqa: F401
    BertConfig, BertForMaskedLM, BertForSequenceClassification, BertModel,
)
from .ernie import (  # noqa: F401
    ErnieConfig, ErnieForPretraining, ErnieForSequenceClassification,
    ErnieModel,
)
from .generation import generate  # noqa: F401
from .llama import (  # noqa: F401
    LlamaConfig, LlamaForCausalLM, LlamaModel,
)

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "BertConfig",
           "BertModel", "BertForMaskedLM", "BertForSequenceClassification",
           "ErnieConfig", "ErnieModel", "ErnieForPretraining",
           "ErnieForSequenceClassification", "load_jax_weights",
           "gather_jax_layout", "generate"]
