"""The model families: the Llama causal LM with its greedy decode, BERT
and ERNIE 3.0, and the pipeline forms of the Llama and ERNIE;
``load_jax_weights`` fills any of them from the reference's arrays."""
from ._weights import gather_jax_layout, load_jax_weights  # noqa: F401
from .bert import (  # noqa: F401
    BertConfig, BertForMaskedLM, BertForSequenceClassification, BertModel,
)
from .ernie import (  # noqa: F401
    ErnieConfig, ErnieForPretraining, ErnieForPretrainingPipe,
    ErnieForSequenceClassification, ErnieModel,
)
from .generation import generate  # noqa: F401
from .llama import (  # noqa: F401
    LlamaConfig, LlamaForCausalLM, LlamaForCausalLMPipe, LlamaModel,
    from_pipe_layout, to_pipe_layout,
)

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "BertConfig",
           "BertModel", "BertForMaskedLM", "BertForSequenceClassification",
           "ErnieConfig", "ErnieModel", "ErnieForPretraining",
           "ErnieForSequenceClassification", "LlamaForCausalLMPipe",
           "ErnieForPretrainingPipe", "to_pipe_layout", "from_pipe_layout",
           "load_jax_weights", "gather_jax_layout", "generate"]
