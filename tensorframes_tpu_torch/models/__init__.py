"""Models of the port: the transformer LM's serving surface."""

from .transformer import (
    TransformerLM,
    filter_logits,
    init_transformer,
    params_from_numpy,
    transformer_logits,
    transformer_prefill,
    transformer_step,
)

__all__ = [
    "TransformerLM",
    "filter_logits",
    "init_transformer",
    "params_from_numpy",
    "transformer_logits",
    "transformer_prefill",
    "transformer_step",
]
