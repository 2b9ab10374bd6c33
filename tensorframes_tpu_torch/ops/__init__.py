"""Kernels of the port and their plain versions."""

from .attention import (
    paged_attention,
    ragged_paged_attention,
    ragged_paged_attention_reference,
)

__all__ = [
    "paged_attention",
    "ragged_paged_attention",
    "ragged_paged_attention_reference",
]
