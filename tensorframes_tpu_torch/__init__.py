"""tensorframes_tpu_torch: the PyTorch/CUDA port of ``tensorframes_tpu``.

The JAX package beside this one is the reference; every module here
mirrors a module path there so a reader finds each counterpart. This
package imports ``torch`` and never ``jax`` or ``tensorframes_tpu``.

Slice 1 of the port serves generation from the repo's transformer LM on
an NVIDIA H100: paged-KV continuous batching
(:class:`~tensorframes_tpu_torch.serve.GenerationEngine`) behind
``POST /generate`` (:class:`~tensorframes_tpu_torch.interop.ScoringServer`),
with the decode-time paged-attention read as a hand-written CUDA kernel
(:func:`~tensorframes_tpu_torch.ops.ragged_paged_attention`).

Exports are lazy: importing the package does no device work and loads no
submodule until a name is asked for.
"""

import importlib

__version__ = "0.1.0"

_EXPORTS = {
    "GenerationEngine": "serve.engine",
    "EngineUnhealthyError": "serve.engine",
    "PagePool": "serve.kv_pages",
    "QueueFullError": "serve.scheduler",
    "ScoringServer": "interop.serving",
    "TransformerLM": "models.transformer",
    "init_transformer": "models.transformer",
    "params_from_numpy": "models.transformer",
    "paged_attention": "ops.attention",
    "ragged_paged_attention": "ops.attention",
    "get_config": "utils.config",
    "set_config": "utils.config",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value
