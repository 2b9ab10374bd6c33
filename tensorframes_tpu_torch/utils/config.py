"""Process-wide knobs the serving slice consumes, plus device resolution.

A subset of ``tensorframes_tpu/utils/config.py``: only the fields the
ported modules read. ``serve_attention_impl`` defaults to ``"fused"``
here (the CUDA kernel is the main path on the card), where the JAX
package defaults to ``"gather"`` because Pallas interpret mode is slow
on a CPU.
"""

from __future__ import annotations

import dataclasses
import threading

__all__ = ["Config", "get_config", "set_config", "resolve_device"]


@dataclasses.dataclass(frozen=True)
class Config:
    #: retries for transient device-runtime failures (utils/failures.py)
    max_retries: int = 2
    #: base of the full-jitter exponential retry backoff, seconds
    retry_backoff_s: float = 0.5
    #: master switch for obs/: False makes every counter increment,
    #: histogram observation and span a no-op (``TFT_OBS=0`` in the
    #: environment forces the same, read once at import)
    observability: bool = True
    #: how long ``GenerationEngine.generate`` and ``POST /generate`` wait
    #: on a handle before declaring the stream lost (a backstop: the
    #: supervisor fails a doomed stream within a step)
    serve_result_timeout_s: float = 300.0
    #: decode-step paged-attention read: ``"fused"`` (the ragged
    #: paged-attention kernel, ``ops.ragged_paged_attention``) or
    #: ``"gather"`` (``ops.paged_attention``, the materialized gather)
    serve_attention_impl: str = "fused"


_lock = threading.Lock()
_config = Config()
_on_change: list = []


def register_on_change(cb) -> None:
    """Run ``cb()`` now and after every future :func:`set_config`."""
    _on_change.append(cb)
    cb()


def get_config() -> Config:
    return _config


def set_config(**kwargs) -> Config:
    global _config
    with _lock:
        _config = dataclasses.replace(_config, **kwargs)
    for cb in _on_change:
        cb()
    return _config


def resolve_device(device="cuda"):
    """The ``torch.device`` an entry point runs on. Defaults to the card;
    a CUDA device with no CUDA available raises instead of silently
    running on the CPU (tests pass ``device="cpu"`` explicitly)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain CPU path"
        )
    return dev
