"""Span tracing, as far as the serving engine uses it.

The port of ``tensorframes_tpu/obs/tracing.py``'s one primitive:
``with span(name, **attrs):`` records a named, nested wall-clock span.
Each span opens a ``torch.profiler.record_function`` range, so it shows
as a named slice in a ``torch.profiler`` trace (the reference forwards to
``jax.profiler.TraceAnnotation``), and completed spans go to the JSONL
sink set with :func:`set_trace_sink`, with the reference's event keys
(``name``, ``depth``, ``ts``, ``dur_s``, ``thread``, ``attrs``).
Observability off makes ``span`` a no-op. Distributed trace identity
(trace/span ids, ``traceparent``) waits for a later slice.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, Optional

from .metrics import enabled

__all__ = ["span", "set_trace_sink"]

_tls = threading.local()
_sink_lock = threading.Lock()
_sink = None


def set_trace_sink(path: Optional[str]) -> None:
    """Append completed spans to ``path`` as JSON lines; ``None`` stops."""
    global _sink
    with _sink_lock:
        if _sink is not None:
            _sink.close()
        _sink = open(path, "a", buffering=1) if path else None


class _Span:
    __slots__ = ("name", "attrs", "_t0", "_ts", "_depth", "_rf")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        import torch

        self.name = name
        self.attrs = attrs
        self._rf = torch.profiler.record_function(name)

    def __enter__(self) -> "_Span":
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self._depth = len(stack)
        stack.append(self)
        self._rf.__enter__()
        self._ts = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dur = time.perf_counter() - self._t0
        self._rf.__exit__(*exc)
        _tls.stack.pop()
        if _sink is not None:
            event = {
                "name": self.name,
                "depth": self._depth,
                "ts": self._ts,
                "dur_s": dur,
                "thread": threading.current_thread().name,
                "attrs": self.attrs,
            }
            with _sink_lock:
                if _sink is not None:
                    _sink.write(json.dumps(event, default=str) + "\n")
        return False


class _NullSpan:
    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _NullSpan()


def span(name: str, **attrs):
    """Open a nested span; binds the span, or ``None`` when observability
    is off."""
    if not enabled():
        return _NULL
    return _Span(name, dict(attrs))
