"""Observability for the port: the metrics registry and span tracing."""

from .metrics import (
    counter,
    enabled,
    gauge,
    histogram,
    registry,
    render_prometheus,
)
from .tracing import set_trace_sink, span

__all__ = [
    "counter",
    "enabled",
    "gauge",
    "histogram",
    "registry",
    "render_prometheus",
    "set_trace_sink",
    "span",
]
