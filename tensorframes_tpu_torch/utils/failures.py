"""Failure handling: retry transient device errors, degrade on OOM.

The port of ``tensorframes_tpu/utils/failures.py``, cut to what the
serving slice uses. The taxonomy is the same:

- **transient runtime errors** (dropped connection, UNAVAILABLE-style
  statuses): the step's inputs are still on the host, so the dispatch is
  retried with full-jitter exponential backoff;
- **device OOM** (``torch.cuda.OutOfMemoryError``, or any error whose
  text says out of memory): retrying identically cannot help, the caller
  must shrink the work (the engine defragments and preempts);
- everything else is fatal for the work in flight.
"""

from __future__ import annotations

import random
import re
import time
from typing import Callable, Iterator, Optional, TypeVar

from ..obs.metrics import counter as _counter
from .logging import get_logger

__all__ = [
    "DeadlineExceededError",
    "DeviceOOMError",
    "PagePoolExhausted",
    "first_line",
    "is_oom",
    "is_transient",
    "record_preemption",
    "run_with_retries",
]

logger = get_logger("failures")

_retries_total = _counter(
    "failures.retries_total",
    "Transient device-runtime failures retried, by op and reason",
    labels=("op", "reason"),
)
_retries_exhausted_total = _counter(
    "failures.retries_exhausted_total",
    "Transient failures that ran out of retry attempts",
    labels=("op",),
)
_preemptions_total = _counter(
    "failures.preemptions_total",
    "Work units preempted and requeued on resource exhaustion, by op",
    labels=("op",),
)

T = TypeVar("T")

#: lowercase status substrings that mark a dispatch worth retrying
_TRANSIENT_MARKERS = (
    "unavailable",
    "deadline_exceeded",
    "aborted",
    "connection reset",
    "connection refused",
    "socket closed",
)

_OOM_MARKERS = (
    "resource_exhausted",
    "out of memory",
)

#: "OOM" must match as a WORD ("zoom", "room" are not device OOMs)
_OOM_WORD = re.compile(r"\boom\b")


class DeviceOOMError(RuntimeError):
    """Device memory exhausted and the op cannot shrink its work unit."""


class PagePoolExhausted(DeviceOOMError):
    """The serving engine's KV page pool has no free page for a growing
    sequence: the scheduler preempts a running sequence and requeues it
    for recompute instead of crashing the batch."""


class DeadlineExceededError(TimeoutError):
    """A generation request outlived its caller-supplied deadline and was
    evicted by the scheduler. Terminal, never retried; HTTP maps it to
    504."""


def first_line(err: object, limit: int = 200) -> str:
    """First line of ``str(err)``, bounded (``str(e)`` may be empty)."""
    return str(err).split("\n", 1)[0][:limit]


def record_preemption(op: str) -> None:
    """Count one preempt-and-requeue (the scheduler evicting a sequence
    when its KV page pool runs dry)."""
    _preemptions_total.inc(op=op)


def _exc_chain(e: BaseException) -> Iterator[BaseException]:
    """``e`` and its explicit causes (``raise X from Y``), cycle-safe."""
    seen = set()
    cur: Optional[BaseException] = e
    while cur is not None and id(cur) not in seen and len(seen) < 8:
        seen.add(id(cur))
        yield cur
        cur = cur.__cause__


def _exc_text(e: BaseException) -> str:
    return "\n".join(str(x) for x in _exc_chain(e)).lower()


def _is_torch_oom(x: BaseException) -> bool:
    import torch

    return isinstance(x, torch.cuda.OutOfMemoryError)


def is_oom(e: BaseException) -> bool:
    if any(
        isinstance(x, DeviceOOMError) or _is_torch_oom(x)
        for x in _exc_chain(e)
    ):
        return True
    s = _exc_text(e)
    return any(m in s for m in _OOM_MARKERS) or _OOM_WORD.search(s) is not None


def is_transient(e: BaseException) -> bool:
    if any(isinstance(x, DeadlineExceededError) for x in _exc_chain(e)) or (
        is_oom(e)
    ):
        return False
    s = _exc_text(e)
    return any(m in s for m in _TRANSIENT_MARKERS)


def _failure_reason(e: BaseException) -> str:
    if is_oom(e):
        return "OOM"
    s = _exc_text(e)
    for m in _TRANSIENT_MARKERS:
        if m in s:
            return m.upper().replace(" ", "_")
    return type(e).__name__


def _op_label(what: str) -> str:
    """Bounded op label: ``"serve.prefill request 3"`` -> ``serve.prefill``."""
    return what.split(" ", 1)[0] if what else "unknown"


#: RNG behind the backoff's full jitter; a dedicated instance so no
#: other random consumer is perturbed
_jitter_rng = random.Random()


def _backoff_delay(attempt: int, base: float) -> float:
    """Full-jitter exponential backoff: uniform over ``(0.05 * cap, cap]``
    with ``cap = base * 2**attempt`` (never an immediate hot spin)."""
    cap = base * (2.0 ** attempt)
    return _jitter_rng.uniform(0.05 * cap, cap)


def run_with_retries(fn: Callable[[], T], what: str = "device dispatch") -> T:
    """Run ``fn``, retrying transient failures with full-jitter backoff
    (``Config.max_retries`` / ``retry_backoff_s``). Non-transient errors
    propagate at once; the last transient error raises when the attempts
    run out."""
    from .config import get_config

    cfg = get_config()
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — classified below
            transient = is_transient(e)
            if not transient or attempt >= cfg.max_retries:
                if transient:
                    _retries_exhausted_total.inc(op=_op_label(what))
                raise
            delay = _backoff_delay(attempt, cfg.retry_backoff_s)
            attempt += 1
            _retries_total.inc(op=_op_label(what), reason=_failure_reason(e))
            logger.warning(
                "%s failed with a transient error (%s); retry %d/%d in %.1fs",
                what, first_line(e), attempt, cfg.max_retries, delay,
            )
            time.sleep(delay)
