"""Generation serving: continuous batching over a paged KV cache.

- :mod:`.kv_pages` — the page pool and page tables
- :mod:`.scheduler` — bounded admission, slots, preempt-and-requeue
- :mod:`.engine` — the prefill/decode steps and the streaming API
"""

from .engine import EngineUnhealthyError, GenerationEngine
from .kv_pages import PagePool, SequencePages, pages_needed
from .scheduler import GenerationHandle, GenRequest, QueueFullError, Scheduler

__all__ = [
    "EngineUnhealthyError",
    "GenerationEngine",
    "GenerationHandle",
    "GenRequest",
    "PagePool",
    "QueueFullError",
    "Scheduler",
    "SequencePages",
    "pages_needed",
]
