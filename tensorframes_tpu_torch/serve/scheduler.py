"""Continuous-batching scheduler: admission queue, slots, preemption.

The port of ``tensorframes_tpu/serve/scheduler.py`` (pure host logic, no
torch). The :class:`~.engine.GenerationEngine` drives it:

- :meth:`Scheduler.submit` parks requests in a BOUNDED admission queue
  (a full queue blocks or raises :class:`QueueFullError`);
- :meth:`Scheduler.admit` moves queued requests into free decode slots,
  reserving prompt pages;
- :meth:`Scheduler.grow` reserves the next decode position's page; on
  :class:`PagePoolExhausted` it PREEMPTS the youngest other sequence:
  pages freed, request requeued at the FRONT with its progress folded
  into the prompt, so the re-admitted prefill replays prompt + emitted
  tokens and the consumer's stream continues without replay or loss.

The prefix cache, tenancy priorities and live migration of the
reference wait for later slices.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional, Tuple

import numpy as np

from ..utils.failures import (
    DeadlineExceededError,
    PagePoolExhausted,
    record_preemption,
)
from .kv_pages import PagePool, SequencePages, pages_needed

__all__ = ["GenerationHandle", "GenRequest", "QueueFullError", "Scheduler"]


class QueueFullError(RuntimeError):
    """The bounded admission queue is at capacity (non-blocking submit)."""


class GenerationHandle:
    """The caller's end of one request: a token stream plus completion
    state. Iterating yields generated token ids as the engine emits them;
    :meth:`result` blocks for the full generation."""

    _DONE = object()

    def __init__(self, request_id: int):
        self.request_id = request_id
        self._q: "queue.Queue" = queue.Queue()
        self._tokens: List[int] = []
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        #: per-request timing breakdown filled by the engine:
        #: ``queue_wait_s``, ``prefill_s``, ``decode_s``, ``ttft_s``
        self.timings: dict = {}

    def _emit(self, token: int) -> None:
        self._tokens.append(int(token))
        self._q.put(int(token))

    def _finish(self, error: Optional[BaseException] = None) -> None:
        self._error = error
        self._done.set()
        self._q.put(self._DONE)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                if self._error is not None:
                    raise self._error
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Generated tokens (prompt excluded), blocking until done."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not done within {timeout}s"
            )
        if self._error is not None:
            raise self._error
        return np.asarray(self._tokens, np.int32)


@dataclass
class GenRequest:
    """One admission-queue entry. ``prompt`` already includes any tokens
    generated before a preemption, and ``emitted`` counts them."""

    request_id: int
    prompt: np.ndarray  # [plen] int32
    max_new_tokens: int
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0
    eos_id: Optional[int] = None
    handle: GenerationHandle = None  # type: ignore[assignment]
    submitted_at: float = field(default_factory=time.monotonic)
    emitted: int = 0
    #: absolute ``time.monotonic()`` deadline, or None
    deadline_t: Optional[float] = None


class _Active:
    """A slot's running sequence: request + page holdings + progress."""

    __slots__ = ("req", "seq", "generated", "admit_order", "last_emit_t")

    def __init__(self, req: GenRequest, seq: SequencePages, admit_order: int):
        self.req = req
        self.seq = seq
        self.generated: List[int] = []
        self.admit_order = admit_order
        self.last_emit_t: Optional[float] = None

    @property
    def length(self) -> int:
        """Positions written to the KV pages so far (plus the pending one)."""
        return len(self.req.prompt) + len(self.generated)

    @property
    def remaining(self) -> int:
        return self.req.max_new_tokens - len(self.generated)


class Scheduler:
    """Slot + queue + page bookkeeping for one decode batch. Thread-safe
    for concurrent :meth:`submit`; the step-side methods are called by
    the engine's single stepping thread."""

    def __init__(
        self,
        pool: PagePool,
        max_slots: int,
        queue_capacity: int,
        max_seq_len: int,
    ):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1; got {max_slots}")
        self.pool = pool
        self.max_slots = int(max_slots)
        self.max_seq_len = int(max_seq_len)
        self.queue_capacity = int(queue_capacity)
        self.slots: List[Optional[_Active]] = [None] * self.max_slots
        self._waiting: Deque[GenRequest] = deque()
        self._lock = threading.Condition()
        self._admit_counter = 0

    # -- admission ---------------------------------------------------------

    def submit(
        self,
        req: GenRequest,
        block: bool = True,
        timeout: Optional[float] = None,
    ) -> None:
        """Park ``req`` in the admission queue; a full queue blocks (the
        default) or raises :class:`QueueFullError` with ``block=False``."""
        total = len(req.prompt) + req.max_new_tokens
        if total > self.max_seq_len:
            raise ValueError(
                f"prompt ({len(req.prompt)}) + max_new_tokens "
                f"({req.max_new_tokens}) = {total} exceeds max_seq_len "
                f"{self.max_seq_len}"
            )
        if pages_needed(total, self.pool.page_size) > self.pool.num_pages:
            raise ValueError(
                f"request needs {pages_needed(total, self.pool.page_size)} "
                f"pages at full length but the pool holds only "
                f"{self.pool.num_pages} — it could never be scheduled"
            )
        with self._lock:
            deadline = None if timeout is None else time.monotonic() + timeout
            while len(self._waiting) >= self.queue_capacity:
                if not block:
                    raise QueueFullError(
                        f"admission queue full "
                        f"({self.queue_capacity} requests waiting)"
                    )
                rem = None if deadline is None else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    raise QueueFullError(
                        f"admission queue still full after {timeout}s"
                    )
                self._lock.wait(rem)
            self._waiting.append(req)
            self._lock.notify_all()

    def _requeue_front(self, req: GenRequest) -> None:
        """Preempted requests skip the line; the queue bound is ignored so
        a preemption never deadlocks against a full queue."""
        with self._lock:
            self._waiting.appendleft(req)
            self._lock.notify_all()

    # -- stepping side -----------------------------------------------------

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._waiting)

    @property
    def active(self) -> List[Tuple[int, _Active]]:
        """(slot index, active sequence) pairs, oldest admission first."""
        pairs = [(i, a) for i, a in enumerate(self.slots) if a is not None]
        pairs.sort(key=lambda p: p[1].admit_order)
        return pairs

    def has_work(self) -> bool:
        return any(s is not None for s in self.slots) or self.queue_depth > 0

    def admit(self) -> List[Tuple[int, _Active]]:
        """Fill free slots from the queue head, reserving each admitted
        prompt's pages; stops at the first request whose pages the pool
        cannot supply now (it keeps its queue position)."""
        admitted: List[Tuple[int, _Active]] = []
        for idx in range(self.max_slots):
            if self.slots[idx] is not None:
                continue
            with self._lock:
                if not self._waiting:
                    break
                req = self._waiting.popleft()
                self._lock.notify_all()
            seq = SequencePages(self.pool)
            try:
                seq.ensure(len(req.prompt))
            except PagePoolExhausted:
                seq.release()
                self._requeue_front(req)
                break
            act = _Active(req, seq, self._admit_counter)
            self._admit_counter += 1
            self.slots[idx] = act
            admitted.append((idx, act))
        return admitted

    def grow(self, idx: int) -> bool:
        """Reserve the page holding slot ``idx``'s next decode position,
        preempting the YOUNGEST other active sequence per retry until the
        pool yields one. Returns False when ``idx`` itself was preempted."""
        act = self.slots[idx]
        assert act is not None
        while True:
            try:
                # the pending token writes at position length - 1
                act.seq.ensure(act.length)
                return True
            except PagePoolExhausted:
                victim = self._youngest_active(exclude=idx)
                if victim is None:
                    self.preempt(idx)
                    return False
                self.preempt(victim)

    def _youngest_active(self, exclude: int) -> Optional[int]:
        """Most recently admitted slot other than ``exclude`` — the
        preemption victim (least progress lost; starvation-free because
        the victim requeues at the front)."""
        best, best_order = None, -1
        for i, a in enumerate(self.slots):
            if a is None or i == exclude:
                continue
            if a.admit_order > best_order:
                best, best_order = i, a.admit_order
        return best

    def preempt(self, idx: int) -> GenRequest:
        """Evict slot ``idx``: release its pages and requeue the request
        at the queue front with progress folded into the prompt."""
        act = self.slots[idx]
        assert act is not None
        act.seq.release()
        self.slots[idx] = None
        req = act.req
        new_req = GenRequest(
            request_id=req.request_id,
            prompt=np.concatenate(
                [req.prompt, np.asarray(act.generated, np.int32)]
            ),
            max_new_tokens=req.max_new_tokens - len(act.generated),
            temperature=req.temperature,
            top_p=req.top_p,
            seed=req.seed,
            eos_id=req.eos_id,
            handle=req.handle,
            submitted_at=req.submitted_at,
            emitted=req.emitted + len(act.generated),
            deadline_t=req.deadline_t,
        )
        record_preemption("serve")
        self._requeue_front(new_req)
        return new_req

    def finish(self, idx: int, error: Optional[BaseException] = None) -> None:
        """Terminal slot release: pages back to the pool, handle closed."""
        act = self.slots[idx]
        assert act is not None
        act.seq.release()
        self.slots[idx] = None
        act.req.handle._finish(error)

    # -- supervision -------------------------------------------------------

    def expire(self, now: float) -> int:
        """Evict every request whose deadline has passed, queued or
        active; their handles raise :class:`DeadlineExceededError`.
        Returns the number evicted."""
        expired: List[GenRequest] = []
        with self._lock:
            if self._waiting:
                keep: Deque[GenRequest] = deque()
                for r in self._waiting:
                    if r.deadline_t is not None and now >= r.deadline_t:
                        expired.append(r)
                    else:
                        keep.append(r)
                if expired:
                    self._waiting = keep
                    self._lock.notify_all()
        for r in expired:
            r.handle._finish(
                DeadlineExceededError(
                    f"request {r.request_id} exceeded its deadline while "
                    f"queued for admission"
                )
            )
        n = len(expired)
        for i, a in enumerate(self.slots):
            if (
                a is not None
                and a.req.deadline_t is not None
                and now >= a.req.deadline_t
            ):
                self.finish(
                    i,
                    error=DeadlineExceededError(
                        f"request {a.req.request_id} exceeded its deadline "
                        f"mid-generation ({len(a.generated)} of "
                        f"{a.req.max_new_tokens} tokens emitted)"
                    ),
                )
                n += 1
        return n

    def fail_all(self, error: BaseException) -> int:
        """Fail EVERY in-flight request (active and queued) with ``error``,
        releasing their pages. Returns how many handles were closed."""
        n = 0
        for i, a in enumerate(self.slots):
            if a is not None:
                self.finish(i, error=error)
                n += 1
        with self._lock:
            drained = list(self._waiting)
            self._waiting.clear()
            if drained:
                self._lock.notify_all()
        for r in drained:
            r.handle._finish(error)
        return n + len(drained)
