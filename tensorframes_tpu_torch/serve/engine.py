"""GenerationEngine: prefill and decode steps over the paged KV cache.

The port of ``tensorframes_tpu/serve/engine.py`` for the serving slice.
Two steps serve every request:

- **prefill**: one prompt through the batched causal pass
  (:func:`~..models.transformer.transformer_prefill`), its per-layer k/v
  written into the sequence's pages, the first token sampled from the
  last prompt position's logits;
- **decode**: one token per occupied slot through the shared per-token
  walk (:func:`~..models.transformer.transformer_step`) with attention
  delegated to the paged read — :func:`~..ops.ragged_paged_attention`
  (the CUDA kernel on the card, ``attention_impl="fused"``, the default)
  or :func:`~..ops.paged_attention` (the gather).

Where the JAX engine compiles static-shape programs and threads the pool
through them functionally (donated on TPU), this engine runs eagerly and
updates the KV pool IN PLACE (``index_put_`` through tensor indexing):
no second pool copy is ever live. The prefill runs the prompt's real
length, not a padded row; idle decode slots still point at the trash page.

Sampling follows the reference rule exactly: greedy argmax, or the
per-step key ``fold_in(PRNGKey(seed), position)`` with temperature,
top-k/top-p filtering and a Gumbel categorical draw, in JAX's own
threefry bits (:mod:`..models._random`) — so seeded streams match the
JAX engine token for token.

Supervision is the reference's: transient step failures retry with
backoff (a retried step rewrites the same k/v values, so the in-place
update is idempotent), device OOM recovers by ``defragment()`` +
preempt-youngest, anything else fails every in-flight handle and marks
the engine unhealthy until :meth:`GenerationEngine.restart`. Chunked
prefill, the prefix cache, speculative decoding, tensor parallelism and
tenancy wait for later slices.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models._random import categorical, fold_in, prng_key
from ..models.transformer import (
    TransformerLM,
    filter_logits,
    params_from_numpy,
    transformer_prefill,
    transformer_step,
)
from ..obs.metrics import counter as _counter
from ..obs.metrics import gauge as _gauge
from ..obs.metrics import histogram as _histogram
from ..obs.tracing import span as _span
from ..ops.attention import paged_attention, ragged_paged_attention
from ..utils.config import get_config, resolve_device
from ..utils.failures import (
    DeadlineExceededError,
    is_oom,
    is_transient,
    run_with_retries,
)
from ..utils.logging import get_logger
from .kv_pages import PagePool, pages_needed
from .scheduler import (
    GenerationHandle,
    GenRequest,
    QueueFullError,
    Scheduler,
    _Active,
)

__all__ = ["EngineUnhealthyError", "GenerationEngine"]

logger = get_logger("serve.engine")

_m_queue_depth = _gauge(
    "serve.queue_depth", "Generation requests waiting for a decode slot"
)
_m_active_slots = _gauge(
    "serve.active_slots",
    "Decode-batch occupancy (sequences currently holding a slot)",
)
_m_pages_in_use = _gauge(
    "serve.pages_in_use", "KV pages currently owned by live sequences"
)
_m_pages_capacity = _gauge("serve.pages_capacity", "Total KV pages in the pool")
_m_ttft = _histogram(
    "serve.ttft_seconds",
    "Time to first token: submit to first emission (seconds)",
)
_m_itl = _histogram(
    "serve.inter_token_seconds",
    "Inter-token latency per stream: gap between emissions (seconds)",
)
_m_tokens = _counter(
    "serve.tokens_total", "Tokens emitted across all generation streams"
)
_m_requests = _counter(
    "serve.requests_total",
    "Generation requests by terminal status",
    labels=("status",),
)
_m_restarts = _counter(
    "serve.engine_restarts_total",
    "GenerationEngine.restart() recoveries (device state rebuilt from "
    "host-side scheduler progress)",
)
_m_deadline_expired = _counter(
    "serve.deadline_expired_total",
    "Requests evicted because their deadline passed (queued or "
    "mid-generation)",
)
_m_handles_failed = _counter(
    "serve.handles_failed_total",
    "Generation handles closed with an error, by classified reason",
    labels=("reason",),
)


class EngineUnhealthyError(RuntimeError):
    """The engine is shedding load after a terminal stepping failure (or
    a wedged stop); submissions fail fast until
    :meth:`GenerationEngine.restart`. HTTP maps this to 503."""


def _fail_reason(e: BaseException) -> str:
    """Bounded reason label for ``serve.handles_failed_total``."""
    if isinstance(e, DeadlineExceededError):
        return "deadline"
    if is_oom(e):
        return "oom"
    if is_transient(e):
        return "transient_exhausted"
    return "fatal"


class GenerationEngine:
    """Continuous-batching generation over a :class:`PagePool`.

    >>> eng = GenerationEngine(lm, max_slots=8, device="cuda")
    >>> h = eng.submit(prompt_ids, max_new_tokens=64)
    >>> eng.start()              # background stepping (or drive .step())
    >>> for tok in h: ...        # stream
    >>> eng.stop()

    ``model`` is a :class:`~..models.transformer.TransformerLM` or a JAX
    params dict (carried across with ``params_from_numpy``). ``device``
    defaults to the card and raises when CUDA is missing.
    ``max_seq_len`` bounds prompt + generation per request (default: the
    model's positional table). ``page_size`` defaults to 16.
    ``num_pages`` defaults to full-length pages for every slot; size it
    smaller to lean on preempt-and-requeue. ``top_k`` is engine-level;
    temperature / ``top_p`` / seed are per request.

    ``logits_hook(request_id, position, logits_row)``, when set, sees
    every emitted token's logits (a ``[vocab]`` tensor on the device) —
    for checks against a reference forward; it costs nothing when unset."""

    def __init__(
        self,
        model,
        *,
        max_slots: int = 8,
        page_size: int = 16,
        num_pages: Optional[int] = None,
        max_seq_len: Optional[int] = None,
        queue_capacity: int = 64,
        top_k: int = 0,
        eos_id: Optional[int] = None,
        attention_impl: Optional[str] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if isinstance(model, TransformerLM):
            self.model = model.to(self.device)
        else:
            self.model = params_from_numpy(model, self.device)
        model_max = self.model.max_len
        self.max_seq_len = int(max_seq_len or model_max)
        if self.max_seq_len > model_max:
            raise ValueError(
                f"max_seq_len {self.max_seq_len} exceeds the model's "
                f"positional table ({model_max})"
            )
        self.max_slots = int(max_slots)
        self.page_size = max(1, int(page_size))
        self._max_pages = pages_needed(self.max_seq_len, self.page_size)
        if num_pages is None:
            num_pages = self.max_slots * self._max_pages
        self.pool = PagePool(
            n_layers=len(self.model.blocks),
            n_kv_heads=self.model.n_kv_heads,
            head_dim=self.model.head_dim,
            num_pages=num_pages,
            page_size=self.page_size,
            dtype=self.model.embed.dtype,
            device=self.device,
        )
        if attention_impl is None:
            attention_impl = get_config().serve_attention_impl
        if attention_impl not in ("gather", "fused"):
            raise ValueError(
                f"attention_impl must be 'gather' or 'fused'; got "
                f"{attention_impl!r}"
            )
        self.attention_impl = attention_impl
        self.scheduler = Scheduler(
            self.pool, self.max_slots, queue_capacity, self.max_seq_len
        )
        self.top_k = int(top_k)
        self.eos_id = eos_id
        self.logits_hook: Optional[Callable] = None
        #: decode steps dispatched and their summed wall seconds (host
        #: clock around a step that ends in a device sync)
        self.decode_steps = 0
        self.decode_seconds = 0.0
        self._req_counter = 0
        self._submit_lock = threading.Lock()
        self._step_lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.healthy = True
        self._stop_wedged = False
        self._consecutive_ooms = 0
        self._last_step_t = time.monotonic()
        _m_pages_capacity.set(float(num_pages))

    # -- device steps ------------------------------------------------------

    def _sample(self, logits, positions, temps, seeds, top_ps, any_sampled):
        """THE token rule: greedy argmax, or the seeded categorical after
        temperature + top-k/top-p filtering with the key folded at the
        row's absolute position. ``any_sampled`` (known on the host)
        skips the sampling math for an all-greedy batch: those rows take
        the argmax either way."""
        logits = logits.to(torch.float32)
        greedy = torch.argmax(logits, dim=-1)
        if not any_sampled:
            return greedy
        keys = fold_in(prng_key(seeds), positions)
        scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
        filt = filter_logits(scaled, top_k=self.top_k, top_p=top_ps[:, None])
        return torch.where(temps > 0, categorical(keys, filt), greedy)

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    @torch.no_grad()
    def _prefill_step(self, req: GenRequest, ptab: np.ndarray) -> int:
        plen = len(req.prompt)
        prompt = self._tensor(req.prompt[None], torch.long)
        logits, kc, vc = transformer_prefill(self.model, prompt)
        ps = self.page_size
        pos = np.arange(plen)
        page = self._tensor(ptab[pos // ps], torch.long)
        off = self._tensor(pos % ps, torch.long)
        # [L, 1, n_kv, P, hd] -> [L, P, n_kv, hd], written in place
        self.pool.k[:, page, off] = kc[:, 0].transpose(1, 2)
        self.pool.v[:, page, off] = vc[:, 0].transpose(1, 2)
        last = logits[0, plen - 1 : plen]
        tok = self._sample(
            last,
            self._tensor([plen - 1], torch.int32),
            self._tensor([req.temperature], torch.float32),
            self._tensor([req.seed], torch.int32),
            self._tensor([req.top_p], torch.float32),
            req.temperature > 0,
        )
        if self.logits_hook is not None:
            self.logits_hook(req.request_id, plen - 1, last[0])
        return int(tok[0])

    @torch.no_grad()
    def _decode_step(self, toks, positions, ptabs, temps, seeds, top_ps):
        model = self.model
        slots = toks.shape[0]
        d_model = model.d_model
        ps = self.page_size
        pool = self.pool
        read = (
            ragged_paged_attention
            if self.attention_impl == "fused"
            else paged_attention
        )
        positions_t = self._tensor(positions, torch.int32)
        ptabs_t = self._tensor(ptabs, torch.int32)
        lengths_t = self._tensor(positions + 1, torch.int32)
        rows = np.arange(slots)
        page = self._tensor(ptabs[rows, positions // ps], torch.long)
        off = self._tensor(positions % ps, torch.long)

        def attend(li, q, k, v):
            # write this token's k/v into its page (in place), then read
            # the whole visible history through the page table
            pool.k[li, page, off] = k
            pool.v[li, page, off] = v
            ctx = read(q.contiguous(), pool.k[li], pool.v[li], ptabs_t, lengths_t)
            return ctx.reshape(slots, d_model)

        logits = transformer_step(
            model, self._tensor(toks, torch.long), positions_t.long(), attend
        )
        nxt = self._sample(
            logits,
            positions_t,
            self._tensor(temps, torch.float32),
            self._tensor(seeds, torch.int32),
            self._tensor(top_ps, torch.float32),
            bool((temps > 0).any()),
        )
        return logits, nxt.cpu().numpy()

    # -- submission --------------------------------------------------------

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        temperature: float = 0.0,
        top_p: float = 1.0,
        seed: int = 0,
        eos_id: Optional[int] = None,
        block: bool = True,
        timeout: Optional[float] = None,
        deadline: Optional[float] = None,
    ) -> GenerationHandle:
        """Queue one generation request; returns its streaming handle.
        Raises ``ValueError`` for requests that could never be scheduled,
        :class:`QueueFullError` when the queue is full and ``block=False``,
        and :class:`EngineUnhealthyError` while the engine sheds.
        ``deadline`` is a budget in seconds from now."""
        prompt = np.asarray(prompt, np.int32).ravel()
        if prompt.size < 1:
            _m_requests.inc(status="rejected")
            raise ValueError("prompt needs at least one token")
        if max_new_tokens < 1:
            _m_requests.inc(status="rejected")
            raise ValueError(f"max_new_tokens must be >= 1; got {max_new_tokens}")
        if deadline is not None and deadline <= 0:
            _m_requests.inc(status="rejected")
            raise ValueError(
                f"deadline must be positive seconds from now; got {deadline}"
            )
        if not self.healthy or self._stop_wedged:
            _m_requests.inc(status="rejected")
            raise EngineUnhealthyError(
                "engine is unhealthy after a terminal stepping failure or a "
                "wedged stop; restart() it before submitting"
            )
        with self._submit_lock:
            self._req_counter += 1
            rid = self._req_counter
        handle = GenerationHandle(rid)
        req = GenRequest(
            request_id=rid,
            prompt=prompt,
            max_new_tokens=int(max_new_tokens),
            temperature=float(temperature),
            top_p=float(top_p),
            seed=int(seed),
            eos_id=self.eos_id if eos_id is None else eos_id,
            handle=handle,
            deadline_t=None if deadline is None else time.monotonic() + deadline,
        )
        try:
            self.scheduler.submit(req, block=block, timeout=timeout)
        except (ValueError, QueueFullError):
            _m_requests.inc(status="rejected")
            raise
        _m_queue_depth.set(float(self.scheduler.queue_depth))
        return handle

    # -- stepping ----------------------------------------------------------

    def step(self) -> bool:
        """One scheduler iteration: sweep expired deadlines, admit +
        prefill newcomers, grow pages (preempting on exhaustion), one
        decode step for the batch. Returns whether work remains."""
        with self._step_lock:
            try:
                return self._step_locked()
            finally:
                self._last_step_t = time.monotonic()

    def _step_locked(self) -> bool:
        expired = self.scheduler.expire(time.monotonic())
        if expired:
            _m_deadline_expired.inc(expired)
            _m_handles_failed.inc(expired, reason="deadline")
            _m_requests.inc(expired, status="failed")
        prefill_err: Optional[BaseException] = None
        for idx, act in self.scheduler.admit():
            err = self._try_prefill(idx, act)
            if err is not None and prefill_err is None:
                prefill_err = err
        if prefill_err is not None:
            self._refresh_gauges()
            raise prefill_err
        batch = self.scheduler.active
        if batch:
            ready: List[Tuple[int, _Active]] = []
            for idx, act in batch:
                if self.scheduler.slots[idx] is not act or not act.generated:
                    continue
                if self.scheduler.grow(idx):
                    ready.append((idx, act))
            # growth for a later slot may have evicted an earlier one
            ready = [(i, a) for i, a in ready if self.scheduler.slots[i] is a]
            if ready:
                try:
                    self._decode_batch(ready)
                    self._consecutive_ooms = 0
                except Exception as e:
                    if is_oom(e) and self._recover_oom():
                        self._refresh_gauges()
                        return True
                    for i, _ in ready:
                        if self.scheduler.slots[i] is not None:
                            self.scheduler.finish(i, error=e)
                            _m_requests.inc(status="failed")
                            _m_handles_failed.inc(reason=_fail_reason(e))
                    raise
        self._refresh_gauges()
        return self.scheduler.has_work()

    def _note_oom(self) -> bool:
        self._consecutive_ooms += 1
        return self._consecutive_ooms <= self.max_slots + 1

    def _recover_oom(self) -> bool:
        """Device OOM mid-decode: nothing was emitted, so compact the pool
        and shed the youngest sequence (recompute-style requeue); the next
        step retries with a smaller batch. Bounded via :meth:`_note_oom`."""
        if not self._note_oom():
            return False
        logger.warning(
            "decode step hit device OOM (%d consecutive); defragmenting "
            "and preempting the youngest sequence",
            self._consecutive_ooms,
        )
        self._defragment_locked()
        victim = self.scheduler._youngest_active(exclude=-1)
        if victim is not None:
            self.scheduler.preempt(victim)
        return True

    def _try_prefill(self, idx: int, act: _Active) -> Optional[BaseException]:
        """One prefill under the step's failure contract: device OOM
        defragments and requeues this request; anything else fails this
        request only and is returned for the caller to re-raise."""
        try:
            self._prefill_one(idx, act)
            return None
        except Exception as e:
            if is_oom(e) and self._note_oom():
                logger.warning(
                    "prefill hit device OOM (%d consecutive); "
                    "defragmenting and requeueing request %d",
                    self._consecutive_ooms, act.req.request_id,
                )
                self._defragment_locked()
                self.scheduler.preempt(idx)
                return None
            self.scheduler.finish(idx, error=e)
            _m_requests.inc(status="failed")
            _m_handles_failed.inc(reason=_fail_reason(e))
            return e

    def _defragment_locked(self) -> Dict[int, int]:
        return self.pool.defragment([a.seq for _, a in self.scheduler.active])

    def _prefill_one(self, idx: int, act: _Active) -> None:
        req = act.req
        timings = req.handle.timings
        timings.setdefault("queue_wait_s", time.monotonic() - req.submitted_at)
        ptab = act.seq.table(self._max_pages)
        t0 = time.perf_counter()
        with _span("serve.prefill", request=req.request_id, prompt_len=len(req.prompt)):
            tok = run_with_retries(
                lambda: self._prefill_step(req, ptab),
                what=f"serve.prefill request {req.request_id}",
            )
        timings["prefill_s"] = (
            timings.get("prefill_s", 0.0) + time.perf_counter() - t0
        )
        self._emit(idx, act, tok)

    def _decode_batch(self, ready: List[Tuple[int, _Active]]) -> None:
        s = self.max_slots
        toks = np.zeros(s, np.int32)
        positions = np.zeros(s, np.int32)
        ptabs = np.full((s, self._max_pages), self.pool.trash_page, np.int32)
        temps = np.zeros(s, np.float32)
        seeds = np.zeros(s, np.int32)
        top_ps = np.ones(s, np.float32)
        for idx, act in ready:
            toks[idx] = act.generated[-1]
            positions[idx] = act.length - 1  # this token's write position
            ptabs[idx] = act.seq.table(self._max_pages)
            temps[idx] = act.req.temperature
            seeds[idx] = act.req.seed
            top_ps[idx] = act.req.top_p
        t0 = time.perf_counter()
        with _span("serve.decode_step", occupancy=len(ready)):
            logits, nxt = run_with_retries(
                lambda: self._decode_step(toks, positions, ptabs, temps, seeds, top_ps),
                what="serve.decode_step",
            )
        self.decode_seconds += time.perf_counter() - t0
        self.decode_steps += 1
        for idx, act in ready:
            if self.logits_hook is not None:
                self.logits_hook(act.req.request_id, int(positions[idx]), logits[idx])
            self._emit(idx, act, int(nxt[idx]))

    def _emit(self, idx: int, act: _Active, tok: int) -> None:
        now = time.monotonic()
        act.generated.append(tok)
        act.req.handle._emit(tok)
        _m_tokens.inc()
        t = act.req.handle.timings
        if act.req.emitted == 0 and len(act.generated) == 1:
            t["ttft_s"] = now - act.req.submitted_at
            _m_ttft.observe(t["ttft_s"])
        elif act.last_emit_t is not None:
            _m_itl.observe(now - act.last_emit_t)
        if act.last_emit_t is not None:
            t["decode_s"] = t.get("decode_s", 0.0) + now - act.last_emit_t
        act.last_emit_t = now
        eos = act.req.eos_id
        if (eos is not None and tok == eos) or act.remaining <= 0:
            t["tokens"] = act.req.emitted + len(act.generated)
            self.scheduler.finish(idx)
            _m_requests.inc(status="completed")

    def _refresh_gauges(self) -> None:
        _m_queue_depth.set(float(self.scheduler.queue_depth))
        _m_active_slots.set(float(sum(s is not None for s in self.scheduler.slots)))
        _m_pages_in_use.set(float(self.pool.pages_in_use))

    def run_until_idle(self) -> None:
        """Drive :meth:`step` until queue and slots are empty."""
        while self.step():
            pass

    def defragment(self) -> Dict[int, int]:
        """Compact live KV pages to the lowest pool indices between steps
        (page tables are rebuilt every step, so in-flight generation never
        notices). Returns the ``old -> new`` remap."""
        with self._step_lock:
            return self._defragment_locked()

    # -- supervision -------------------------------------------------------

    def _fail_inflight(self, error: BaseException) -> None:
        """Fail EVERY in-flight handle with the real error now and mark the
        engine unhealthy until :meth:`restart`."""
        self.healthy = False
        reason = _fail_reason(error)
        with self._step_lock:
            n = self.scheduler.fail_all(error)
        if n:
            _m_requests.inc(n, status="failed")
            _m_handles_failed.inc(n, reason=reason)
        self._refresh_gauges()

    def restart(self) -> "GenerationEngine":
        """Rebuild device state from host-side scheduler progress: every
        active sequence is preempted (its progress folds into its prompt,
        so the emitted stream stays identical), the pool is re-zeroed, and
        the engine is healthy again."""
        if self._stop_wedged:
            raise RuntimeError(
                "cannot restart a wedged engine: the stepping thread never "
                "exited its stop join — stop() again to retry"
            )
        with self._step_lock:
            # youngest-first so the OLDEST request ends at the queue front
            for idx, _ in reversed(self.scheduler.active):
                self.scheduler.preempt(idx)
            self.pool.reset()
            self._consecutive_ooms = 0
            self.healthy = True
            self._last_step_t = time.monotonic()
        _m_restarts.inc()
        with self.scheduler._lock:
            self.scheduler._lock.notify_all()
        logger.warning(
            "engine restarted: device state rebuilt, %d request(s) requeued",
            self.scheduler.queue_depth,
        )
        return self

    def health(self) -> Dict[str, object]:
        """Liveness snapshot for ``GET /healthz``."""
        thread = self._thread
        return {
            "healthy": bool(self.healthy and not self._stop_wedged),
            "last_step_age_s": round(time.monotonic() - self._last_step_t, 3),
            "queue_depth": self.scheduler.queue_depth,
            "active_slots": sum(s is not None for s in self.scheduler.slots),
            "pages_in_use": self.pool.pages_in_use,
            "pages_capacity": self.pool.num_pages,
            "page_size": self.page_size,
            "attention_impl": self.attention_impl,
            "device": str(self.device),
            "stepping_thread_alive": (
                thread.is_alive() if thread is not None else None
            ),
            "stop_wedged": self._stop_wedged,
        }

    # -- background serving ------------------------------------------------

    def start(self) -> "GenerationEngine":
        """Step in a daemon thread until :meth:`stop`."""
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._supervised_loop, daemon=True)
        self._thread.start()
        return self

    def _supervised_loop(self) -> None:
        """The serving loop under supervision: whatever escapes a step is
        terminal for the work in flight — every handle fails promptly and
        the engine flips unhealthy — but the loop keeps running."""
        try:
            while not self._stop.is_set():
                try:
                    worked = self.step()
                except Exception as e:
                    logger.error(
                        "generation step failed terminally (%s: %s); failing "
                        "all in-flight requests — restart() to recover",
                        type(e).__name__, str(e).split("\n", 1)[0][:200],
                    )
                    self._fail_inflight(e)
                    worked = False
                if not worked:
                    with self.scheduler._lock:
                        if not self.scheduler._waiting:
                            self.scheduler._lock.wait(0.02)
        except BaseException as e:  # the supervisor must never die silently
            if not self._stop.is_set():
                logger.error("stepping thread died", exc_info=True)
                self._fail_inflight(e)
            raise

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        with self.scheduler._lock:
            self.scheduler._lock.notify_all()
        self._thread.join(timeout=10)
        if self._thread.is_alive():
            logger.warning(
                "stepping thread did not stop within 10s; engine marked "
                "unhealthy — stop() again to retry"
            )
            self._stop_wedged = True
            self.healthy = False
            return
        self._stop_wedged = False
        self._thread = None
        with self._step_lock:
            n = self.scheduler.fail_all(
                RuntimeError("engine stopped with the request in flight")
            )
        if n:
            _m_requests.inc(n, status="failed")
            _m_handles_failed.inc(n, reason="shutdown")
            self._refresh_gauges()

    def __enter__(self) -> "GenerationEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def generate(
        self, prompts: Sequence[Sequence[int]], max_new_tokens: int, **kw
    ) -> List[np.ndarray]:
        """Submit every prompt, run to completion, return each request's
        generated tokens. Synchronous when no background thread runs."""
        handles = [self.submit(p, max_new_tokens, **kw) for p in prompts]
        if self._thread is None:
            self.run_until_idle()
        timeout = get_config().serve_result_timeout_s
        return [h.result(timeout=timeout) for h in handles]
