"""The port's serving slice held against the JAX package's engine.

- ``PagePool`` / ``Scheduler`` units (allocation, refcounts, defragment,
  bounded admission, preempt-youngest with progress folded into the
  prompt, deadlines);
- the port's ``GenerationEngine`` (CPU, the fused read's plain path)
  emits the JAX ``GenerationEngine``'s greedy AND seeded streams token for
  token on the same weights — and keeps them under a starved pool
  (preempt + requeue), ``restart()``, device-OOM recovery and a
  transient-failure retry;
- ``POST /generate``, ``GET /healthz`` and ``GET /metrics`` end to end.
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tensorframes_tpu.serve import GenerationEngine as JaxEngine
from tensorframes_tpu_torch.interop import ScoringServer
from tensorframes_tpu_torch.models import init_transformer
from tensorframes_tpu_torch.serve import (
    EngineUnhealthyError,
    GenerationEngine,
    PagePool,
    QueueFullError,
    Scheduler,
    SequencePages,
)
from tensorframes_tpu_torch.serve.scheduler import GenerationHandle, GenRequest
from tensorframes_tpu_torch.utils import failures
from tensorframes_tpu_torch.utils.config import get_config, set_config

pytestmark = pytest.mark.torch

VOCAB = 48
MAX_LEN = 40
PS = 8
NEW = 10
SAMPLED = dict(temperature=0.9, top_p=0.9, seed=11)


@pytest.fixture(scope="module")
def params():
    return init_transformer(
        3, VOCAB, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
        max_len=MAX_LEN,
    )


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, VOCAB, size=n).tolist() for n in (3, 9, 17, 5, 8)]


@pytest.fixture(scope="module")
def jax_streams(params, prompts):
    eng = JaxEngine(params, max_slots=4, page_size=PS, attention_impl="gather")
    greedy = eng.generate(prompts, NEW)
    sampled = eng.generate(prompts, NEW, **SAMPLED)
    return [g.tolist() for g in greedy], [s.tolist() for s in sampled]


def _engine(params, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("page_size", PS)
    return GenerationEngine(params, device="cpu", **kw)


def _lists(outs):
    return [o.tolist() for o in outs]


# -- PagePool -------------------------------------------------------------


def test_page_pool_lifo_refcounts_and_exhaustion():
    pool = PagePool(2, 1, 4, num_pages=4, page_size=2, device="cpu")
    assert tuple(pool.k.shape) == (2, 5, 2, 1, 4) and pool.trash_page == 4
    a = pool.alloc(2)
    assert a == [0, 1] and pool.pages_in_use == 2
    pool.free([a[1]])
    assert pool.alloc(1) == [1]  # LIFO: the page just freed comes back
    pool.ref([0])
    assert pool.pages_shared == 1
    assert pool.free([0]) == 0 and pool.free([0]) == 1
    with pytest.raises(ValueError, match="double free"):
        pool.free([0])
    with pytest.raises(failures.PagePoolExhausted):
        pool.alloc(4)
    assert failures.is_oom(failures.PagePoolExhausted("x"))


def test_page_pool_defragment_moves_contents_and_tables():
    pool = PagePool(1, 1, 2, num_pages=6, page_size=2, device="cpu")
    s1, s2 = SequencePages(pool), SequencePages(pool)
    s1.ensure(4)
    s2.ensure(4)  # pages 0,1 and 2,3
    s1.release()
    for p in s2.pages:
        pool.k[0, p] = float(p + 1)
    remap = pool.defragment([s2])
    assert remap == {2: 0, 3: 1} and s2.pages == [0, 1]
    assert pool.k[0, 0].eq(3.0).all() and pool.k[0, 1].eq(4.0).all()
    assert pool.pages_in_use == 2
    np.testing.assert_array_equal(s2.table(4), [0, 1, 6, 6])
    pool.reset()
    assert pool.pages_in_use == 0 and pool.k.abs().sum().item() == 0.0


# -- Scheduler ------------------------------------------------------------


def _req(rid, n=4, new=4, **kw):
    return GenRequest(rid, np.arange(n, dtype=np.int32), new,
                      handle=GenerationHandle(rid), **kw)


def test_scheduler_bounded_queue_and_infeasible_requests():
    pool = PagePool(1, 1, 2, num_pages=4, page_size=2, device="cpu")
    sch = Scheduler(pool, max_slots=1, queue_capacity=2, max_seq_len=8)
    sch.submit(_req(1))
    sch.submit(_req(2))
    with pytest.raises(QueueFullError):
        sch.submit(_req(3), block=False)
    with pytest.raises(ValueError, match="max_seq_len"):
        sch.submit(_req(4, n=6, new=4))
    assert [a.req.request_id for _, a in sch.admit()] == [1]
    assert sch.queue_depth == 1


def test_scheduler_preempts_youngest_and_folds_progress():
    pool = PagePool(1, 1, 2, num_pages=4, page_size=2, device="cpu")
    sch = Scheduler(pool, max_slots=2, queue_capacity=4, max_seq_len=8)
    sch.submit(_req(1, n=4))
    sch.submit(_req(2, n=4))
    (i1, a1), (i2, a2) = sch.admit()
    a1.generated.append(9)
    a2.generated.append(7)
    assert sch.grow(i1)  # needs a 3rd page for slot 1: slot 2 is evicted
    assert sch.slots[i2] is None and sch.queue_depth == 1
    requeued = sch._waiting[0]
    assert requeued.prompt.tolist() == [0, 1, 2, 3, 7]
    assert requeued.emitted == 1 and requeued.max_new_tokens == 3


def test_scheduler_expires_deadlines():
    pool = PagePool(1, 1, 2, num_pages=4, page_size=2, device="cpu")
    sch = Scheduler(pool, max_slots=1, queue_capacity=4, max_seq_len=8)
    r1, r2 = _req(1, deadline_t=0.0), _req(2, deadline_t=0.0)
    sch.submit(r1)
    sch.admit()
    sch.submit(r2)
    assert sch.expire(time.monotonic()) == 2
    for r in (r1, r2):
        with pytest.raises(failures.DeadlineExceededError):
            r.handle.result(timeout=0)
    assert pool.pages_in_use == 0


# -- engine parity ------------------------------------------------------------


def test_greedy_and_seeded_streams_match_the_jax_engine(params, prompts, jax_streams):
    eng = _engine(params)
    assert eng.attention_impl == "fused"
    assert _lists(eng.generate(prompts, NEW)) == jax_streams[0]
    assert _lists(eng.generate(prompts, NEW, **SAMPLED)) == jax_streams[1]
    assert eng.pool.pages_in_use == 0


def test_gather_read_gives_the_same_streams(params, prompts, jax_streams):
    eng = _engine(params, attention_impl="gather")
    assert _lists(eng.generate(prompts, NEW, **SAMPLED)) == jax_streams[1]


def test_starved_pool_preempts_and_keeps_streams(params, prompts, jax_streams):
    before = failures._preemptions_total.value(op="serve")
    eng = _engine(params, num_pages=5)
    assert _lists(eng.generate(prompts, NEW)) == jax_streams[0]
    assert _lists(eng.generate(prompts, NEW, **SAMPLED)) == jax_streams[1]
    assert failures._preemptions_total.value(op="serve") > before
    assert eng.pool.pages_in_use == 0


def test_restart_midstream_keeps_streams(params, prompts, jax_streams):
    eng = _engine(params)
    handles = [eng.submit(p, NEW, **SAMPLED) for p in prompts]
    for _ in range(4):
        eng.step()
    eng.restart()
    eng.run_until_idle()
    assert [h.result(timeout=0).tolist() for h in handles] == jax_streams[1]


def test_oom_and_transient_failures_recover_without_changing_streams(
    params, prompts, jax_streams, monkeypatch
):
    eng = _engine(params)
    real = eng._decode_step
    faults = [torch.cuda.OutOfMemoryError("CUDA out of memory"),
              RuntimeError("UNAVAILABLE: link dropped")]

    def flaky(*args):
        if faults and eng.decode_steps == 2:
            raise faults.pop(0)
        return real(*args)

    monkeypatch.setattr(eng, "_decode_step", flaky)
    old = get_config().retry_backoff_s
    set_config(retry_backoff_s=0.001)
    try:
        assert _lists(eng.generate(prompts, NEW)) == jax_streams[0]
    finally:
        set_config(retry_backoff_s=old)
    assert not faults and eng.healthy


def test_fatal_step_failure_fails_handles_and_sheds(params, prompts):
    eng = _engine(params)

    def boom(*args):
        raise ValueError("fatal")

    eng._decode_step = boom
    eng.start()
    try:
        h = eng.submit(prompts[0], NEW)
        with pytest.raises(ValueError, match="fatal"):
            h.result(timeout=30)
        deadline = time.monotonic() + 10
        while eng.healthy and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(EngineUnhealthyError):
            eng.submit(prompts[0], NEW)
    finally:
        eng.stop()


# -- HTTP -------------------------------------------------------------------


def _post(base, payload):
    req = urllib.request.Request(
        base + "/generate", data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def test_generate_healthz_metrics_end_to_end(params, prompts, jax_streams):
    eng = _engine(params)
    with ScoringServer(engine=eng) as addr:
        base = f"http://{addr}"
        st, out, _ = _post(base, {"prompt": prompts[1], "max_new_tokens": NEW})
        assert st == 200 and out["tokens"] == jax_streams[0][1]
        assert out["timing"]["total_s"] > 0
        st, out, _ = _post(base, {"prompt": prompts[2], "max_new_tokens": NEW,
                                  **SAMPLED})
        assert st == 200 and out["tokens"] == jax_streams[1][2]
        assert _post(base, {"prompt": [1, 2]})[0] == 400
        assert _post(base, {"prompt": [1] * 35, "max_new_tokens": 10})[0] == 400
        st, out, _ = _post(base, {"prompt": [1, 2], "max_new_tokens": 4,
                                  "deadline_s": 1e-9})
        assert st == 504 and out["kind"] == "DeadlineExceededError"
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert r.status == 200 and json.loads(r.read())["healthy"]
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            scrape = r.read().decode()
        for series in ("tft_serve_tokens_total", "tft_serve_ttft_seconds_count",
                       'tft_serve_requests_total{status="completed"}',
                       "tft_serve_pages_capacity"):
            assert series in scrape
        with pytest.raises(urllib.error.HTTPError) as e404:
            urllib.request.urlopen(base + "/nope", timeout=30)
        assert e404.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e405:
            urllib.request.urlopen(base + "/generate", timeout=30)
        assert e405.value.code == 405 and e405.value.headers["Allow"] == "POST"
        eng.healthy = False
        st, out, hdrs = _post(base, {"prompt": [1, 2], "max_new_tokens": 4})
        assert st == 503 and out["kind"] == "EngineUnhealthyError"
        assert "Retry-After" in hdrs
        with pytest.raises(urllib.error.HTTPError) as e503:
            urllib.request.urlopen(base + "/healthz", timeout=30)
        assert e503.value.code == 503
    assert eng._thread is None  # the server stopped the engine it started
