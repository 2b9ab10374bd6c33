"""HTTP front end for the generation engine.

The ``ScoringServer(engine=...)`` subset of
``tensorframes_tpu/interop/serving.py``:

- ``POST /generate`` — JSON ``{"prompt": [ids], "max_new_tokens": n,
  "temperature"?, "top_p"?, "seed"?, "deadline_s"?}``, answered with
  ``{"request_id", "tokens", "timing"}`` when the stream completes.
  400 on a bad or infeasible request, 503 + ``Retry-After`` on a full
  admission queue or an unhealthy engine (shed, don't block), 504 on a
  missed deadline (or the ``serve_result_timeout_s`` backstop);
- ``GET /healthz`` — the engine's liveness JSON, 200 healthy / 503 not;
- ``GET /metrics`` — the registry in Prometheus exposition format
  (the ``tft_serve_*`` series);
- anything else 404; a known path with the wrong verb 405 + ``Allow``.

Arrow scoring and streaming ``/generate`` wait for later slices.
"""

from __future__ import annotations

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from ..obs.metrics import registry, render_prometheus
from ..serve.engine import EngineUnhealthyError
from ..serve.scheduler import QueueFullError
from ..utils.config import get_config

__all__ = ["ScoringServer"]

_ROUTES: Dict[str, Tuple[str, ...]] = {
    "/metrics": ("GET",),
    "/healthz": ("GET",),
    "/generate": ("POST",),
}


def _adaptive_retry_after(engine) -> str:
    """503 ``Retry-After``: queue depth x observed p50 inter-token latency,
    clamped to [1, 30] seconds; ``"1"`` while no latency sample exists."""
    try:
        depth = int(engine.health().get("queue_depth", 0) or 0)
        p50 = registry().get("serve.inter_token_seconds").quantile(0.5)
        if p50 is None:
            return "1"
        return str(int(min(30, max(1, math.ceil(depth * p50)))))
    except Exception:
        return "1"


class ScoringServer:
    """Serve a :class:`~..serve.GenerationEngine` over HTTP on ``host``.

    >>> with ScoringServer(engine=eng) as addr:
    ...     ...  # POST http://{addr}/generate

    ``start()`` starts the engine's stepping thread when it is not
    running yet (and ``stop()`` stops it again)."""

    def __init__(self, *, engine, host: str = "127.0.0.1", port: int = 0):
        if engine is None:
            raise ValueError("ScoringServer needs a generation engine (engine=)")
        self._engine = engine
        self._host = host
        self._requested_port = port
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._engine_started_here = False

    def start(self) -> Tuple[str, int]:
        if self._server is not None:
            raise RuntimeError("server already started")
        server = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # quiet: metrics carry the signal
                pass

            def do_GET(self):
                server._dispatch(self, "GET")

            def do_POST(self):
                server._dispatch(self, "POST")

        self._server = ThreadingHTTPServer(
            (self._host, self._requested_port), _Handler
        )
        self._server.daemon_threads = True
        if self._engine._thread is None:
            self._engine.start()
            self._engine_started_here = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        return self._host, self._server.server_address[1]

    @property
    def address(self) -> str:
        if self._server is None:
            raise RuntimeError("server not started")
        return f"{self._host}:{self._server.server_address[1]}"

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._engine_started_here:
            self._engine.stop()
            self._engine_started_here = False

    def __enter__(self) -> str:
        self.start()
        return self.address

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- routing -----------------------------------------------------------

    def _dispatch(self, h: BaseHTTPRequestHandler, verb: str) -> None:
        path = h.path.split("?", 1)[0].rstrip("/") or "/"
        body = b""
        n = int(h.headers.get("Content-Length") or 0)
        if n > 0:
            body = h.rfile.read(n)
        ctype = "application/json; charset=utf-8"
        extra: Dict[str, str] = {}
        allowed = _ROUTES.get(path)
        if allowed is None:
            status, out = 404, b"endpoints: GET /metrics, GET /healthz, POST /generate\n"
            ctype = "text/plain; charset=utf-8"
        elif verb not in allowed:
            status, out = 405, f"method {verb} not allowed on {path}\n".encode()
            ctype = "text/plain; charset=utf-8"
            extra["Allow"] = ", ".join(allowed)
        elif path == "/metrics":
            status, out = 200, render_prometheus().encode("utf-8")
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path == "/healthz":
            report = self._engine.health()
            report["status"] = "ok" if report["healthy"] else "unhealthy"
            status, out = (200 if report["healthy"] else 503), json.dumps(
                report
            ).encode("utf-8")
            if status == 503:
                extra["Retry-After"] = _adaptive_retry_after(self._engine)
        else:
            status, payload, extra = self._handle_generate(body)
            out = json.dumps(payload).encode("utf-8")
        h.send_response(status)
        h.send_header("Content-Type", ctype)
        h.send_header("Content-Length", str(len(out)))
        h.send_header("Connection", "close")
        for k, v in extra.items():
            h.send_header(k, v)
        h.end_headers()
        h.wfile.write(out)
        h.close_connection = True

    def _handle_generate(
        self, body: bytes
    ) -> Tuple[int, Dict[str, Any], Dict[str, str]]:
        t0 = time.perf_counter()
        try:
            spec = json.loads(body.decode("utf-8") or "{}")
            prompt = [int(t) for t in spec["prompt"]]
            max_new = int(spec["max_new_tokens"])
            deadline = spec.get("deadline_s")
            kwargs: Dict[str, Any] = dict(
                temperature=float(spec.get("temperature", 0.0)),
                top_p=float(spec.get("top_p", 1.0)),
                seed=int(spec.get("seed", 0)),
                deadline=None if deadline is None else float(deadline),
                block=False,
            )
        except (ValueError, KeyError, TypeError, AttributeError) as e:
            return 400, {"error": f"bad request: {type(e).__name__}: {e}"}, {}
        try:
            handle = self._engine.submit(prompt, max_new, **kwargs)
        except (QueueFullError, EngineUnhealthyError) as e:
            return (
                503,
                {"error": str(e), "kind": type(e).__name__},
                {"Retry-After": _adaptive_retry_after(self._engine)},
            )
        except ValueError as e:
            return 400, {"error": str(e), "kind": "ValueError"}, {}
        try:
            toks = handle.result(timeout=get_config().serve_result_timeout_s)
        except TimeoutError as e:
            # a scheduler-evicted deadline and the result-timeout backstop
            # mean the same thing upstream
            return (
                504,
                {"request_id": handle.request_id, "error": str(e),
                 "kind": type(e).__name__},
                {},
            )
        except Exception as e:  # engine-side failure closed the handle
            return (
                500,
                {"request_id": handle.request_id,
                 "error": f"{type(e).__name__}: {e}", "kind": type(e).__name__},
                {},
            )
        timing = {"total_s": round(time.perf_counter() - t0, 6)}
        for k in ("queue_wait_s", "prefill_s", "decode_s", "ttft_s"):
            if k in handle.timings:
                timing[k] = round(float(handle.timings[k]), 6)
        return (
            200,
            {"request_id": handle.request_id,
             "tokens": [int(t) for t in toks], "timing": timing},
            {},
        )
