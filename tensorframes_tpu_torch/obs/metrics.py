"""Thread-safe metrics registry: counters, gauges, log-bucket histograms.

A copy of ``tensorframes_tpu/obs/metrics.py`` (that module imports no
jax, but importing it would run the JAX package's ``__init__``). Same
names, same Prometheus rendering, so dashboards read both packages'
``tft_serve_*`` series alike. Design constraints, in order:

1. **hot-path cheap** — instrumentation sits inside the engine's dispatch
   loops and the serving accept path, so a disabled registry must cost one
   predicate and an enabled increment one lock + dict update. Metrics are
   created once at module import and held in module globals by their
   instrumenting module (no name lookup per increment).
2. **thread-safe** — the scoring server increments from its connection
   pool, the engine from decode/prefetch threads; every series mutation
   happens under its metric's lock.
3. **one export shape** — ``render_prometheus()`` returns exposition
   text (scraped off the serving port, see ``interop/serving.py``).

Metric names are dotted (``engine.rows_processed_total``); Prometheus
rendering prefixes ``tft_`` and maps dots to underscores
(``tft_engine_rows_processed_total``).

Kill switch: ``TFT_OBS=0`` in the environment (read once at import) or
``Config(observability=False)`` disables all collection — increments,
histogram observations, and span emission become no-ops.
"""

from __future__ import annotations

import bisect
import math
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..utils.config import get_config, register_on_change

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_BUCKETS",
    "enabled",
    "registry",
    "counter",
    "gauge",
    "histogram",
    "render_prometheus",
]

#: environment kill switch, read once — flipping the env var mid-process is
#: not a supported path (use ``set_config(observability=...)`` for that)
_ENV_OFF = os.environ.get("TFT_OBS", "1").strip().lower() in (
    "0", "false", "off", "no",
)

#: the hot-path gate: a plain module global (one dict lookup to read),
#: kept in sync with Config.observability by a set_config callback —
#: deriving it per increment costs two extra function calls on every
#: counter touch in the engine dispatch loop
_ON = False


def _refresh_enabled() -> None:
    global _ON
    _ON = (not _ENV_OFF) and get_config().observability


register_on_change(_refresh_enabled)


def enabled() -> bool:
    """Whether collection is on (``TFT_OBS`` env AND the Config field)."""
    return _ON


#: default histogram bounds: log-scale, factor 4, 1 µs .. ~67 s — wide
#: enough for both sub-ms device dispatches and multi-second cold compiles,
#: fixed so series from different processes always merge bucket-for-bucket
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(1e-6 * 4.0 ** i for i in range(14))


def _check_labels(
    declared: Tuple[str, ...], got: Dict[str, Any], name: str
) -> Tuple[str, ...]:
    """Label dict -> series key, enforcing the declared label set (a typo'd
    label name must fail loudly, not create a parallel series)."""
    if len(got) != len(declared):
        raise ValueError(
            f"metric {name!r} declares labels {declared}; got "
            f"{tuple(sorted(got))}"
        )
    try:
        return tuple(str(got[k]) for k in declared)
    except KeyError as e:
        raise ValueError(
            f"metric {name!r} declares labels {declared}; got "
            f"{tuple(sorted(got))}"
        ) from e


class _Metric:
    """Shared shell: name, help text, declared label names, series lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labels: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names: Tuple[str, ...] = tuple(labels)
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, Any]) -> Tuple[str, ...]:
        if not labels and not self.label_names:
            return ()
        return _check_labels(self.label_names, labels, self.name)


class Counter(_Metric):
    """Monotonic counter; ``inc(amount, **labels)``."""

    kind = "counter"

    def __init__(self, name, help="", labels=()):
        super().__init__(name, help, labels)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not _ON:
            return
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0.0)

    def _series(self):
        with self._lock:
            return dict(self._values)


class Gauge(_Metric):
    """Point-in-time value; ``set``."""

    kind = "gauge"

    def __init__(self, name, help="", labels=()):
        super().__init__(name, help, labels)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, **labels) -> None:
        if not _ON:
            return
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def _series(self):
        with self._lock:
            return dict(self._values)


class Histogram(_Metric):
    """Fixed log-scale-bucket histogram; ``observe(value, **labels)``.

    Bucket bounds are upper-inclusive (Prometheus ``le`` semantics): an
    observation exactly on a bound lands in that bound's bucket. Values
    above the last bound land in the implicit ``+Inf`` bucket.
    """

    kind = "histogram"

    def __init__(self, name, help="", labels=(), buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labels)
        bounds = tuple(float(b) for b in buckets)
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"histogram {name!r} buckets must be increasing")
        self.bounds: Tuple[float, ...] = bounds
        #: key -> [per-bucket counts (+Inf last), sum, count]
        self._values: Dict[Tuple[str, ...], List[Any]] = {}

    def observe(self, value: float, **labels) -> None:
        if not _ON:
            return
        key = self._key(labels)
        # le-inclusive: bisect_left puts v == bound into bound's bucket
        idx = bisect.bisect_left(self.bounds, value)
        with self._lock:
            series = self._values.get(key)
            if series is None:
                series = self._values[key] = [
                    [0] * (len(self.bounds) + 1), 0.0, 0,
                ]
            series[0][idx] += 1
            series[1] += value
            series[2] += 1

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Approximate ``q``-quantile from the fixed buckets: the smallest
        upper bound whose cumulative count reaches ``max(q * count, 1)``
        observations (observations in the ``+Inf`` tail report the top
        bound — an UNDERestimate there, the conservative direction for
        the latency-derived hints this feeds). ``None`` when the series
        has no samples. Consumer: the serving 503 ``Retry-After``
        estimate (``interop/serving.py``)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q must be in [0, 1]; got {q}")
        with self._lock:
            s = self._values.get(self._key(labels))
            counts = None if s is None else list(s[0])
        if not counts or not sum(counts):
            return None
        target = max(q * sum(counts), 1)
        cum = 0
        for bound, cnt in zip(self.bounds, counts):
            cum += cnt
            if cum >= target:
                return bound
        return self.bounds[-1]

    def _series(self):
        with self._lock:
            return {
                k: {"counts": list(v[0]), "sum": v[1], "count": v[2]}
                for k, v in self._values.items()
            }


def _prom_name(name: str) -> str:
    return "tft_" + name.replace(".", "_").replace("-", "_")


def _prom_escape(v: str) -> str:
    """Label-VALUE escaping per the exposition format (0.0.4): backslash
    first (so the escapes it introduces survive), then double-quote,
    then newline. A label value carrying exception text — the `status`
    reasons on failure counters do — must round-trip a scrape parse."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_escape_help(v: str) -> str:
    """HELP-text escaping: the exposition format escapes backslash and
    newline there (quotes stay literal — HELP text is not quoted). Help
    strings are author-controlled, but one embedded newline would split
    the line and corrupt every series after it in the scrape."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _prom_labels(names: Tuple[str, ...], key: Tuple[str, ...], extra="") -> str:
    parts = [f'{n}="{_prom_escape(v)}"' for n, v in zip(names, key)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v: float) -> str:
    f = float(v)
    if math.isinf(f):
        # Prometheus exposition spelling; int(inf) raises, and one bad
        # observation must never 500 the whole scrape
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    return str(int(f)) if f == int(f) else repr(f)


class MetricsRegistry:
    """Get-or-create metric registry. Creation is idempotent: asking for an
    existing name returns the existing metric (type and label mismatches
    raise — two modules silently disagreeing about a metric is a bug)."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labels, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or m.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind}{m.label_names}; requested "
                        f"{cls.kind}{tuple(labels)}"
                    )
                return m
            m = cls(name, help, labels, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labels=()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name, help="", labels=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(
        self, name, help="", labels=(), buckets=DEFAULT_BUCKETS
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labels, buckets=buckets
        )

    def get(self, name: str) -> _Metric:
        return self._metrics[name]

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def render_prometheus(self) -> str:
        """Prometheus exposition text (format 0.0.4)."""
        lines: List[str] = []
        for name in self.names():
            m = self._metrics[name]
            pname = _prom_name(name)
            if m.help:
                lines.append(f"# HELP {pname} {_prom_escape_help(m.help)}")
            lines.append(f"# TYPE {pname} {m.kind}")
            series = m._series()
            if isinstance(m, Histogram):
                for key, s in sorted(series.items()):
                    cum = 0
                    for bound, cnt in zip(m.bounds, s["counts"]):
                        cum += cnt
                        lab = _prom_labels(
                            m.label_names, key, extra=f'le="{bound!r}"'
                        )
                        lines.append(f"{pname}_bucket{lab} {cum}")
                    cum += s["counts"][-1]
                    lab = _prom_labels(m.label_names, key, extra='le="+Inf"')
                    lines.append(f"{pname}_bucket{lab} {cum}")
                    lab = _prom_labels(m.label_names, key)
                    lines.append(f"{pname}_sum{lab} {_fmt(s['sum'])}")
                    lines.append(f"{pname}_count{lab} {s['count']}")
            else:
                for key, v in sorted(series.items()):
                    lab = _prom_labels(m.label_names, key)
                    lines.append(f"{pname}{lab} {_fmt(v)}")
        return "\n".join(lines) + "\n"


_default = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide default registry (what the serving scrape exports)."""
    return _default


def counter(name, help="", labels=()) -> Counter:
    return _default.counter(name, help, labels)


def gauge(name, help="", labels=()) -> Gauge:
    return _default.gauge(name, help, labels)


def histogram(name, help="", labels=(), buckets=DEFAULT_BUCKETS) -> Histogram:
    return _default.histogram(name, help, labels, buckets)


def render_prometheus() -> str:
    return _default.render_prometheus()
