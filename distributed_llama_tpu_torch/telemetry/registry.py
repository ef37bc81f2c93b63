"""Process-global metrics registry: counters, gauges, fixed-bucket histograms.

The port's copy of the JAX package's ``telemetry/registry.py``: the same
instruments, label handling and Prometheus text exposition, byte for byte.
Every instrument is a named, typed, optionally-labelled value that can be
read live (Prometheus text exposition, the server's ``/metrics``) or
snapshotted (`python -m distributed_llama_tpu_torch.telemetry.dump`).

Design constraints:

* **Zero overhead when disabled.** Callers bind instruments ONCE (engine
  construction, server startup) through :mod:`distributed_llama_tpu_torch.telemetry`,
  which hands back shared null singletons when telemetry is off — the hot
  loop then pays one attribute-bound no-op method call per *dispatch* (not
  per token), no dict lookups, and the registry is never touched.
* **Thread safety.** The API server records from several completion threads
  at once; instrument mutation takes a per-instrument lock (the enabled
  path only — null instruments have no state). A reader holds a lock only
  to copy values: exposition formats outside it.
* **Fixed buckets.** Histograms are fixed-boundary (Prometheus semantics:
  cumulative bucket counts + sum + count); the default boundaries span
  10 µs → 10 s, tuned for token-level latency work.
"""

from __future__ import annotations

import threading

# 10 µs → 10 s: wide enough for a kernel launch at the bottom and a cold
# 7B-width prefill at the top, log-ish spaced for token-level latency
DEFAULT_LATENCY_BUCKETS = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _fmt(v: float) -> str:
    """Prometheus number formatting: integers without a trailing .0."""
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels_text(items: tuple[tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(str(v))}"' for k, v in items]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Instrument:
    """Common machinery: a name/help pair and (optional) label children.

    An instrument created with ``labelnames`` is a parent: call
    ``.labels(key=value, ...)`` to get (or lazily create) the child that
    actually holds a value. Without labelnames the instrument holds its own
    value directly.
    """

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labelnames: tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], _Instrument] = {}
        self._label_items: tuple[tuple[str, str], ...] = ()

    def labels(self, **kw):
        if set(kw) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kw)} != declared {sorted(self.labelnames)}"
            )
        key = tuple(str(kw[k]) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                child._label_items = tuple(zip(self.labelnames, key))
                self._children[key] = child
            return child

    def _make_child(self) -> "_Instrument":
        raise NotImplementedError

    def _check_unlabelled(self) -> None:
        if self.labelnames:
            raise ValueError(
                f"{self.name} declares labels {self.labelnames}; use .labels(...)"
            )

    def _series(self):
        """The value-holding instruments: self, or the label children."""
        if self.labelnames:
            with self._lock:
                return list(self._children.values())
        return [self]


class Counter(_Instrument):
    """Monotonically increasing count (Prometheus counter)."""

    kind = "counter"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._value = 0.0

    def _make_child(self):
        return Counter(self.name, self.help)

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters only go up (inc {n})")
        self._check_unlabelled()
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def _exposition_lines(self, series):
        return [
            f"{self.name}{_labels_text(s._label_items)} {_fmt(s._value)}"
            for s in series
        ]


class Gauge(_Instrument):
    """A value that can go up and down (occupancy, in-flight requests)."""

    kind = "gauge"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._value = 0.0

    def _make_child(self):
        return Gauge(self.name, self.help)

    def set(self, v: float) -> None:
        self._check_unlabelled()
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self._check_unlabelled()
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._value

    def _exposition_lines(self, series):
        return [
            f"{self.name}{_labels_text(s._label_items)} {_fmt(s._value)}"
            for s in series
        ]


class Histogram(_Instrument):
    """Fixed-bucket histogram with Prometheus cumulative-bucket semantics."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help, labelnames)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError(f"{self.name}: at least one bucket boundary required")
        self.buckets = b
        self._counts = [0] * (len(b) + 1)  # last slot = +Inf overflow
        self._sum = 0.0
        self._count = 0

    def _make_child(self):
        return Histogram(self.name, self.help, buckets=self.buckets)

    def observe(self, v: float) -> None:
        self._check_unlabelled()
        with self._lock:
            self._sum += v
            self._count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def _read_consistent(self) -> tuple[dict[float, int], float, int]:
        """(cumulative bucket counts, sum, count) under the instrument lock:
        a reader racing observe() must never see count != the +Inf bucket
        (the Prometheus histogram invariant promtool lints for)."""
        with self._lock:
            counts = list(self._counts)
            total, n = self._sum, self._count
        out, acc = {}, 0
        for b, c in zip(self.buckets, counts):
            acc += c
            out[b] = acc
        out[float("inf")] = acc + counts[-1]
        return out, total, n

    def bucket_counts(self) -> dict[float, int]:
        """CUMULATIVE counts keyed by upper bound (inf included), the
        Prometheus ``le`` semantics."""
        return self._read_consistent()[0]

    def _exposition_lines(self, series):
        lines = []
        for s in series:
            buckets, total, n = s._read_consistent()
            for b, c in buckets.items():
                le = _labels_text(s._label_items, extra=f'le="{_fmt(b)}"')
                lines.append(f"{self.name}_bucket{le} {c}")
            lt = _labels_text(s._label_items)
            lines.append(f"{self.name}_sum{lt} {_fmt(total)}")
            lines.append(f"{self.name}_count{lt} {n}")
        return lines


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Name → instrument map with idempotent registration and text exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Instrument] = {}

    def _register(self, cls, name, help, labelnames, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls or existing.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as {existing.kind} "
                        f"with labels {existing.labelnames}"
                    )
                if "buckets" in kw and existing.buckets != tuple(
                    sorted(float(x) for x in kw["buckets"])
                ):
                    # a silent bucket mismatch would land observations in
                    # boundaries the second registrant never asked for
                    raise ValueError(
                        f"histogram {name!r} already registered with buckets "
                        f"{existing.buckets}"
                    )
                return existing
            inst = cls(name, help, labelnames=labelnames, **kw)
            self._metrics[name] = inst
            return inst

    def counter(self, name: str, help: str = "", labelnames=()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(
        self, name: str, help: str = "", labelnames=(),
        buckets=DEFAULT_LATENCY_BUCKETS,
    ) -> Histogram:
        return self._register(Histogram, name, help, labelnames, buckets=buckets)

    def get(self, name: str) -> _Instrument | None:
        return self._metrics.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def reset(self) -> None:
        """Drop every registered metric (tests)."""
        with self._lock:
            self._metrics.clear()

    def prometheus_text(self) -> str:
        """The full registry in Prometheus text exposition format 0.0.4.

        Counters with zero increments and histograms with zero observations
        still expose their series, so a freshly started server advertises
        its metric names before the first request."""
        lines: list[str] = []
        for name in self.names():
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(m._exposition_lines(m._series()))
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """One-shot JSON-able view of every metric (the dump helper's read path)."""
        out: dict[str, dict] = {}
        for name in self.names():
            m = self._metrics[name]
            entry: dict = {"type": m.kind, "help": m.help}
            series = []
            for s in m._series():
                item: dict = {"labels": dict(s._label_items)}
                if isinstance(s, Histogram):
                    buckets, total, count = s._read_consistent()
                    item.update(
                        sum=total, count=count,
                        buckets={_fmt(b): c for b, c in buckets.items()},
                    )
                else:
                    item["value"] = s._value
                series.append(item)
            entry["series"] = series
            out[name] = entry
        return out
