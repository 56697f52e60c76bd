"""Dependency-free metrics registry (Counter / Gauge / Histogram).

Counterpart of `repro/obs/metrics.py`: the same names, label model,
snapshot shape and Prometheus text.

  - instruments are updated from host Python only, never from inside a
    kernel or a traced region, so a plain lock suffices and an update costs
    one dict lookup plus a float add;
  - `snapshot()` is atomic: it takes the registry lock once and copies
    every series, so a concurrently updating engine thread never exposes a
    histogram whose `_sum` and `_count` disagree;
  - exposition is Prometheus text (`to_prometheus`) and plain JSON
    (`to_json`): no client library, no network, no background thread.

Label model: a metric is declared once with a fixed tuple of label NAMES;
each distinct tuple of label VALUES makes one child series on first use
(`metric.labels(...)`). A metric declared with no labels is its own single
series (`counter.inc()` works directly).

Scoping: `default_registry()` is the process-global registry; components
that need isolation (tests, a per-engine Instrumentation) make their own
`MetricsRegistry`. `registry.child(**const_labels)` returns a view that
stamps constant labels (e.g. `engine="0"`) onto every metric declared
through it; the series still live in the parent, so one snapshot covers
every engine.
"""

from __future__ import annotations

import json
import math
import threading

_INF = float("inf")

#: default histogram buckets — wide enough for µs-scale CPU smoke steps and
#: second-scale real decodes (upper bounds in seconds; +Inf appended).
DEFAULT_BUCKETS = (1e-5, 1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _check_label_values(labelnames, values, kw):
    if values and kw:
        raise ValueError("pass label values positionally OR by name, not both")
    if kw:
        try:
            values = tuple(kw[n] for n in labelnames)
        except KeyError as e:
            raise ValueError(f"missing label {e} (have {labelnames})") from e
        if len(kw) != len(labelnames):
            extra = set(kw) - set(labelnames)
            raise ValueError(f"unknown labels {sorted(extra)}")
    else:
        values = tuple(values)
    if len(values) != len(labelnames):
        raise ValueError(
            f"expected {len(labelnames)} label values {labelnames}, "
            f"got {len(values)}")
    return tuple(str(v) for v in values)


class _Child:
    """One series of a Counter/Gauge: a float cell under the registry lock."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock):
        self._lock = lock
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def get(self) -> float:
        with self._lock:
            return self.value


class _HistChild:
    """One histogram series: cumulative-style bucket counts + sum + count."""

    __slots__ = ("_lock", "buckets", "counts", "sum", "count")

    def __init__(self, lock, buckets):
        self._lock = lock
        self.buckets = buckets            # ascending upper bounds, ends +Inf
        self.counts = [0] * len(buckets)  # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        with self._lock:
            self.sum += value
            self.count += 1
            for i, le in enumerate(self.buckets):
                if value <= le:
                    self.counts[i] += 1
                    break

    def cumulative(self) -> list[int]:
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile (0 <= q <= 1). Returns nan when the
        series is empty; the last finite bound when q lands in +Inf."""
        with self._lock:
            if self.count == 0:
                return math.nan
            rank = q * self.count
            acc, lo = 0, 0.0
            for i, le in enumerate(self.buckets):
                prev = acc
                acc += self.counts[i]
                if acc >= rank:
                    if le == _INF:
                        return self.buckets[i - 1] if i else math.nan
                    if self.counts[i] == 0:
                        return le
                    frac = (rank - prev) / self.counts[i]
                    return lo + frac * (le - lo)
                lo = le if le != _INF else lo
            return self.buckets[-2] if len(self.buckets) > 1 else math.nan


class _Metric:
    kind = "untyped"

    def __init__(self, name, help_, labelnames, lock):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._children: dict[tuple, object] = {}
        self._default = None  # lazily created zero-label child

    def _new_child(self):
        raise NotImplementedError

    def labels(self, *values, **kw):
        key = _check_label_values(self.labelnames, values, kw)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    def _self_child(self):
        """The single series of a label-less metric."""
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; call .labels()")
        if self._default is None:
            self._default = self.labels()
        return self._default

    def series(self):
        """Atomic copy: [(label_values_tuple, child), ...]."""
        with self._lock:
            return list(self._children.items())


class Counter(_Metric):
    kind = "counter"

    def _new_child(self):
        return _Child(self._lock)

    def inc(self, amount: float = 1.0):
        self._self_child().inc(amount)

    def get(self) -> float:
        return self._self_child().get()


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self):
        return _Child(self._lock)

    def set(self, value: float):
        self._self_child().set(value)

    def inc(self, amount: float = 1.0):
        self._self_child().inc(amount)

    def get(self) -> float:
        return self._self_child().get()


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_, labelnames, lock,
                 buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_, labelnames, lock)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError("histogram needs at least one bucket")
        if b[-1] != _INF:
            b = b + (_INF,)
        self.buckets = b

    def _new_child(self):
        return _HistChild(self._lock, self.buckets)

    def observe(self, value: float):
        self._self_child().observe(value)

    def quantile(self, q: float) -> float:
        return self._self_child().quantile(q)


class MetricsRegistry:
    """Owns metrics by name. Declaration is idempotent: re-declaring with the
    same (kind, labelnames) returns the existing metric; a conflicting
    re-declaration raises."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: dict[str, _Metric] = {}

    def _declare(self, cls, name, help_, labels, **kw):
        labels = tuple(labels)
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or m.labelnames != labels:
                    raise ValueError(
                        f"metric {name!r} already declared as {m.kind}"
                        f"{m.labelnames}, conflicting with {cls.kind}{labels}")
                return m
            m = cls(name, help_, labels, self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help_="", labels=()) -> Counter:
        return self._declare(Counter, name, help_, labels)

    def gauge(self, name, help_="", labels=()) -> Gauge:
        return self._declare(Gauge, name, help_, labels)

    def histogram(self, name, help_="", labels=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._declare(Histogram, name, help_, labels, buckets=buckets)

    def get(self, name) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def child(self, **const_labels) -> "ChildRegistry":
        return ChildRegistry(self, const_labels)

    # ---- exposition ------------------------------------------------------

    def snapshot(self) -> dict:
        """Atomic plain-dict snapshot of every series."""
        with self._lock:
            out = {}
            for name, m in self._metrics.items():
                series = []
                for key, child in m._children.items():
                    labels = dict(zip(m.labelnames, key))
                    if m.kind == "histogram":
                        series.append({
                            "labels": labels, "count": child.count,
                            "sum": child.sum,
                            "buckets": list(zip(m.buckets,
                                                child.cumulative()))})
                    else:
                        series.append({"labels": labels,
                                       "value": child.value})
                out[name] = {"type": m.kind, "help": m.help,
                             "series": series}
            return out

    def value(self, name, **labels) -> float:
        """Convenience: current value of one counter/gauge series (0.0 when
        the series has never been touched)."""
        m = self.get(name)
        if m is None:
            return 0.0
        key = _check_label_values(m.labelnames, (), labels) if labels else ()
        with self._lock:
            child = m._children.get(key)
            return child.value if child is not None else 0.0

    def to_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4)."""
        snap = self.snapshot()
        lines = []
        for name in sorted(snap):
            fam = snap[name]
            lines.append(f"# HELP {name} {_esc_help(fam['help'])}")
            lines.append(f"# TYPE {name} {fam['type']}")
            for s in fam["series"]:
                lbl = _fmt_labels(s["labels"])
                if fam["type"] == "histogram":
                    for le, cum in s["buckets"]:
                        ble = _fmt_labels({**s["labels"], "le": _fmt_le(le)})
                        lines.append(f"{name}_bucket{ble} {cum}")
                    lines.append(f"{name}_sum{lbl} {_fmt_val(s['sum'])}")
                    lines.append(f"{name}_count{lbl} {s['count']}")
                else:
                    lines.append(f"{name}{lbl} {_fmt_val(s['value'])}")
        return "\n".join(lines) + "\n"

    def to_json(self, indent=None) -> str:
        return json.dumps(self.snapshot(), indent=indent, default=_fmt_le)


class _BoundMetric:
    """A metric viewed through a ChildRegistry: constant labels pre-bound."""

    __slots__ = ("_metric", "_const")

    def __init__(self, metric, const):
        self._metric = metric
        self._const = const  # dict name -> value, subset of labelnames

    def labels(self, *values, **kw):
        free = tuple(n for n in self._metric.labelnames
                     if n not in self._const)
        vals = _check_label_values(free, values, kw)
        full = dict(zip(free, vals))
        full.update(self._const)
        return self._metric.labels(**full)

    # label-less-through-the-view convenience (all free labels empty)
    def inc(self, amount: float = 1.0):
        self.labels().inc(amount)

    def set(self, value: float):
        self.labels().set(value)

    def observe(self, value: float):
        self.labels().observe(value)

    def get(self) -> float:
        return self.labels().get()

    def quantile(self, q: float) -> float:
        return self.labels().quantile(q)


class ChildRegistry:
    """Declaration view stamping constant labels (e.g. engine id) onto every
    metric; series live in the parent registry."""

    def __init__(self, parent: MetricsRegistry, const_labels: dict):
        self.parent = parent
        self.const_labels = {k: str(v) for k, v in const_labels.items()}

    def _wrap(self, fn, name, help_, labels, **kw):
        all_labels = tuple(self.const_labels) + tuple(labels)
        return _BoundMetric(fn(name, help_, all_labels, **kw),
                            self.const_labels)

    def counter(self, name, help_="", labels=()):
        return self._wrap(self.parent.counter, name, help_, labels)

    def gauge(self, name, help_="", labels=()):
        return self._wrap(self.parent.gauge, name, help_, labels)

    def histogram(self, name, help_="", labels=(), buckets=DEFAULT_BUCKETS):
        return self._wrap(self.parent.histogram, name, help_, labels,
                          buckets=buckets)


def _esc_help(s: str) -> str:
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _esc_label(s: str) -> str:
    return s.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc_label(str(v))}"'
                     for k, v in labels.items())
    return "{" + inner + "}"


def _fmt_le(le) -> str:
    if le == _INF:
        return "+Inf"
    return repr(float(le))


def _fmt_val(v: float) -> str:
    if math.isfinite(v) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


_DEFAULT_REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-global registry (the probe's and Instrumentation's
    default; tests pass their own)."""
    return _DEFAULT_REGISTRY
