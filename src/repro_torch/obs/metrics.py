"""Dependency-free metrics registry: Counter and Gauge with label series.

The port's own copy of the part of `repro/obs/metrics.py` that the
quantization-health probe uses (the histograms, label-less shortcuts, JSON
exposition and constant-label child registries come with the engine's
telemetry): the same names, label model and Prometheus text. Instruments
are updated from host Python only, so a plain lock suffices; `snapshot()`
takes the lock once and copies every series.

Label model: a metric is declared once with a fixed tuple of label NAMES;
each distinct tuple of label VALUES makes one child series on first use
(`metric.labels(...)`). `default_registry()` is the process-global
registry; tests and components that need isolation make their own
`MetricsRegistry`.
"""

from __future__ import annotations

import math
import threading


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


class _Metric:
    kind = "untyped"

    def __init__(self, name, help_, labelnames, lock):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._children: dict[tuple, _Child] = {}

    def labels(self, *values, **kw):
        key = _check_label_values(self.labelnames, values, kw)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _Child(self._lock)
            return child


class Counter(_Metric):
    kind = "counter"


class Gauge(_Metric):
    kind = "gauge"


class MetricsRegistry:
    """Owns metrics by name. Declaration is idempotent: re-declaring with the
    same (kind, labelnames) returns the existing metric; a conflicting
    re-declaration raises."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: dict[str, _Metric] = {}

    def _declare(self, cls, name, help_, labels):
        labels = tuple(labels)
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or m.labelnames != labels:
                    raise ValueError(
                        f"metric {name!r} already declared as {m.kind}"
                        f"{m.labelnames}, conflicting with {cls.kind}{labels}")
                return m
            m = cls(name, help_, labels, self._lock)
            self._metrics[name] = m
            return m

    def counter(self, name, help_="", labels=()) -> Counter:
        return self._declare(Counter, name, help_, labels)

    def gauge(self, name, help_="", labels=()) -> Gauge:
        return self._declare(Gauge, name, help_, labels)

    def get(self, name) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    # ---- exposition ------------------------------------------------------

    def snapshot(self) -> dict:
        """Atomic plain-dict snapshot of every series."""
        with self._lock:
            out = {}
            for name, m in self._metrics.items():
                series = []
                for key, child in m._children.items():
                    series.append({"labels": dict(zip(m.labelnames, key)),
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
                lines.append(f"{name}{_fmt_labels(s['labels'])} "
                             f"{_fmt_val(s['value'])}")
        return "\n".join(lines) + "\n"


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


def _fmt_val(v: float) -> str:
    if math.isfinite(v) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


_DEFAULT_REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-global registry (the probe's default)."""
    return _DEFAULT_REGISTRY
