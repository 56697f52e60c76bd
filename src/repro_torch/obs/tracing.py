"""Per-request lifecycle tracing for the serving engine.

Counterpart of `repro/obs/tracing.py`. Each `Request` submitted to a
`ServeEngine` with observability on gets a `RequestTrace`: an ordered list
of timestamped spans recorded at the engine's host-side transition points

    queued ──admit──▶ prefill ──first token──▶ decode ──▶ retired
       │                  │                       │
       └─ rejected        └─ cancelled ◀──────────┘
          (event)            (terminal event, open span closed)

plus point events (`prefill_skipped` for prefix-cache hits, `rejected` with
a reason) and the frontend's lifecycle spans (`streamed`, `disconnected`,
`requeued`, `drained`; serve/frontend.py). Timestamps come from the
engine's injectable clock (`EngineConfig.clock`, `time.perf_counter` by
default, the clock that stamps `arrival_s`), so span boundaries compare
directly with `RequestResult.finish_s` and fake-clock tests need no sleeps.

Traces are host-only bookkeeping: no device work and no effect on any step
(greedy streams are bitwise the same with tracing on). Finished traces go
to a bounded `TraceSink`, which writes JSONL (`write_jsonl`) and latency
aggregates (`aggregates`: TTFT, queue-wait and per-token decode
percentiles).
"""

from __future__ import annotations

import json

#: span / terminal-state names (the JSONL schema's `span` field)
QUEUED, PREFILL, DECODE = "queued", "prefill", "decode"
RETIRED, CANCELLED, REJECTED = "retired", "cancelled", "rejected"
#: frontend lifecycle (serve/frontend.py): `streamed` is an interval span
#: opened at the first token delivered to a live consumer (auto-closed by
#: whatever terminal transition follows); `disconnected` / `requeued` are
#: terminal states for consumer-vanished / visibility-timeout cancellations;
#: `drained` marks a completed drain (point event, req_id -1).
STREAMED = "streamed"
DISCONNECTED, REQUEUED, DRAINED = "disconnected", "requeued", "drained"


class Span:
    """One named interval: [t0, t1] (t1 is None while open; t0 == t1 for
    point events) plus free-form attrs."""

    __slots__ = ("name", "t0", "t1", "attrs")

    def __init__(self, name, t0, attrs=None):
        self.name = name
        self.t0 = t0
        self.t1 = None
        self.attrs = attrs or {}

    @property
    def dur_s(self):
        return None if self.t1 is None else self.t1 - self.t0

    def to_event(self, req_id, state):
        ev = {"req_id": req_id, "span": self.name, "t0": self.t0,
              "t1": self.t1, "dur_s": self.dur_s, "state": state}
        ev.update(self.attrs)
        return ev


class RequestTrace:
    __slots__ = ("req_id", "spans", "state", "_open")

    def __init__(self, req_id: int):
        self.req_id = req_id
        self.spans: list[Span] = []
        self.state = None        # terminal: retired/cancelled/rejected
        self._open: dict[str, Span] = {}

    # ---- recording -------------------------------------------------------

    def begin(self, name: str, t: float, **attrs) -> Span:
        span = Span(name, t, attrs)
        self.spans.append(span)
        self._open[name] = span
        return span

    def end(self, name: str, t: float, **attrs) -> Span | None:
        span = self._open.pop(name, None)
        if span is not None:
            span.t1 = t
            span.attrs.update(attrs)
        return span

    def event(self, name: str, t: float, **attrs) -> Span:
        span = Span(name, t, attrs)
        span.t1 = t
        self.spans.append(span)
        return span

    def finish(self, state: str, t: float) -> None:
        """Terminal transition: closes any still-open spans at `t` and
        records the terminal state as a point event."""
        for name in list(self._open):
            self.end(name, t)
        self.state = state
        self.event(state, t)

    # ---- derived latencies ----------------------------------------------

    def span(self, name: str) -> Span | None:
        for s in self.spans:
            if s.name == name:
                return s
        return None

    @property
    def queue_wait_s(self) -> float | None:
        s = self.span(QUEUED)
        return s.dur_s if s is not None else None

    @property
    def ttft_s(self) -> float | None:
        """submit -> first sampled token (end of the prefill span)."""
        q, p = self.span(QUEUED), self.span(PREFILL)
        if q is None or p is None or p.t1 is None:
            return None
        return p.t1 - q.t0

    def decode_tok_s(self, n_tokens: int) -> float | None:
        """Mean seconds per decode-step token: the decode span covers the
        n_tokens - 1 tokens sampled AFTER the first (prefill) token."""
        d = self.span(DECODE)
        if d is None or d.dur_s is None:
            return None
        return d.dur_s / max(n_tokens - 1, 1)

    # ---- export ----------------------------------------------------------

    def events(self) -> list[dict]:
        return [s.to_event(self.req_id, self.state) for s in self.spans]


class TraceSink:
    """Bounded collector of finished traces (oldest dropped past capacity;
    `dropped` counts them so aggregates are honest about truncation)."""

    def __init__(self, max_traces: int = 4096):
        self.max_traces = max_traces
        self.traces: list[RequestTrace] = []
        self.dropped = 0

    def append(self, trace: RequestTrace) -> None:
        self.traces.append(trace)
        if len(self.traces) > self.max_traces:
            self.traces.pop(0)
            self.dropped += 1

    def write_jsonl(self, path: str) -> int:
        """One JSON event per line, traces in completion order. Returns the
        number of events written."""
        n = 0
        with open(path, "w") as f:
            for tr in self.traces:
                for ev in tr.events():
                    f.write(json.dumps(ev) + "\n")
                    n += 1
        return n

    def aggregates(self) -> dict:
        """Percentile summary over RETIRED traces (rejections/cancellations
        have no stable latency semantics)."""
        done = [t for t in self.traces if t.state == RETIRED]
        out = {"retired": len(done), "total": len(self.traces),
               "dropped": self.dropped}
        series = {
            "queue_wait_s": [t.queue_wait_s for t in done],
            "ttft_s": [t.ttft_s for t in done],
            "decode_tok_s": [
                t.decode_tok_s(t.span(DECODE).attrs.get("tokens", 1))
                for t in done],
        }
        for name, vals in series.items():
            vals = sorted(v for v in vals if v is not None)
            out[name] = _pctiles(vals)
        return out


def _pctiles(sorted_vals: list[float]) -> dict:
    if not sorted_vals:
        return {"count": 0}
    return {"count": len(sorted_vals),
            "mean": sum(sorted_vals) / len(sorted_vals),
            "p50": _pct(sorted_vals, 0.50),
            "p95": _pct(sorted_vals, 0.95),
            "p99": _pct(sorted_vals, 0.99),
            "max": sorted_vals[-1]}


def _pct(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank-with-interpolation percentile on a sorted list."""
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac
