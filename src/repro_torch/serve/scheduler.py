"""Serving scheduler policies: admission order and the prefill pick.

Counterpart of `repro/serve/scheduler.py`. The engine's tick admits from
the queue, prefills ONE chunk and runs one batched decode step; a policy is
consulted at two points, neither of which changes a step's shape:

  admission_order(queue, now) — the order in which queued requests are
      offered a slot this tick, with `head_of_line`: whether a request that
      cannot be placed blocks everything behind it (FIFO) or is skipped.
  pick_prefill(candidates, now) — which PREFILL slot gets this tick's
      chunk.

`FifoPolicy` (the default) is the plain engine: queue order with
head-of-line blocking, lowest-index prefill slot.

`LatencyPolicy` orders by (effective priority desc, deadline slack asc,
cached-prefix hint desc, request id), where effective priority = priority +
queued_ticks // aging_ticks. Aging counts engine ticks, so it is
deterministic: a waiting request outranks any fixed-priority competitor
after at most (priority gap + 1) * aging_ticks ticks. Policies read no
clock themselves: `now` is the engine's `clock()`, so a test drives them
with a fake clock. With observability on, the engine calls `observe` once
a tick to report queue depth and aging (LatencyPolicy adds deadline slack).
"""

from __future__ import annotations

from dataclasses import dataclass


class SchedulerPolicy:
    """Base policy = FIFO. Subclasses change ordering only; the engine owns
    placement and every pool interaction."""

    #: a request that cannot be placed blocks those behind it (strict FIFO)
    head_of_line: bool = True

    def admission_order(self, queue, now: float):
        """Queue snapshot -> iteration order for this tick's admissions."""
        return list(queue)

    def pick_prefill(self, candidates, now: float) -> int:
        """candidates: [(slot_index, slot), ...] in slot order, all in
        PREFILL state. Returns the slot index to advance."""
        return candidates[0][0]

    def observe(self, obs, queue, now: float) -> None:
        """Per-tick scheduler telemetry (queue depth and aging) through the
        engine's Instrumentation; subclasses extend it with their own
        urgency model. Host-side only."""
        obs.queue_depth.set(len(queue))
        obs.queue_age.set(max((r.queued_ticks for r in queue), default=0))


class FifoPolicy(SchedulerPolicy):
    """Submission order, head-of-line blocking, lowest-index prefill slot."""


@dataclass
class LatencyPolicy(SchedulerPolicy):
    """Priority and deadline admission, prefill preemption, and tick-based
    aging (module docstring)."""

    #: queue ticks per +1 effective priority while waiting
    aging_ticks: int = 8

    head_of_line = False

    def _slack(self, req, now: float) -> float:
        if req.deadline_s is None:
            return float("inf")
        return (req.arrival_s + req.deadline_s) - now

    def effective_priority(self, req) -> int:
        return req.priority + req.queued_ticks // max(self.aging_ticks, 1)

    def admission_order(self, queue, now: float):
        return sorted(
            queue,
            key=lambda r: (-self.effective_priority(r), self._slack(r, now),
                           -r.cached_hint, r.req_id))

    def observe(self, obs, queue, now: float) -> None:
        super().observe(obs, queue, now)
        slacks = [self._slack(r, now) for r in queue
                  if r.deadline_s is not None]
        if slacks:  # finite only: +Inf would poison the JSON exposition
            obs.queue_slack.set(min(slacks))

    def pick_prefill(self, candidates, now: float) -> int:
        """The most urgent PREFILL slot gets the chunk. The engine ages the
        slots not picked, so a passed-over prompt eventually wins."""
        def key(item):
            i, slot = item
            r = slot.req
            return (-self.effective_priority(r), self._slack(r, now), i)
        return min(candidates, key=key)[0]
