"""The port's scheduler policies (serve/scheduler.py) in its engine.

The reference's scheduler cases (tests/test_scheduler.py) on a tiny 1-layer
model, each engine driven by a fake clock (1 ms a reading), so deadline
slack, latency and aging are deterministic:

  - the default policy is FIFO: submission order, head-of-line blocking,
    lowest-index prefill slot;
  - a high-priority request with a deadline is admitted before older
    low-priority ones; deadline slack breaks priority ties;
  - tick-based aging bounds starvation, at admission and in the prefill
    pick; a latency-critical admission preempts an older prompt's chunks;
  - LatencyPolicy lets a small fitting request overtake a large one the
    pool cannot back yet; a larger cached prefix admits first;
  - the admission order and the prefill picks equal the reference engine's
    on the same workload, by the same tick-counting clock.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro.serve import scheduler as jsched
from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.serve.scheduler import (FifoPolicy, LatencyPolicy,
                                         SchedulerPolicy)

TINY = dict(name="sched-test", family="dense", n_layers=1, d_model=32,
            n_heads=2, n_kv_heads=2, d_ff=32, vocab=64, head_dim=16)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


class FakeClock:
    """Advances 1 ms at every reading."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1e-3
        return self.t


@pytest.fixture(scope="module")
def model():
    cfg = ArchConfig(**TINY)
    return cfg, lm.init(cfg, torch.Generator().manual_seed(0), "cpu")


@pytest.fixture
def np_rng():
    return np.random.RandomState(0)


def _engine(model, **kw):
    cfg, params = model
    for k, v in dict(n_slots=1, max_len=64, block_size=16, prefill_chunk=8,
                     scheme="bf16", device="cpu").items():
        kw.setdefault(k, v)
    kw.setdefault("clock", FakeClock())
    return ServeEngine(cfg, params, EngineConfig(**kw))


def _prompt(np_rng, n=8):
    return list(map(int, np_rng.randint(0, 64, n)))


def test_default_policy_is_fifo(model, np_rng):
    eng = _engine(model)
    assert isinstance(eng.sched, FifoPolicy) and eng.sched.head_of_line
    reqs = [Request(_prompt(np_rng), 2, priority=p,
                    deadline_s=0.01 if p else None) for p in (0, 3, 9, 1)]
    ids = [eng.submit(r) for r in reqs]
    assert [r.req_id for r in eng.run()] == ids


def test_explicit_fifo_matches_default(model, np_rng):
    prompts = [_prompt(np_rng) for _ in range(4)]

    def run(sched):
        eng = _engine(model, n_slots=2, scheduler=sched)
        ids = [eng.submit(Request(p, 3)) for p in prompts]
        return [(r.req_id, r.tokens) for r in eng.run()], ids

    a, ids_a = run(None)
    b, ids_b = run(FifoPolicy())
    assert [t for _, t in a] == [t for _, t in b]
    assert [i for i, _ in a] == ids_a and [i for i, _ in b] == ids_b


def test_base_policy_hooks_are_fifo():
    reqs = [Request([1], 1, req_id=i) for i in range(3)]
    pol = SchedulerPolicy()
    assert pol.admission_order(reqs, 0.0) == reqs
    assert pol.pick_prefill([(2, None), (5, None)], 0.0) == 2


def test_high_priority_deadline_admitted_before_older_low(model, np_rng):
    eng = _engine(model, scheduler=LatencyPolicy(aging_ticks=10_000))
    low = [eng.submit(Request(_prompt(np_rng), 2)) for _ in range(4)]
    hi = eng.submit(Request(_prompt(np_rng), 2, priority=5, deadline_s=0.25))
    done = [r.req_id for r in eng.run()]
    assert done.index(hi) < min(done.index(i) for i in low)


def test_deadline_slack_breaks_priority_ties(model, np_rng):
    eng = _engine(model, scheduler=LatencyPolicy(aging_ticks=10_000))
    loose = eng.submit(Request(_prompt(np_rng), 2, deadline_s=60.0))
    tight = eng.submit(Request(_prompt(np_rng), 2, deadline_s=0.05))
    none = eng.submit(Request(_prompt(np_rng), 2))
    done = [r.req_id for r in eng.run()]
    assert done.index(tight) < done.index(loose) < done.index(none)


def test_results_carry_latency_and_deadline(model, np_rng):
    eng = _engine(model)
    eng.submit(Request(_prompt(np_rng), 2, deadline_s=120.0))
    eng.submit(Request(_prompt(np_rng), 2))
    res = eng.run()
    assert all(r.latency_s > 0 for r in res)
    assert res[0].deadline_met is True and res[1].deadline_met is None
    assert res[0].deadline_s == 120.0 and res[0].ttft_s <= res[0].latency_s


def test_aging_bounds_starvation(model, np_rng):
    """A priority-0 request under a continuous stream of priority-3
    arrivals is admitted within (gap + 1) * aging_ticks queue ticks plus
    one slot occupancy."""
    aging, gap = 2, 3
    eng = _engine(model, scheduler=LatencyPolicy(aging_ticks=aging))
    low = Request(_prompt(np_rng), 2)
    eng.submit(low)
    hi_done, admitted_at = 0, None
    for tick in range(200):
        while len(eng.queue) < 2 or all(r.priority == 0 for r in eng.queue):
            eng.submit(Request(_prompt(np_rng), 2, priority=gap))
        hi_done += sum(1 for r in eng.step() if r.req_id != low.req_id)
        if all(r.req_id != low.req_id for r in eng.queue):
            admitted_at = tick
            break
    assert admitted_at is not None, "low-priority request starved"
    assert low.queued_ticks <= (gap + 1) * aging + 8
    assert hi_done >= 1
    eng.run()


def test_latency_critical_preempts_prefill(model, np_rng):
    long_a, long_b = _prompt(np_rng, 16), _prompt(np_rng, 16)

    def first_to_finish_prefill(sched):
        eng = _engine(model, n_slots=2, prefill_chunk=4, scheduler=sched)
        a = eng.submit(Request(list(long_a), 2))
        eng.step()                   # A admitted, first chunk done
        b = eng.submit(Request(list(long_b), 2, priority=7, deadline_s=0.25))
        order = []
        for _ in range(12):
            eng.step()
            for rid, slot in ((a, eng.slots[0]), (b, eng.slots[1])):
                if (slot.req is not None and slot.state == "decode"
                        and rid not in order):
                    order.append(rid)
            if len(order) == 2:
                break
        eng.run()
        return order, a, b

    order, a, b = first_to_finish_prefill(LatencyPolicy())
    assert order[0] == b
    order, a, b = first_to_finish_prefill(None)
    assert order[0] == a


def test_latency_policy_skips_unfittable_head(model, np_rng):
    def admission_order(sched):
        eng = _engine(model, n_slots=2, n_blocks=6, scheduler=sched)
        eng.submit(Request([1] * 16, 31))               # 3 blocks
        big = eng.submit(Request([2] * 32, 31))         # 4 blocks
        small = eng.submit(Request([3] * 8, 4))         # 1 block
        admitted = []
        while eng.has_work():
            eng.step()
            for s in eng.slots:
                if s.req is not None and s.req.req_id not in admitted:
                    admitted.append(s.req.req_id)
        return admitted, big, small

    adm, big, small = admission_order(LatencyPolicy())
    assert adm.index(small) < adm.index(big)
    adm, big, small = admission_order(None)
    assert adm.index(big) < adm.index(small)


def test_cache_aware_admission_prefers_cached_prefix(model, np_rng):
    cached_prompt, other_prompt = _prompt(np_rng, 16), _prompt(np_rng, 16)
    eng = _engine(model, block_size=4, prefix_cache=True,
                  scheduler=LatencyPolicy(aging_ticks=10_000))
    eng.submit(Request(list(cached_prompt), 2))
    eng.run()
    eng.submit(Request(_prompt(np_rng), 4))
    cold = eng.submit(Request(list(other_prompt), 2))
    hot = eng.submit(Request(list(cached_prompt), 2))
    done = [r.req_id for r in eng.run()]
    assert done.index(hot) < done.index(cold)
    assert eng.stats["prefill_skipped_tokens"] > 0


def test_prefill_aging_prevents_preemption_starvation(model, np_rng):
    eng = _engine(model, n_slots=2, prefill_chunk=1,
                  scheduler=LatencyPolicy(aging_ticks=2))
    a = eng.submit(Request(_prompt(np_rng, 12), 2))
    b = eng.submit(Request(_prompt(np_rng, 12), 2, priority=5))

    def slot_of(rid):
        return next((s for s in eng.slots
                     if s.req is not None and s.req.req_id == rid), None)

    served = False
    for _ in range(30):
        eng.step()
        sa, sb = slot_of(a), slot_of(b)
        if (sa is not None and sa.cursor > 0 and sb is not None
                and sb.state == "prefill"):
            served = True
            break
    assert served
    eng.run()


# --------------------------------------------------------------------------
# the admission order against the reference engine's
# --------------------------------------------------------------------------

class TickClock:
    """Reads the engine's tick count."""

    def __init__(self):
        self.eng = None

    def __call__(self) -> float:
        return float(self.eng.stats["ticks"]) if self.eng is not None else 0.0


def _recorded_run(eng, clock, workload):
    """Submit `workload` [(prompt, max_new, priority, deadline)], run, and
    return the admission order and the prefill picks (slot, request)."""
    clock.eng = eng
    admitted, picks = [], []
    try_admit, pick = eng._try_admit, eng.sched.pick_prefill

    def rec_admit(req):
        ok = try_admit(req)
        if ok:
            admitted.append(req.req_id)
        return ok

    def rec_pick(cands, now):
        i = pick(cands, now)
        picks.append((i, eng.slots[i].req.req_id))
        return i

    eng._try_admit, eng.sched.pick_prefill = rec_admit, rec_pick
    for prompt, max_new, prio, deadline in workload:
        req = (jengine.Request if isinstance(eng, jengine.ServeEngine)
               else Request)(prompt=list(prompt), max_new=max_new,
                             priority=prio, deadline_s=deadline)
        eng.submit(req)
    eng.run()
    return admitted, picks


@pytest.mark.parametrize("policy,cache", [("fifo", False), ("latency", False),
                                          ("latency", True)],
                         ids=["fifo", "latency", "latency-cache"])
def test_order_matches_reference_engine(model, policy, cache):
    rng = np.random.RandomState(5)
    shared = list(map(int, rng.randint(0, 64, 12)))
    workload = []
    for i in range(10):
        prompt = (shared[:8] if i % 3 == 0 else []) + list(
            map(int, rng.randint(0, 64, int(rng.randint(3, 14)))))
        workload.append((prompt, int(rng.randint(1, 5)), int(i % 4 == 3) * 2,
                         (0.5 + i) if i % 2 else None))
    kw = dict(n_slots=2, max_len=32, block_size=4, n_blocks=12,
              prefill_chunk=4, scheme="bf16", prefix_cache=cache)
    jcfg = JArchConfig(**TINY)
    jeng = jengine.ServeEngine(
        jcfg, jlm.init(jcfg, jax.random.PRNGKey(0)), jengine.EngineConfig(
            clock=(jclock := TickClock()), prequant=False,
            scheduler=(jsched.LatencyPolicy(aging_ticks=3)
                       if policy == "latency" else jsched.FifoPolicy()), **kw))
    want = _recorded_run(jeng, jclock, workload)
    eng = _engine(model, clock=(clock := TickClock()),
                  scheduler=(LatencyPolicy(aging_ticks=3)
                             if policy == "latency" else FifoPolicy()), **kw)
    got = _recorded_run(eng, clock, workload)
    assert got == want
    assert len(set(want[0])) == len(workload)
    assert eng.stats["prefill_skipped_tokens"] == \
        jeng.stats["prefill_skipped_tokens"]
    if cache:
        assert eng.stats["prefix_hits"] >= 2
