"""The port's observability layer (`repro_torch/obs/`) against the JAX
reference's (`repro/obs/`), and its wiring into the port's engine.

  - registry and traces: the same operations on both packages' objects give
    IDENTICAL Prometheus text, snapshots, JSON (histogram buckets and
    quantiles included, constant-label child registries too), trace events,
    trace aggregates and JSONL lines (exact: host floats, same arithmetic);
  - instrumented engines: the port's engine and the reference engine serve
    the same requests (reduced llama, scheme bf16, FIFO, the prefix cache,
    a QueueFull, an Unservable, a queued and an in-flight cancel) with the
    same weights and one fake clock each that advances a fixed 0.25 s a
    call. Every counter and gauge series is equal, every histogram's counts
    and its sum (both engines read the clock at the same points, so every
    span and step time is the same multiple of the step, summed exactly),
    and each request's trace has the same span names in the same order.
    The port's registry has two series more (its draft catch-up counts);
  - disabled mode: the NULL sentinel, a plain stats dict, and no allocation
    at all from `obs/` while an engine runs (tracemalloc); streams are
    bitwise equal with obs on and off under bf16 and quartet2;
  - the serve layer and obs report nothing by print() or logging.

Each test runs under a 60 s SIGALRM guard of this file's own.
"""

import ast
import functools
import json
import math
import pathlib
import signal
import tracemalloc

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.obs import tracing as jtracing
from repro.serve import engine as jengine
from repro_torch import obs as pobs
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.obs import tracing as ptracing
from repro_torch.serve import engine as pengine
from repro_torch.serve.engine import (EngineConfig, QueueFull, Request,
                                      ServeEngine, Unservable)

TEST_TIMEOUT_S = 60
PROMPT_LENS = (19, 5, 11, 8, 3)   # prompt + 6 new: no stream ends on a block
MAX_NEW = 6
KW = dict(n_slots=2, max_len=48, prefill_chunk=8)


@pytest.fixture(autouse=True)
def _guard():
    """One thread for the bitwise claims, and a per-test wall-clock bound
    (a hung engine fails loudly instead of stalling the run)."""
    torch.set_num_threads(1)

    def fail(signum, frame):
        raise TimeoutError(f"test exceeded {TEST_TIMEOUT_S} s")

    old = signal.signal(signal.SIGALRM, fail)
    signal.alarm(TEST_TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


class TickClock:
    """A clock that advances a fixed step at every read."""

    def __init__(self, t: float = 100.0, dt: float = 0.25):
        self.t, self.dt = t, dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


def _prompts(vocab):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, n).tolist() for n in PROMPT_LENS]


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg = jregistry.get("llama_200m").reduced()
    jparams = jlm.init(jcfg, jax.random.PRNGKey(0))
    cfg = registry.get("llama_200m").reduced()
    return jcfg, jparams, cfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")


# --------------------------------------------------------------------------
# registry and traces: the same operations, the same exposition
# --------------------------------------------------------------------------

def _drive_registry(mod):
    """A seeded mix of every metric operation, on package `mod`'s registry."""
    rng = np.random.RandomState(7)
    reg = mod.MetricsRegistry()
    c = reg.counter("req_total", "requests\nby route", labels=("route", "code"))
    g = reg.gauge("depth", "queue depth")
    h = reg.histogram("lat_seconds", 'latency "s"', labels=("phase",),
                      buckets=(0.001, 0.01, 0.1, 1.0))
    bare = reg.histogram("bare_seconds")
    for _ in range(200):
        c.labels(rng.choice(["a", "b\\c"]), str(rng.choice([200, 500]))).inc(
            float(rng.randint(1, 4)))
        g.set(float(rng.randint(0, 50)))
        g.inc(-0.5)
        h.labels(phase=rng.choice(["dispatch", "synced"])).observe(
            float(rng.lognormal(-4, 2)))
        bare.observe(float(rng.exponential(0.05)))
    child = reg.child(engine="3")
    cc = child.counter("ev_total", "events", labels=("kind",))
    cc.labels(kind="x").inc(2)
    cc.labels("y").inc()
    child.gauge("free").set(12)
    ch = child.histogram("step_seconds", buckets=(0.5, 2.0))
    for v in (0.1, 0.5, 1.0, 3.0, 7.5):
        ch.observe(v)
    qs = [h.labels(phase=p).quantile(q) for p in ("dispatch", "synced")
          for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)]
    qs += [bare.quantile(q) for q in (0.25, 0.5, 0.75)]
    qs += [ch.quantile(q) for q in (0.2, 0.6, 1.0)]
    qs.append(reg.histogram("empty").quantile(0.5))
    return reg, qs


def test_registry_exposition_equals_reference():
    port, pq = _drive_registry(pobs)
    ref, rq = _drive_registry(jobs)
    assert port.to_prometheus() == ref.to_prometheus()
    assert port.snapshot() == ref.snapshot()
    assert port.to_json() == ref.to_json()
    assert port.to_json(indent=1) == ref.to_json(indent=1)
    assert len(pq) == len(rq)
    assert all(a == b or (math.isnan(a) and math.isnan(b))
               for a, b in zip(pq, rq))
    assert port.value("ev_total", engine="3", kind="x") == 2.0
    # the snapshot is a copy: a later update does not reach it
    snap = port.snapshot()
    port.get("depth").set(-1)
    assert snap["depth"]["series"][0]["value"] != -1


def test_registry_errors_match_reference():
    for mod in (pobs, jobs):
        reg = mod.MetricsRegistry()
        c = reg.counter("m", labels=("x",))
        assert reg.counter("m", labels=("x",)) is c
        for bad in (lambda: reg.gauge("m", labels=("x",)),
                    lambda: reg.counter("m", labels=("y",)),
                    lambda: c.labels(), lambda: c.labels(y="a"),
                    lambda: c.inc(), lambda: reg.histogram("h", buckets=())):
            with pytest.raises(ValueError):
                bad()


def _drive_traces(tracing, path):
    """One event sequence of every lifecycle into `tracing`'s TraceSink
    (capacity 5, so one trace drops)."""
    sink = tracing.TraceSink(max_traces=5)
    t = 10.0
    for rid in range(4):  # retired, with a prefix hit on odd ids
        tr = tracing.RequestTrace(rid)
        tr.begin(tracing.QUEUED, t)
        tr.end(tracing.QUEUED, t + 0.5 + rid)
        if rid % 2:
            tr.event("prefill_skipped", t + 0.5 + rid, tokens=16 * rid)
        tr.begin(tracing.PREFILL, t + 0.5 + rid, slot=rid % 2)
        tr.end(tracing.PREFILL, t + 2.0 + rid)
        tr.begin(tracing.DECODE, t + 2.0 + rid)
        tr.begin(tracing.STREAMED, t + 2.25 + rid)
        tr.end(tracing.DECODE, t + 5.0 + 2 * rid, tokens=4 + rid)
        tr.finish(tracing.RETIRED, t + 5.0 + 2 * rid)
        sink.append(tr)
    tr = tracing.RequestTrace(4)
    tr.begin(tracing.QUEUED, t)
    tr.finish(tracing.DISCONNECTED, t + 1.0)
    sink.append(tr)
    tr = tracing.RequestTrace(-1)
    tr.finish(tracing.REJECTED, t + 2.0)
    tr.spans[-1].attrs["reason"] = "queue_full"
    sink.append(tr)
    n = sink.write_jsonl(str(path))
    return sink, n, path.read_text().splitlines()


def test_traces_equal_reference(tmp_path):
    ps, pn, plines = _drive_traces(ptracing, tmp_path / "port.jsonl")
    rs, rn, rlines = _drive_traces(jtracing, tmp_path / "ref.jsonl")
    assert ps.dropped == rs.dropped == 1
    assert [t.events() for t in ps.traces] == [t.events() for t in rs.traces]
    assert ps.aggregates() == rs.aggregates()
    assert pn == rn and plines == rlines
    assert [json.loads(x)["span"] for x in plines][-1] == "rejected"
    tr = ps.traces[0]
    assert (tr.queue_wait_s, tr.ttft_s, tr.decode_tok_s(5)) == (1.5, 3.0, 1.0)


# --------------------------------------------------------------------------
# instrumented engines, port against reference
# --------------------------------------------------------------------------

def _scenario(mod_engine, mod_obs, make):
    """Submit 4 requests, a 5th into a full queue (max_queue 4) and an
    unservable one; tick 6 times; cancel an in-flight and a queued request;
    run to the end. Returns what the comparison reads."""
    obs = mod_obs.Instrumentation(registry=mod_obs.MetricsRegistry(),
                                  engine_label="0")
    eng = make(obs)
    prompts = _prompts(_weights()[2].vocab)
    ids = [eng.submit(mod_engine.Request(p, MAX_NEW)) for p in prompts[:4]]
    with pytest.raises(mod_engine.QueueFull) as full:
        eng.submit(mod_engine.Request(prompts[4], MAX_NEW))
    with pytest.raises(mod_engine.Unservable) as unservable:
        eng.submit(mod_engine.Request([1, 2, 3], 1000))
    for _ in range(6):
        eng.step()
    in_flight = [s.req.req_id for s in eng.slots if s.req is not None]
    queued = [r.req_id for r in eng.queue]
    cancels = (eng.cancel(in_flight[-1]), eng.cancel(queued[-1]),
               eng.cancel(10_000))
    results = {r.req_id: r for r in eng.run()}
    return dict(obs=obs, eng=eng, ids=ids, full=full.value,
                unservable=unservable.value, results=results,
                cancelled=(in_flight[-1], queued[-1]), cancels=cancels)


@functools.lru_cache(maxsize=None)
def _instrumented_runs():
    jcfg, jparams, cfg, params = _weights()
    econf = dict(KW, scheme="bf16", prefix_cache=True, max_queue=4)
    ref = _scenario(jengine, jobs, lambda obs: jengine.ServeEngine(
        jcfg, jparams, jengine.EngineConfig(obs=obs, clock=TickClock(),
                                            **econf)))
    port = _scenario(pengine, pobs, lambda obs: ServeEngine(
        cfg, params, EngineConfig(device="cpu", obs=obs, clock=TickClock(),
                                  **econf)))
    return port, ref


def test_instrumented_engine_series_equal_reference():
    port, ref = _instrumented_runs()
    # the same schedule: the same streams, cancels and results
    assert port["cancelled"] == ref["cancelled"]
    assert port["cancels"] == ref["cancels"] == (True, True, False)
    assert {k: r.tokens for k, r in port["results"].items()} == \
        {k: r.tokens for k, r in ref["results"].items()}
    psnap = port["obs"].snapshot()
    rsnap = ref["obs"].snapshot()
    assert set(psnap) - set(rsnap) == {
        "serve_engine_draft_catchup_tokens_total",
        "serve_engine_draft_catchup_steps_total"}
    assert set(rsnap) <= set(psnap)
    n_hist = 0
    for name, fam in rsnap.items():
        mine = psnap[name]
        assert (mine["type"], mine["help"]) == (fam["type"], fam["help"])
        if fam["type"] != "histogram":
            assert mine["series"] == fam["series"], name
            continue
        n_hist += 1
        assert len(mine["series"]) == len(fam["series"]), name
        for a, b in zip(mine["series"], fam["series"]):
            assert a["labels"] == b["labels"], name
            assert a["buckets"] == b["buckets"], name  # counts, cumulative
            assert a["count"] == b["count"], name
            assert a["sum"] == b["sum"], name
    assert n_hist >= 7
    # the books that the comparison covers are not empty
    st = port["eng"].stats
    assert st["rejected"] == 2 and st["cancelled"] == 2
    assert st["finished"] == 2 and st["decode_steps"] > 0
    reject = dict(((s["labels"]["reason"], s["value"]) for s in
                   psnap["serve_rejections_total"]["series"]))
    assert reject == {"queue_full": 1.0, "unservable": 1.0}


def test_instrumented_engine_traces_equal_reference():
    port, ref = _instrumented_runs()

    def shape(obs):
        return [(t.req_id, t.state, [s.name for s in t.spans])
                for t in obs.trace_sink.traces]

    assert shape(port["obs"]) == shape(ref["obs"])
    assert sorted(t.state for t in port["obs"].trace_sink.traces) == [
        "cancelled", "cancelled", "rejected", "rejected", "retired",
        "retired"]
    assert [t.events() for t in port["obs"].trace_sink.traces] == \
        [t.events() for t in ref["obs"].trace_sink.traces]
    assert port["obs"].trace_sink.aggregates() == \
        ref["obs"].trace_sink.aggregates()
    for rid, r in ref["results"].items():
        p = port["results"][rid]
        assert (p.queue_wait_s, p.ttft_s, p.decode_tok_s) == \
            (r.queue_wait_s, r.ttft_s, r.decode_tok_s)
        # with obs on the result's TTFT is the trace's
        tr = next(t for t in port["obs"].trace_sink.traces
                  if t.req_id == rid)
        assert p.ttft_s == tr.ttft_s


def test_structured_rejections_equal_reference():
    port, ref = _instrumented_runs()
    assert port["full"].info() == ref["full"].info() == {
        "reason": "queue_full", "queue_depth": 4, "retry_after_s": 1.0}
    assert port["unservable"].info() == ref["unservable"].info()
    assert [c.__name__ for c in type(port["unservable"]).__mro__] == \
        [c.__name__ for c in type(ref["unservable"]).__mro__]
    assert isinstance(port["unservable"], ValueError)
    assert isinstance(port["unservable"], QueueFull)
    assert issubclass(Unservable, QueueFull)


def test_retry_hint_follows_the_decode_rate():
    """suggested_retry_after_s: 1.0 before any decode; the backlog over the
    observed rate, clamped to [0.5, 60], after."""
    *_, cfg, params = _weights()
    eng = ServeEngine(cfg, params, EngineConfig(device="cpu", scheme="bf16",
                                                clock=TickClock(), **KW))
    assert eng.suggested_retry_after_s() == 1.0
    for p in _prompts(cfg.vocab)[:3]:
        eng.submit(Request(p, MAX_NEW))
    while eng.stats["decode_tokens"] < 4:
        eng.step()
    st = eng.stats
    backlog = sum(r.max_new for r in eng.queue) + sum(
        r.max_new - len(s.generated) for s in eng.slots
        if (r := s.req) is not None)
    want = min(max(backlog / (st["decode_tokens"] / st["decode_s"]), 0.5),
               60.0)
    assert eng.suggested_retry_after_s() == pytest.approx(want)
    eng.run()


# --------------------------------------------------------------------------
# disabled mode
# --------------------------------------------------------------------------

def _streams(scheme, obs=None, **kw):
    *_, cfg, params = _weights()
    eng = ServeEngine(cfg, params, EngineConfig(
        device="cpu", scheme=scheme, obs=obs, **dict(KW, **kw)))
    for p in _prompts(cfg.vocab):
        eng.submit(Request(p, MAX_NEW))
    res = {r.req_id: r for r in eng.run()}
    return eng, {k: r.tokens for k, r in res.items()}, res


def test_disabled_mode_is_the_null_sentinel():
    eng, _, res = _streams("bf16")
    assert eng.obs is pobs.NULL and pobs.NULL.enabled is False
    assert type(eng.stats) is dict
    assert list(eng.stats) == list(pobs.legacy_stats_dict())
    assert eng.pool.obs is None
    with pytest.raises(AttributeError):
        pobs.NULL.on_submit
    with pytest.raises(AttributeError):
        pobs.NULL.extra = 1
    # the port's one difference: TTFT is filled with obs off too
    assert all(r.ttft_s is not None and r.queue_wait_s is None
               and r.decode_tok_s is None for r in res.values())


@pytest.mark.parametrize("scheme", ["bf16", "quartet2"])
def test_streams_bitwise_equal_with_obs_on_and_off(scheme):
    _, plain, _ = _streams(scheme)
    eng, traced, res = _streams(
        scheme, obs=pobs.Instrumentation(registry=pobs.MetricsRegistry()))
    assert plain == traced
    assert type(eng.stats) is not dict and eng.pool.obs is eng.obs
    assert all(r.queue_wait_s is not None for r in res.values())


def test_sharded_streams_bitwise_with_obs_and_per_shard_gauges():
    """Over a two-shard mesh obs on leaves the bf16 streams bitwise the obs
    off ones, and the pool gauge carries one series a shard."""
    from repro_torch.launch.mesh import make_serve_mesh
    mesh = make_serve_mesh(2, 1, devices=["cpu", "cpu"])
    _, plain, _ = _streams("bf16", mesh=mesh)
    reg = pobs.MetricsRegistry()
    eng, traced, _ = _streams("bf16", mesh=mesh,
                              obs=pobs.Instrumentation(registry=reg))
    assert plain == traced
    per_shard = eng.pool.blocks_per_shard
    assert [eng.obs.pool_free_blocks.labels(shard=str(s)).get()
            for s in range(2)] == [per_shard, per_shard]


def test_disabled_hook_sites_allocate_nothing():
    """tracemalloc over a whole engine run (prefix cache, LatencyPolicy,
    spec decoding: every hook site): nothing is allocated from a line of
    `obs/` with obs off, and something is with it on (the check sees it)."""
    from repro_torch.serve.scheduler import LatencyPolicy
    obs_dir = str(pathlib.Path(pobs.__file__).parent)

    def allocated_in_obs(obs):
        tracemalloc.start()
        try:
            _streams("bf16", obs=obs, prefix_cache=True,
                     scheduler=LatencyPolicy(), spec_k=2, draft_layers=1)
            snap = tracemalloc.take_snapshot()
        finally:
            tracemalloc.stop()
        return sum(s.size for s in snap.statistics("filename")
                   if s.traceback[0].filename.startswith(obs_dir))

    assert allocated_in_obs(None) == 0
    assert allocated_in_obs(
        pobs.Instrumentation(registry=pobs.MetricsRegistry())) > 0


def test_spec_acceptance_histogram_and_probe_hook():
    """The speculative path's acceptance histogram books one observation a
    (slot, round) summing to the accepted drafts; `prequantize` runs the
    Instrumentation's quant probe over the raw weights."""
    from repro_torch.obs.quant_probe import QuantProbe
    reg = pobs.MetricsRegistry()
    probe = QuantProbe(scheme="quartet2", max_sites=2, registry=reg)
    obs = pobs.Instrumentation(registry=reg, quant_probe=probe)
    eng, _, _ = _streams("quartet2", obs=obs, spec_k=2, draft_layers=1)
    child = reg.get("serve_spec_accepted_per_round").labels(
        engine=obs.engine_label)
    assert child.count >= eng.stats["spec_rounds"] > 0
    assert child.sum == eng.stats["accepted_tokens"]
    assert reg.value("nvfp4_probe_samples_total", phase="prequant") == 2


# --------------------------------------------------------------------------
# serve-layer hygiene
# --------------------------------------------------------------------------

def test_no_print_or_logging_in_serve_layer_or_obs():
    root = pathlib.Path(__file__).resolve().parent.parent / "src" / \
        "repro_torch"
    offenders = []
    for sub in ("serve", "obs"):
        for path in sorted((root / sub).glob("*.py")):
            tree = ast.parse(path.read_text(), filename=str(path))
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if isinstance(f, ast.Name) and f.id == "print":
                    offenders.append(f"{sub}/{path.name}:{node.lineno} print()")
                if (isinstance(f, ast.Attribute)
                        and isinstance(f.value, ast.Name)
                        and f.value.id == "logging"):
                    offenders.append(f"{sub}/{path.name}:{node.lineno} logging")
    assert not offenders, offenders
