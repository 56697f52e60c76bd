"""Shared harness of the port's engine-stream tests: one set of requests
served by the JAX reference `ServeEngine` and by the port's, with the same
weights (JAX init, converted) and the same FIFO / chunking schedule.

  - bf16: the greedy streams are equal, except that a row is compared only
    up to its first token whose reference top-2 logit margin is within
    BF16_TIE_ULPS bf16 ulps of the top logit: the port's bf16 logits sit
    within 1-2 ulps of the jitted reference's (fp32 summation order, and
    XLA's reciprocal multiply for a division by a constant; PERF.md §6), so
    such a tie may break either way, and bf16 rows are independent;
  - quartet2: equal up to the first sampling step at which some sampled row
    of the reference has a top-2 logit margin under the caller's tolerance.
    Past that point the two may pick different tokens, and because the
    per-tensor activation absmax couples the rows of a batch, every later
    token of every row is then free to differ (tests/test_torch_model.py
    shows why quartet2 logits differ by up to ~0.17 between the packages).
"""

import jax
import numpy as np

from repro.serve import engine as jengine
from repro_torch.convert import params_from_jax
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine


BF16_TIE_ULPS = 2


def run_jax(jcfg, jparams, prompts, max_new, **econf):
    """Reference streams {req_id: tokens} plus, per (req_id, token index),
    (the sampling call that produced the token, the reference's top-2
    logit margin there, its top logit)."""
    res, margins, _ = run_jax_engine(jcfg, jparams, prompts, max_new, **econf)
    return res, margins


def run_jax_engine(jcfg, jparams, prompts, max_new, **econf):
    """`run_jax`, also returning the reference engine (its stats and
    cache after the run). Margins follow FIFO's prefill pick."""
    eng = jengine.ServeEngine(jcfg, jparams, jengine.EngineConfig(**econf))
    phase, calls, margins = [None], [0], {}
    for name in ("_prefill_tick", "_decode_tick"):
        def tick(_orig=getattr(eng, name), _name=name):
            phase[0] = _name
            return _orig()
        setattr(eng, name, tick)
    sample = eng._sample

    def recording_sample(last_logits):
        lf = np.asarray(last_logits, np.float32)
        if phase[0] == "_prefill_tick":  # the lowest-index prefilling slot
            rows = [min(i for i, s in enumerate(eng.slots)
                        if s.state == jengine.PREFILL)]
        else:
            rows = [i for i, s in enumerate(eng.slots)
                    if s.state == jengine.DECODE]
        for i in rows:
            top2 = np.sort(lf[i])[-2:]
            margins[(eng.slots[i].req.req_id, len(eng.slots[i].generated))] = (
                calls[0], float(top2[1] - top2[0]), float(top2[1]))
        calls[0] += 1
        return sample(last_logits)

    eng._sample = recording_sample
    for p in prompts:
        eng.submit(jengine.Request(p, max_new))
    res = {r.req_id: r.tokens for r in eng.run()}
    return res, margins, eng


def run_port(cfg, jparams, prompts, max_new, **econf):
    """The port's streams {req_id: tokens} on the CPU from the reference's
    parameters; every pool block is free at the end, or held by the prefix
    cache alone. Returns the engine too."""
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    eng = ServeEngine(cfg, params, EngineConfig(device="cpu", **econf))
    for p in prompts:
        eng.submit(Request(p, max_new))
    res = {r.req_id: r.tokens for r in eng.run()}
    held = eng.cache.cached_blocks() if eng.cache is not None else 0
    assert eng.pool.free_block_count + held == eng.pool.n_blocks
    assert not eng.has_work() and eng.stats["finished"] == len(prompts)
    return res, eng


def assert_equal_streams(got, want, n_requests, max_new):
    assert sorted(got) == sorted(want) == list(range(n_requests))
    for rid in want:
        assert len(got[rid]) == max_new
        assert got[rid] == want[rid], rid


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(abs(v), 2.0 ** -126))) - 7)


def assert_equal_up_to_bf16_ties(got, want, margins, n_requests, max_new):
    """bf16 greedy streams: each row equal up to its first reference tie
    (module docstring). Returns the number of tokens compared, which must
    be at least half of all."""
    assert sorted(got) == sorted(want) == list(range(n_requests))
    checked = 0
    for rid in want:
        assert len(got[rid]) == max_new
        for j in range(max_new):
            _, margin, top = margins[(rid, j)]
            if margin <= BF16_TIE_ULPS * _bf16_ulp(top):
                break
            assert got[rid][j] == want[rid][j], (rid, j)
            checked += 1
    assert checked >= n_requests * max_new // 2, checked
    return checked


def assert_equal_up_to_narrow_margin(got, want, margins, tol, max_new):
    """Tokens sampled before the first call with a reference margin < tol
    are equal; returns how many were checked (at least one)."""
    narrow = [c for c, m, _ in margins.values() if m < tol]
    horizon = min(narrow, default=float("inf"))
    checked = 0
    for (rid, j), (call, _, _) in margins.items():
        assert len(got[rid]) == max_new
        if call < horizon:
            assert got[rid][j] == want[rid][j], (rid, j)
            checked += 1
    assert checked >= 1  # the claim is not vacuous
    return checked
