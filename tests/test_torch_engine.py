"""The port's ServeEngine against the JAX reference engine.

Both engines serve the same requests (more than there are slots, ragged
prompts, one prompt crossing a prefill-chunk boundary) with the same weights
(JAX init, converted) and the same FIFO / chunking schedule:
  - bf16: the greedy streams are equal;
  - quartet2: equal up to the first sampling step at which some sampled row
    of the reference has a top-2 logit margin under Q2_LOGIT_TOL. Past that
    point the two may pick different tokens, and because the per-tensor
    activation absmax couples the rows of a batch, every later token of every
    row is then free to differ (tests/test_torch_model.py shows why quartet2
    logits differ by up to ~0.17 between the packages). This random-init
    model's logits are nearly flat, so the narrow margin comes early: the
    claim covers the first sampled token here.
Also: every pool block is free at the end, and each option of the reference
engine that this slice does not port raises NotImplementedError.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
from repro_torch.serve.engine import (EngineConfig, QueueFull, Request,
                                      ServeEngine, Unservable)
from repro_torch.serve.sampling import SamplingParams

PROMPT_LENS = (19, 5, 11, 8, 3)
MAX_NEW = 6
Q2_LOGIT_TOL = 0.25
KW = dict(n_slots=2, max_len=48, prefill_chunk=8)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _prompts(vocab):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, n).tolist() for n in PROMPT_LENS]


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg = jregistry.get("llama_200m").reduced()
    return jcfg, jlm.init(jcfg, jax.random.PRNGKey(0))


def _run_jax(scheme):
    """Reference streams plus, per (req_id, token index), the sampling call
    that produced the token and the reference's top-2 margin there."""
    jcfg, jparams = _weights()
    eng = jengine.ServeEngine(jcfg, jparams,
                              jengine.EngineConfig(scheme=scheme, **KW))
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
                calls[0], float(top2[1] - top2[0]))
        calls[0] += 1
        return sample(last_logits)

    eng._sample = recording_sample
    for p in _prompts(jcfg.vocab):
        eng.submit(jengine.Request(p, MAX_NEW))
    res = {r.req_id: r.tokens for r in eng.run()}
    return res, margins


def _run_port(scheme):
    jcfg, jparams = _weights()
    cfg = registry.get("llama_200m").reduced()
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    eng = ServeEngine(cfg, params, EngineConfig(scheme=scheme, device="cpu",
                                                **KW))
    for p in _prompts(cfg.vocab):
        eng.submit(Request(p, MAX_NEW))
    res = {r.req_id: r.tokens for r in eng.run()}
    assert eng.pool.free_block_count == eng.pool.n_blocks
    assert not eng.has_work() and eng.stats["finished"] == len(PROMPT_LENS)
    return res


def test_bf16_greedy_streams_equal_jax():
    want, _ = _run_jax("bf16")
    got = _run_port("bf16")
    assert sorted(got) == sorted(want) == list(range(len(PROMPT_LENS)))
    for rid in want:
        assert len(got[rid]) == MAX_NEW
        assert got[rid] == want[rid], rid


def test_quartet2_streams_equal_jax_up_to_a_narrow_margin():
    want, margins = _run_jax("quartet2")
    got = _run_port("quartet2")
    narrow = [c for c, m in margins.values() if m < Q2_LOGIT_TOL]
    horizon = min(narrow, default=float("inf"))
    checked = 0
    for (rid, j), (call, _) in margins.items():
        assert len(got[rid]) == MAX_NEW
        if call < horizon:
            assert got[rid][j] == want[rid][j], (rid, j)
            checked += 1
    assert checked >= 1  # the claim is not vacuous


@pytest.mark.parametrize("option", [
    dict(spec_k=2), dict(prefix_cache=True),
    dict(prefix_spill=True), dict(mesh=object()), dict(role="prefill"),
    dict(kv_quant=True), dict(paged=False), dict(scheduler=object())])
def test_unported_options_raise(option):
    cfg = registry.get("llama_200m").reduced()
    with pytest.raises(NotImplementedError):
        ServeEngine(cfg, {}, EngineConfig(device="cpu", **option))


def test_admission_control_rejects():
    cfg = registry.get("llama_200m").reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(cfg, params, EngineConfig(device="cpu", max_queue=1, **KW))
    with pytest.raises(Unservable):
        eng.submit(Request([1] * 40, 9))       # 49 positions > max_len 48
    eng.submit(Request([1, 2, 3], 2))
    with pytest.raises(QueueFull):
        eng.submit(Request([4, 5], 2))          # the queue holds one
    assert eng.stats["rejected"] == 2
    (res,) = eng.run()
    assert len(res.tokens) == 2 and res.ttft_s >= 0


def test_launch_serve_entry_point_on_cpu(capsys):
    out = launch_serve.main(["--arch", "llama_200m", "--device", "cpu",
                             "--reduced", "--batch", "3", "--prompt-len", "20",
                             "--tokens", "4"])
    assert out["requests"] == 3 and out["device"] == "cpu"
    assert out["free_blocks"] == out["n_blocks"] and out["decode_tok_s"] > 0
    assert "[cpu] llama-200m-smoke quartet2" in capsys.readouterr().out


def test_stochastic_requests_follow_the_engine_seed():
    """Mixed greedy and sampled requests in one batch: a fixed base_seed
    replays the same streams, and the greedy request's stream does not
    depend on its neighbours' sampling (bf16: rows are independent; under
    quartet2 the per-tensor activation absmax couples them)."""
    cfg = registry.get("llama_200m").reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = _prompts(cfg.vocab)[:3]
    sampling = [SamplingParams(), SamplingParams(1.0, 5), SamplingParams(0.8)]

    def run(seed, sp):
        eng = ServeEngine(cfg, params, EngineConfig(
            device="cpu", base_seed=seed, scheme="bf16", **KW))
        for p, s in zip(prompts, sp):
            eng.submit(Request(p, MAX_NEW, s))
        return {r.req_id: r.tokens for r in eng.run()}

    a, b, c = run(7, sampling), run(7, sampling), run(8, sampling)
    assert a == b
    assert a[0] == c[0]  # greedy: the seed does not enter
    assert a != c        # sampled rows follow the seed
