"""The port's ServeEngine against the JAX reference engine.

Both engines serve the same requests (more than there are slots, ragged
prompts, one prompt crossing a prefill-chunk boundary) with the same weights
(JAX init, converted) and the same FIFO / chunking schedule
(`tests/_torch_streams.py`):
  - bf16: the greedy streams are equal;
  - quartet2: equal up to the first sampling step at which some sampled row
    of the reference has a top-2 logit margin under Q2_LOGIT_TOL. This
    random-init model's logits are nearly flat, so the narrow margin comes
    early: the claim covers the first sampled token here.
Also: every pool block is free at the end, each option of the reference
engine that the port does not have yet raises NotImplementedError, and
`kv_quant=True` builds the NVFP4 pool.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from _torch_streams import (assert_equal_streams,
                            assert_equal_up_to_narrow_margin, run_jax,
                            run_port)
from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro_torch.configs import registry
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models import lm
from repro_torch.serve.engine import (EngineConfig, QueueFull, Request,
                                      ServeEngine, Unservable)
from repro_torch.serve.kv_pool import PackedKV
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
    jcfg, jparams = _weights()
    return run_jax(jcfg, jparams, _prompts(jcfg.vocab), MAX_NEW,
                   scheme=scheme, **KW)


def _run_port(scheme):
    jcfg, jparams = _weights()
    cfg = registry.get("llama_200m").reduced()
    return run_port(cfg, jparams, _prompts(cfg.vocab), MAX_NEW,
                    scheme=scheme, **KW)[0]


def test_bf16_greedy_streams_equal_jax():
    want, _ = _run_jax("bf16")
    got = _run_port("bf16")
    assert_equal_streams(got, want, len(PROMPT_LENS), MAX_NEW)


def test_quartet2_streams_equal_jax_up_to_a_narrow_margin():
    want, margins = _run_jax("quartet2")
    got = _run_port("quartet2")
    assert_equal_up_to_narrow_margin(got, want, margins, Q2_LOGIT_TOL, MAX_NEW)


@pytest.mark.parametrize("option", [
    dict(arch="deepseek_v3_671b", data=1), dict(arch="deepseek_moe_16b", data=2)])
def test_unported_options_raise(option):
    """Serving MLA or MoE over a "model" axis > 1 is ROADMAP.md's Queue 1
    item 4.6 (the dense GQA families serve over it, and every family over
    "data": test_torch_serve_model.py, test_torch_serve_sharded.py)."""
    cfg = registry.get(option["arch"]).reduced()
    mesh = make_serve_mesh(option["data"], 2, devices=["cpu"] * 2 * option["data"])
    with pytest.raises(NotImplementedError, match="4.6"):
        ServeEngine(cfg, {}, EngineConfig(device="cpu", n_slots=4, mesh=mesh))


def test_kv_quant_builds_a_quantized_pool():
    """kv_quant=True (ported now) builds the NVFP4 pool: every token leaf
    a PackedKV of uint8 codes and scale bits at 0.28125x the bf16 bytes;
    the engine serves from it and frees every block."""
    cfg = registry.get("llama_200m").reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(cfg, params, EngineConfig(device="cpu", kv_quant=True,
                                                **KW))
    bf16 = ServeEngine(cfg, params, EngineConfig(device="cpu", **KW))
    assert eng.pool.quantized and not bf16.pool.quantized
    k, v = eng.pool.caches[0]["l0"]["kv"]
    assert isinstance(k, PackedKV) and isinstance(v, PackedKV)
    assert all(t.dtype == torch.uint8 for t in (*k, *v))
    kb, vb = bf16.pool.caches[0]["l0"]["kv"]
    packed = sum(t.numel() for t in (*k, *v))
    assert packed / (kb.numel() * 2 + vb.numel() * 2) == 0.28125
    eng.submit(Request([1, 2, 3, 4, 5], 3))
    (res,) = eng.run()
    assert len(res.tokens) == 3
    assert eng.pool.free_block_count == eng.pool.n_blocks


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
