"""The port's quantization-health probe (`obs/quant_probe.py`) and its
metrics registry (`obs/metrics.py`) against the JAX reference's, on the
nanochat model at reduced size (llama-200m's smoke config with QK-norm and
ReLU^2) with the same weights.

Tolerances:
- sites, their order and rotation with the step (which sites, which layer
  of a stacked leaf): identical.
- the forward 4/6 metrics (deterministic: the same quantizer on the same
  matrix): within 1e-6 relative (the f32 means sum in another order;
  measured equal to the printed digits).
- the MS-EDEN and SR metrics (stochastic, and the port's MS-EDEN is the
  post-hoc composition of its kernels where the reference's probe runs the
  direct Algorithm 1): per site and metric, the port's mean over 8 base
  seeds within the range the reference's 8 values span, widened by that
  range's own width.
- the registry: the same metric families, types, help texts and label sets
  (series), in the same order.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.obs.quant_probe import QuantProbe as JProbe
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.quant_probe import QuantProbe

OVER = dict(qk_norm=True, mlp="relu2")
SEEDS = range(8)
STOCHASTIC = ("ms_eden_", "sr_", "rht_outlier_mass")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _params():
    cfg = dataclasses.replace(jregistry.get("llama_200m").reduced(), **OVER)
    tcfg = dataclasses.replace(registry.get("llama_200m").reduced(), **OVER)
    jp = jlm.init(cfg, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def test_sites_and_rotation_match_jax():
    jp, tp = _params()
    assert [n for n, _ in QuantProbe.sites(tp)] == [n for n, _ in JProbe.sites(jp)]
    assert [tuple(t.shape) for _, t in QuantProbe.sites(tp)] == \
        [tuple(a.shape) for _, a in JProbe.sites(jp)]
    jprobe = JProbe(every_n=2, max_sites=4, registry=JRegistry())
    probe = QuantProbe(every_n=2, max_sites=4, registry=MetricsRegistry())
    assert [probe.should_sample(s) for s in range(5)] == \
        [jprobe.should_sample(s) for s in range(5)] == [True, False] * 2 + [True]
    for step in (0, 2, 4, 6):
        want = jprobe.probe_params(jp, step=step)
        got = probe.probe_params(tp, step=step)
        assert list(got) == list(want)
        for site in want:  # the same matrix: the deterministic metrics agree
            assert list(got[site]) == list(want[site])
            for m in ("fwd_mse_rel", "fwd_scale_sat_frac", "fwd_clip_frac"):
                assert got[site][m] == pytest.approx(want[site][m], rel=1e-6,
                                                     abs=1e-12), (step, site, m)


def test_stochastic_metrics_within_reference_spread():
    jp, tp = _params()
    ref, port = {}, {}
    for seed in SEEDS:
        for out, res in (
                (ref, JProbe(max_sites=3, base_seed=seed,
                             registry=JRegistry()).probe_params(jp, step=1)),
                (port, QuantProbe(max_sites=3, base_seed=seed,
                                  registry=MetricsRegistry()).probe_params(tp, step=1))):
            for site, vals in res.items():
                for m, v in vals.items():
                    if m.startswith(STOCHASTIC):
                        out.setdefault((site, m), []).append(v)
    assert ref.keys() == port.keys() and len(ref) == 3 * 7
    for key, vals in ref.items():
        lo, hi = min(vals), max(vals)
        mean = float(np.mean(port[key]))
        assert lo - (hi - lo) <= mean <= hi + (hi - lo), (key, vals, port[key])
    # the paper's Table 1 ordering, live: MS-EDEN's error under half of SR's
    for site in {s for s, _ in ref}:
        assert 2 * np.mean(port[site, "ms_eden_mse_rel"]) <= np.mean(port[site, "sr_mse_rel"])


def test_registry_series_match_jax():
    jp, tp = _params()
    jreg, reg = JRegistry(), MetricsRegistry()
    JProbe(every_n=1, max_sites=3, registry=jreg).probe_params(jp, step=3)
    JProbe(every_n=1, max_sites=3, registry=jreg).probe_params(jp, step=0,
                                                               phase="prequant")
    QuantProbe(every_n=1, max_sites=3, registry=reg).probe_params(tp, step=3)
    QuantProbe(every_n=1, max_sites=3, registry=reg).probe_params(tp, step=0,
                                                                  phase="prequant")

    def shape(snap):
        return [(name, fam["type"], fam["help"], [s["labels"] for s in fam["series"]])
                for name, fam in snap.items()]

    assert shape(reg.snapshot()) == shape(jreg.snapshot())
    names = lambda text: [ln.rsplit(" ", 1)[0] for ln in text.splitlines()]
    assert names(reg.to_prometheus()) == names(jreg.to_prometheus())
    assert reg.value("nvfp4_probe_samples_total", phase="train") == 3
