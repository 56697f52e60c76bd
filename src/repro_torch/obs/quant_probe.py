"""Sampled NVFP4 quantization-health probe.

Counterpart of `repro/obs/quant_probe.py` (not to be confused with
`tools/quant_probe.py`, the port's profiling tool). It taps the quantizers
the port's hot path uses on a rotating sample of weight sites and reports,
per site, the paper's Table 1 comparison live on the weights being trained:

  - relative quantization MSE (mean squared reconstruction error over the
    signal power) of the scheme's forward weight quantizer, of MS-EDEN and
    of plain SR, the last two reconstructed in the ORIGINAL space through
    the inverse rotation, as the reference does;
  - e4m3 group-scale saturation (the fraction of group scales at 448) and
    the element clip fraction (|x| beyond the FP4 grid reach of its group
    scale; MS-EDEN's s* clips ~0.7% of a Gaussian by design);
  - RHT outlier mass: the energy fraction of rotated elements beyond 4x the
    tensor's RMS.

The forward 4/6 goes through `ops.nvfp4_fos_quant` (kernel #1) and MS-EDEN
through `ops.ms_eden_requant` (kernels #3 and #4, the post-hoc MS-EDEN of
the port's backward, where the reference's probe runs the direct
Algorithm 1), so on the card the probe launches them; SR has no kernel in
either package and stays plain PyTorch, as do the other forward quantizers
(rtn, square).

Draws: no threefry. Site j of a call at `step` draws from
`HashDraws(train_step.step_seed(base_seed, step, j))`: the RHT signs from
tag 0, MS-EDEN's SR uniforms from tag 1 (as a key pair, hashed in phase 2)
and plain SR's element uniforms from tag 2.

Overhead: the probe runs at the host step boundary (`Trainer` calls it
every `every_n` steps) and synchronizes with the host once per call, to
read every site's scalars. `every_n = 0` (the default) never samples by
itself; explicit `probe_params` calls still probe.

Site sampling is deterministic, as the reference's: sites sort by path and
rotate with the step, so a run and a resumed run probe the same (site,
layer) choices.
"""

from __future__ import annotations

import torch

from repro_torch.core import formats as F
from repro_torch.core import quant as Q
from repro_torch.core import rht as R
from repro_torch.core import schemes as S
from repro_torch.core.linear import PackedQWeight
from repro_torch.core.rng import HashDraws
from repro_torch.kernels import fp4_matmul as FM
from repro_torch.kernels import ops
from repro_torch.obs.metrics import MetricsRegistry, default_registry
from repro_torch.serve.prequant import QUANT_KEYS
from repro_torch.train.train_step import step_seed

_RHT_TAG, _EDEN_TAG, _SR_TAG = 0, 1, 2


def _unpacked(codes, scale_bits, gscale):
    """(reconstruction, group scales, gscale) of a packed NVFP4 image."""
    rec = FM.block_values(codes, scale_bits) * gscale
    return rec, F.bits_to_e4m3(scale_bits), gscale


def _fos(x):
    return _unpacked(*ops.nvfp4_fos_quant(x))


def _plain(quantizer):
    def quant(x):
        qt = quantizer(x)
        return Q.dequant(qt), qt.scales, qt.gscale
    return quant


#: forward weight-quantizer kinds (core/schemes.py fwd_w) -> quantizer
#: returning (reconstruction, group scales, gscale); the reference's table
#: (its `quant_rtn` with default arguments)
_FWD = {
    "rtn": _plain(Q.quant_rtn),
    "fos": _fos,
    "square": _plain(Q.quant_square_block),
}


def _mse_rel(x, rec):
    return ((rec - x) ** 2).mean() / ((x * x).mean() + 1e-30)


def _sat_clip(x, scales, gscale):
    """(fraction of the group scales at the E4M3 max, fraction of the
    elements of x beyond the FP4 grid reach of their group scale), both in
    the quantizer's own space."""
    denom = torch.repeat_interleave(scales, F.GROUP, dim=-1) * gscale
    clipped = (x.abs() > F.FP4_MAX * denom) & (denom > 0)
    return (scales >= F.FP8_MAX).float().mean(), clipped.float().mean()


def _health(w: torch.Tensor, draws: HashDraws, fwd_kind: str) -> dict:
    """Every health scalar of one 2-D site, as 0-d device tensors."""
    x = w.float().contiguous()
    out = {}
    if fwd_kind != "none":
        rec, scales, g = _FWD[fwd_kind](x)
        out["fwd_mse_rel"] = _mse_rel(x, rec)
        out["fwd_scale_sat_frac"], out["fwd_clip_frac"] = _sat_clip(x, scales, g)
    signs = draws.signs(_RHT_TAG, R.block_size(x.shape[-1]), x.device)
    x_rot = R.rht(x, signs)
    rec, scales, g = _unpacked(*ops.ms_eden_requant(x, signs,
                                                    draws.keys(_EDEN_TAG)))
    out["ms_eden_mse_rel"] = _mse_rel(x, R.rht_inv(rec, signs))
    out["ms_eden_scale_sat_frac"], out["ms_eden_clip_frac"] = _sat_clip(
        x_rot, scales, g)
    qs = Q.quant_sr(x_rot, draws.uniform(_SR_TAG, x_rot.shape, x.device))
    out["sr_mse_rel"] = _mse_rel(x, R.rht_inv(Q.dequant(qs), signs))
    out["sr_scale_sat_frac"], out["sr_clip_frac"] = _sat_clip(
        x_rot, qs.scales, qs.gscale)
    energy = x_rot * x_rot
    rms = torch.sqrt(energy.mean() + 1e-30)
    out["rht_outlier_mass"] = (
        torch.where(x_rot.abs() > 4.0 * rms, energy, 0.0).sum()
        / (energy.sum() + 1e-30))
    return out


def _name(path) -> str:
    """A site's name as the reference spells its tree path: dict keys as
    they are, list indices as `[i]`."""
    return "/".join(f"[{k}]" if isinstance(k, int) else str(k) for k in path)


class QuantProbe:
    """Rotating-sample quantization-health tap over a params tree.

    `every_n = 0` (default): never samples by itself (`should_sample` is
    False); explicit `probe_params` calls still probe."""

    def __init__(self, scheme: str = "quartet2", every_n: int = 0,
                 max_sites: int = 8, base_seed: int = 0,
                 registry: MetricsRegistry | None = None):
        self.scheme = scheme
        self.fwd_kind = S.get(scheme).fwd_w
        self.every_n = every_n
        self.max_sites = max_sites
        self.base_seed = base_seed
        self.registry = registry if registry is not None else default_registry()
        labels = ("site", "phase", "quantizer")
        self._mse = self.registry.gauge(
            "nvfp4_quant_mse_rel",
            "relative quantization MSE at a sampled weight site", labels)
        self._sat = self.registry.gauge(
            "nvfp4_scale_saturation_frac",
            "fraction of e4m3 group scales at the E4M3 max", labels)
        self._clip = self.registry.gauge(
            "nvfp4_clip_frac",
            "fraction of elements beyond their group's FP4 reach", labels)
        self._outlier = self.registry.gauge(
            "nvfp4_rht_outlier_mass",
            "post-RHT energy fraction beyond 4x RMS", ("site", "phase"))
        self._samples = self.registry.counter(
            "nvfp4_probe_samples_total", "per-site probe evaluations",
            ("phase",))

    def should_sample(self, step: int) -> bool:
        return self.every_n > 0 and step % self.every_n == 0

    # ---- site discovery --------------------------------------------------

    @staticmethod
    def sites(params) -> list[tuple[str, torch.Tensor]]:
        """Deterministic (path, leaf) list of quantized weight sites: the
        QUANT_KEYS leaves of `serve/prequant.py`, 2-D or stacked, raw
        tensors only (no PackedQWeight), sorted by path."""
        tree = params.get("stages", params) if isinstance(params, dict) else params
        found = []

        def visit(path, t):
            if isinstance(t, PackedQWeight):
                return
            if isinstance(t, dict):
                for k, v in t.items():
                    visit((*path, k), v)
            elif isinstance(t, (list, tuple)):
                for i, v in enumerate(t):
                    visit((*path, i), v)
            elif (isinstance(t, torch.Tensor) and t.dim() >= 2 and path
                  and str(path[-1]) in QUANT_KEYS):
                found.append((_name(path), t))

        visit((), tree)
        found.sort(key=lambda kv: kv[0])
        return found

    # ---- probing ---------------------------------------------------------

    @torch.no_grad()
    def probe_params(self, params, step: int = 0, phase: str = "train") -> dict:
        """Probe up to `max_sites` sites (rotating with `step`), record the
        gauges, and return {site: {metric: float}}. One host sync."""
        sites = self.sites(params)
        if not sites:
            return {}
        k = min(self.max_sites, len(sites))
        period = max(self.every_n, 1)
        start = ((step // period) * k) % len(sites)
        pending = {}
        for j in range(k):
            name, leaf = sites[(start + j) % len(sites)]
            if leaf.shape[-1] % F.GROUP:
                continue  # not NVFP4-groupable; qlinear pads, the probe skips
            mat = leaf
            if leaf.dim() > 2:
                flat = leaf.reshape(-1, *leaf.shape[-2:])
                mat = flat[(step // period + j) % flat.shape[0]]
            draws = HashDraws(step_seed(self.base_seed, step, j))
            pending[name] = _health(mat, draws, self.fwd_kind)
        if not pending:
            return {}
        # sites and their metrics sorted by name, as the reference's
        # device_get of a dict returns them
        keys = [(n, m) for n in sorted(pending) for m in sorted(pending[n])]
        flat = torch.stack([pending[n][m] for n, m in keys]).tolist()  # the sync
        results: dict = {n: {} for n in sorted(pending)}
        for (n, m), v in zip(keys, flat):
            results[n][m] = v
        for name, out in results.items():
            for metric, v in out.items():
                if metric == "rht_outlier_mass":
                    self._outlier.labels(site=name, phase=phase).set(v)
                    continue
                quantizer, field = metric.split("_", 1)
                if quantizer == "ms":  # ms_eden_*
                    quantizer, field = "ms_eden", metric[len("ms_eden_"):]
                gauge = {"mse_rel": self._mse,
                         "scale_sat_frac": self._sat,
                         "clip_frac": self._clip}[field]
                gauge.labels(site=name, phase=phase, quantizer=quantizer).set(v)
            self._samples.labels(phase=phase).inc()
        return results
