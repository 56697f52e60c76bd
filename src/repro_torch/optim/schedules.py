"""LR schedules: cosine with warmup (paper Table 4) and WSD (nanochat Sec. 6.2).

Counterpart of `repro/optim/schedules.py`. Host-side: the learning rate of a
step is a Python float computed in float32 numpy arithmetic, in the
reference's order, so it is the f32 value the reference computes up to the
last ulp of `cos`.
"""

from __future__ import annotations

import numpy as np

_f = np.float32


def warmup_cosine(step, *, base_lr: float, total_steps: int,
                  warmup_frac: float = 0.1, final_frac: float = 0.0) -> float:
    warm = max(int(total_steps * warmup_frac), 1)
    s = _f(step)
    if s < warm:
        return float(_f(base_lr) * (s / _f(warm)))
    prog = np.clip((s - _f(warm)) / _f(max(total_steps - warm, 1)), _f(0), _f(1))
    cos = _f(final_frac) + _f((1 - final_frac) * 0.5) * (
        _f(1) + np.cos(_f(np.pi) * prog))
    return float(_f(base_lr) * cos)


def wsd(step, *, base_lr: float, total_steps: int, warmup_frac: float = 0.02,
        decay_frac: float = 0.2) -> float:
    """Warmup-Stable-Decay (MiniCPM): linear warmup, flat, linear decay tail."""
    warm = max(int(total_steps * warmup_frac), 1)
    decay_start = int(total_steps * (1 - decay_frac))
    s = _f(step)
    if s < warm:
        lr = s / _f(warm)
    elif s < decay_start:
        lr = _f(1)
    else:
        dec = _f(1) - (s - _f(decay_start)) / _f(max(total_steps - decay_start, 1))
        lr = np.clip(dec, _f(0), _f(1))
    return float(_f(base_lr) * lr)


def get(name: str):
    return {"cosine": warmup_cosine, "wsd": wsd}[name]
