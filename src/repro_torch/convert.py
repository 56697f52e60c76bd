"""Parameters of the JAX reference, as numpy arrays, into the port's layout.

`params_from_jax(numpy_tree, cfg)` takes a reference parameter pytree whose
leaves were turned into numpy arrays (`jax.tree.map(np.asarray, params)`)
and returns the port's dict-of-tensors tree: stacked stage leaves keep their
(count, ...) layout, and a reference `PackedQWeight` (a NamedTuple with
`packed`, `scales8`, `gscale`) becomes the port's `PackedQWeight`, its
float8 scales carried through their raw bits. Tests use it so both packages
compute with the same weights; this module never imports the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.linear import PackedQWeight
from repro_torch.models import lm


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.itemsize == 1 and a.dtype.kind not in "iub":
        a = a.view(np.uint8)  # float8 scales: raw e4m3 bits
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return [_convert(v, device) for v in tree]
    if all(hasattr(tree, f) for f in ("packed", "scales8", "gscale")):
        return PackedQWeight(_tensor(tree.packed, device),
                             _tensor(tree.scales8, device),
                             _tensor(tree.gscale, device))
    return _tensor(tree, device)


def params_from_jax(tree, cfg: ArchConfig, device="cuda") -> dict:
    """Reference parameters (numpy leaves) -> the port's parameter tree."""
    lm.layer_specs(cfg)  # raises for families this slice does not serve
    return _convert(tree, device)
