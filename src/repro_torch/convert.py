"""Parameters of the JAX reference, as numpy arrays, into the port's layout.

`params_from_jax(numpy_tree, cfg)` takes a reference parameter pytree whose
leaves were turned into numpy arrays (`jax.tree.map(np.asarray, params)`)
and returns the port's dict-of-tensors tree: stacked stage leaves keep their
(count, ...) layout, MLA leaves (`wq_a` ... `wkv_b`, the two norms) and MoE
leaves (`router`, the (count, E, f, d) expert stacks, the shared expert),
rwkv6's (`mu`, the LoRAs `mix_w1`, `mix_w2` (count, 5, r, d), `ww1`,
`ww2`, `w0`, `u`, the group-norm gain `gn`, `cm_mu` and the projections)
and griffin's (`conv_w`, `conv_b`, `lam`, `wa`, `ba`, `wx`, `bx`, `w_in`,
`w_gate`, `w_out`) and whisper's (the layernorm gains and biases `g`, `b`;
the encoder under `stages`, the decoder's `dec_embed`, `dec_stages` with
each layer's cross-attention `xattn` and its norm `nx`, `dec_final_norm`,
`dec_head`) keep their names and shapes (an rwkv layer has no `ff`
subtree: its channel-mix lives under `mix`, as in the reference), and a
reference `PackedQWeight` (a NamedTuple
with `packed`, `scales8`, `gscale`; stacked expert weights pack to (count,
E, f, d/2)) becomes the port's `PackedQWeight`, its float8 scales carried
through their raw bits. Tests use it so both packages
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
