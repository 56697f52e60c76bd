"""Sharding rules: parameter, optimizer-state, cache and input partition specs
for a (data, model) mesh, and the DTensor placements they give.

Counterpart of `repro/dist/sharding.py`. The pure rules are the reference's,
line for line; a spec is a tuple with one entry per dim, a mesh axis name
("data", "model") or None, so it compares with a `PartitionSpec` by
`tuple(spec)`:

  - 1D params (norm gains, biases, lambdas) replicate;
  - router weights replicate (fp32, tiny, bias-sensitive);
  - 2D weights put the out-dim on "model" when divisible, else try the
    in-dim; the in-dim also goes to "data" under FSDP (ZeRO-3 style);
  - stacked layer params never shard the leading (layers) axis;
  - 4D expert stacks (L, E, f, d) put experts on "model" and, under FSDP,
    the trailing in-dim on "data";
  - decode caches shard batch over "data" and the trailing feature axis over
    "model"; the sequence axis stays whole.

An axis is assigned only where its size divides the dim. Serving splits the
same mesh differently (`serve_*`): every cache leaf's axis 1 (the physical
block axis, or the slot axis) over "data" (`serve_shard_sizes` gives the
slot-affine pool its per-shard extents); a `PackedQWeight`'s out-feature
axis over "model", field by field, its per-matrix `gscale` replicated; raw
serving leaves take `param_spec` with fsdp off. `split_serve_params` cuts a
serving tree by those specs into one tree per (data, model) device, as the
in-process engine serves it.

The tree builders walk a tree of dicts, lists and NamedTuples; a leaf's path
is the reference's `_path_str` (keys and field names joined by "/", list
indices as numbers), which the rules match substrings of. They return, leaf
for leaf, the DTensor placements of the leaf's spec on a
`torch.distributed.device_mesh.DeviceMesh` (one `Shard(dim)` or
`Replicate()` per mesh dim, in the mesh's dim order); `distribute` places a
tree by them. A Python int (a step counter) maps to None and stays as it is.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.core.linear import ModelShard, PackedQWeight

_REPLICATED_TOKENS = ("router", "norm", "/n1", "/n2", "/nx", "gn", "mu",
                      "lam", "bias", "/ba", "/bx", "conv_b")


def _div(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def param_spec(path: str, shape: tuple[int, ...], *, model: int, data: int,
               fsdp: bool) -> tuple:
    """The spec of one parameter leaf addressed by `path`."""
    axes: list = [None] * len(shape)
    if len(shape) <= 1 or any(t in path for t in _REPLICATED_TOKENS):
        return tuple(axes)

    if len(shape) == 4:
        # stacked expert weights (L, E, f, d): experts -> model (EP)
        if _div(shape[1], model):
            axes[1] = "model"
        if fsdp and _div(shape[3], data):
            axes[3] = "data"
        return tuple(axes)

    # trailing (out, in) matrix; a leading stacked axis (if 3D) stays None
    o, i = len(shape) - 2, len(shape) - 1
    if _div(shape[o], model):
        axes[o] = "model"
    elif _div(shape[i], model):
        axes[i] = "model"
    if fsdp and axes[i] is None and _div(shape[i], data):
        axes[i] = "data"
    return tuple(axes)


def cache_spec(kind: str, shape: tuple[int, ...], *, model: int, data: int
               ) -> tuple:
    """A decode-cache leaf's spec; layout (L, B, S?, ..., feature): batch
    (axis 1) over data, the feature axis over model for leaves of >= 4
    dims."""
    axes: list = [None] * len(shape)
    if len(shape) >= 2 and _div(shape[1], data):
        axes[1] = "data"
    if len(shape) >= 4 and _div(shape[-1], model):
        axes[-1] = "model"
    return tuple(axes)


# every serving-cache leaf splits its axis-1 slot or block home over "data"
SERVE_CACHE_SPEC = (None, "data")


def serve_shard_sizes(n_slots: int, n_blocks: int, data: int
                      ) -> tuple[int, int]:
    """(slots, blocks) of one data shard of a serving pool cut by
    SERVE_CACHE_SPEC: slot leaves and block leaves split their axis 1 into
    `data` equal contiguous ranges, so shard s homes slots [s*S/data,
    (s+1)*S/data) and blocks [s*N/data, (s+1)*N/data). Equal extents keep
    the slot split aligned with the block homes; anything else raises."""
    if data < 1 or n_slots % data or n_blocks % data:
        raise ValueError(
            f"n_shards={data} must divide both n_slots={n_slots} and "
            f"n_blocks={n_blocks} (equal shard extents keep the slot split "
            "aligned with the block homes)")
    return n_slots // data, n_blocks // data


def packed_weight_spec(shape: tuple[int, ...], *, model: int) -> tuple:
    """The spec of one field of a PackedQWeight: `packed` (..., N, K/2) and
    `scale_bits` (..., N, K/16) shard the out-feature axis N over "model";
    the per-matrix `gscale` (...,) replicates; leading stacked axes never
    shard."""
    axes: list = [None] * len(shape)
    if len(shape) >= 2 and _div(shape[-2], model):
        axes[-2] = "model"
    return tuple(axes)


# --------------------------------------------------------------------------
# trees and meshes
# --------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def map_with_path(fn, tree, path: str = "", is_leaf=None):
    """`tree` with each leaf x replaced by fn(path_str, x)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree)
    join = (lambda k: f"{path}/{k}") if path else str
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, join(k), is_leaf)
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, v, join(f), is_leaf)
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, join(i), is_leaf)
                          for i, v in enumerate(tree))
    return fn(path, tree)


def mesh_sizes(mesh) -> tuple[int, int]:
    """(model, data) sizes of a mesh; an axis it lacks counts 1."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return sizes.get("model", 1), sizes.get("data", 1)


def placements(spec: tuple, mesh) -> tuple:
    """The DTensor placements of `spec` on `mesh`: for each mesh dim,
    Shard(d) where the spec names it at dim d, else Replicate()."""
    return tuple(Shard(spec.index(name)) if name in spec else Replicate()
                 for name in mesh.mesh_dim_names)


def _leaf_placements(spec_of, mesh):
    def one(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return None
        return placements(spec_of(path, tuple(leaf.shape)), mesh)
    return one


def state_shardings(state, mesh, *, fsdp: bool):
    """Placements for a params tree or a train state, by `param_spec` on the
    reference's paths. The port's optimizer moments are lists aligned with
    the params leaves; entry i of such a list at path P takes the path
    "P/<path of leaf i>", as the reference's moment trees give it (so
    "opt/mu/..." replicates by the "mu" token, as in the reference)."""
    model, data = mesh_sizes(mesh)
    one = _leaf_placements(lambda p, s: param_spec(
        p, s, model=model, data=data, fsdp=fsdp), mesh)
    params = state.params if hasattr(state, "params") else state
    names = [p for p, _ in leaf_paths(params)]

    def aligned(v) -> bool:
        return (isinstance(v, list) and len(v) == len(names)
                and all(isinstance(t, torch.Tensor) for t in v))

    def walk(path, x):
        if aligned(x):
            return [one(f"{path}/{n}", t) for n, t in zip(names, x)]
        return one(path, x)

    return map_with_path(walk, state, is_leaf=aligned)


def leaf_paths(tree) -> list:
    """(path, leaf) of every leaf of `tree`, in walk (insertion) order."""
    out = []
    map_with_path(lambda p, x: out.append((p, x)), tree)
    return out


def cache_shardings(cache, mesh):
    """Placements for a decode-cache tree; a leaf's kind is the last
    component of its path."""
    model, data = mesh_sizes(mesh)
    return map_with_path(_leaf_placements(lambda p, s: cache_spec(
        p.rsplit("/", 1)[-1], s, model=model, data=data), mesh), cache)


def input_shardings(batch, mesh):
    """Token, label and embed inputs: the batch axis over data, the rest
    replicated."""
    _, data = mesh_sizes(mesh)

    def spec(_, shape):
        axes: list = [None] * len(shape)
        if len(shape) >= 1 and _div(shape[0], data):
            axes[0] = "data"
        return tuple(axes)

    return map_with_path(_leaf_placements(spec, mesh), batch)


def serve_param_specs(params, mesh):
    """The specs of a serving params tree (prequantized or raw), leaf for
    leaf: PackedQWeight fields by `packed_weight_spec`, raw leaves by
    `param_spec` with fsdp off, so weights never split over "data"."""
    model, _ = mesh_sizes(mesh)

    def one(path, leaf):
        if isinstance(leaf, PackedQWeight):
            return PackedQWeight(*(packed_weight_spec(tuple(f.shape),
                                                      model=model)
                                   for f in leaf))
        return param_spec(path, tuple(leaf.shape), model=model, data=1,
                          fsdp=False)

    return map_with_path(one, params,
                         is_leaf=lambda x: isinstance(x, PackedQWeight))


def serve_param_shardings(params, mesh):
    """Placements for a serving params tree by `serve_param_specs`."""
    def one(_, spec):
        if isinstance(spec, PackedQWeight):
            return PackedQWeight(*(placements(s, mesh) for s in spec))
        return placements(spec, mesh)

    return map_with_path(one, serve_param_specs(params, mesh),
                         is_leaf=lambda x: isinstance(x, (PackedQWeight, tuple)))


# leaves the dense decode path reads as linear weights (`qlinear`, `dense`)
# or as the embedding table: the ones a split over "model" reaches
SPLIT_LINEAR_KEYS = frozenset({"wq", "wk", "wv", "wo", "wi", "wg", "embed",
                               "head"})


def _part(t: torch.Tensor, axis: int, rank: int, parts: int, device):
    """Part `rank` of `parts` equal parts of t along `axis`, copied into
    storage of its own on `device`."""
    n = t.shape[axis] // parts
    src = t.narrow(axis, rank * n, n)
    out = torch.empty(src.shape, dtype=t.dtype, device=device)
    out.copy_(src)
    return out


def split_serve_params(params, mesh) -> list:
    """A serving params tree (prequantized or raw) cut by
    `serve_param_specs` into one tree per data shard: `out[s]` is data
    shard s's tree, its model rank j's parts on `mesh.grid[s][j]`.

    A PackedQWeight whose spec splits N becomes a `ModelShard` of its ranks'
    rows of `packed` and `scale_bits` (each byte for byte that slice of the
    whole field), each with the whole matrix's `gscale`. A raw linear weight
    or the embedding table (SPLIT_LINEAR_KEYS) whose `param_spec` (fsdp
    off) names "model" becomes a ModelShard of its ranks' parts along that
    axis. Every other leaf is held whole on the shard's first device, where
    the rest of the step runs: replicated by its spec, or (a stacked QK-norm
    gain the spec would cut on its layer axis) read whole where GSPMD would
    gather it. Each part has storage of its own, so a device holds its share
    of the split bytes only; data shards on the same devices share a tree."""
    model, _ = mesh_sizes(mesh)
    specs = []
    map_with_path(lambda _, s: specs.append(s), serve_param_specs(params, mesh),
                  is_leaf=lambda x: isinstance(x, (PackedQWeight, tuple)))

    def one_tree(row):
        it = iter(specs)

        def one(path, leaf):
            spec = next(it)
            if isinstance(leaf, PackedQWeight):
                if "model" not in spec[0]:
                    return PackedQWeight(*(f.to(row[0]) for f in leaf))
                axis = spec[0].index("model")
                return ModelShard(tuple(PackedQWeight(
                    _part(leaf.packed, axis, j, model, dev),
                    _part(leaf.scale_bits, axis, j, model, dev),
                    leaf.gscale.to(dev)) for j, dev in enumerate(row)),
                    axis - leaf.packed.dim())
            if "model" not in spec or path.rsplit("/", 1)[-1] \
                    not in SPLIT_LINEAR_KEYS:
                return leaf.to(row[0])
            axis = spec.index("model")
            return ModelShard(tuple(_part(leaf, axis, j, model, dev)
                                    for j, dev in enumerate(row)),
                              axis - leaf.dim())
        return map_with_path(one, params,
                             is_leaf=lambda x: isinstance(x, PackedQWeight))

    made: dict = {}
    for row in mesh.grid:
        if row not in made:
            made[row] = one_tree(row)
    return [made[row] for row in mesh.grid]


def packed_bytes(tree, rank: int | None = None) -> int:
    """The bytes of the PackedQWeight fields of `tree`, each storage counted
    once: all of them, or those model rank `rank`'s device holds (part
    `rank` of each ModelShard, and with rank 0, the shard's first device,
    every unsplit PackedQWeight)."""
    seen, total = set(), 0

    def one(_, leaf):
        nonlocal total
        if isinstance(leaf, ModelShard):
            ws = leaf.parts if rank is None else (leaf.parts[rank],)
        else:
            ws = (leaf,) if rank in (None, 0) else ()
        for w in ws:
            if not isinstance(w, PackedQWeight):
                continue
            for f in w:
                key = (f.device, f.untyped_storage().data_ptr())
                if key not in seen:
                    seen.add(key)
                    total += f.untyped_storage().nbytes()
    map_with_path(one, tree, is_leaf=lambda x: isinstance(
        x, (PackedQWeight, ModelShard)))
    return total


def serve_cache_shardings(cache, mesh):
    """Placements putting every serving-cache leaf on SERVE_CACHE_SPEC."""
    return map_with_path(_leaf_placements(
        lambda p, s: SERVE_CACHE_SPEC + (None,) * (len(s) - 2), mesh), cache)


def distribute(tree, mesh, placement_tree):
    """`tree` with each tensor leaf made a DTensor on `mesh` by its
    placements (`distribute_tensor`: every rank passes the same full
    tensor); leaves whose placements are None stay as they are."""
    flat_p = []
    map_with_path(lambda p, x: flat_p.append(x), placement_tree,
                  is_leaf=lambda x: x is None or (isinstance(x, tuple) and all(
                      isinstance(e, (Shard, Replicate)) for e in x)))
    it = iter(flat_p)

    def one(_, leaf):
        pl = next(it)
        return leaf if pl is None else distribute_tensor(leaf, mesh, list(pl))

    return map_with_path(one, tree)
