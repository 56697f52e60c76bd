"""Device meshes over the ranks of the default process group.

Counterpart of `repro/launch/mesh.py`. A function, not a module constant,
so importing touches no device or group: call it after `dist.init`, on
every rank. `make_mesh` takes any factorization of the ranks
(checkpoints are mesh-independent, see `checkpoint/`);
`make_serve_mesh` is the (data, model) mesh of mesh-sharded serving, whose
engine comes with the sharded-serving slice.
"""

from __future__ import annotations

from torch.distributed.device_mesh import init_device_mesh


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda"):
    """A DeviceMesh of `shape` with dims named `axes` over the default
    group's ranks, in rank order."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_serve_mesh(data: int, model: int = 1, device_type: str = "cuda"):
    """(data, model) mesh for mesh-sharded serving: decode slots and the
    slot-affine pool over "data", packed weights over "model"."""
    return make_mesh((data, model), ("data", "model"), device_type)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's (data 16, model 16) pod of 256 chips (512 with
    `multi_pod`). It serves the dry-run cost model, whose slice decides how
    256 ranks are modelled without them; until then it raises."""
    raise NotImplementedError(
        "make_production_mesh: the 16 x 16 production mesh "
        f"({'512' if multi_pod else '256'} ranks) comes with the dry-run "
        "slice (launch/dryrun.py, ShapeCell/SHAPES; ROADMAP.md, Queue 1 "
        "item 4)")
