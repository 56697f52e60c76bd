"""Device meshes: over the ranks of a process group, and for serving.

Counterpart of `repro/launch/mesh.py`. Functions, not module constants, so
importing touches no device or group.

  - `make_mesh` is a DeviceMesh over the default group's ranks (call it
    after `dist.init`, on every rank): any factorization of the ranks, for
    data-parallel training (checkpoints are mesh-independent, see
    `checkpoint/`).
  - `make_serve_mesh` is the (data, model) mesh of mesh-sharded serving,
    held by ONE process: the reference's serving engine is one host program
    over every shard (`shard_map` manual over "data" inside one process,
    GSPMD over "model"), and so is the port's. It names data x model
    devices in (data, model) order: `mesh.grid[s]` are data shard s's model
    devices, and `mesh.devices[s]` (its first) homes the shard's slots and
    slot-affine pool and runs the shard's step; the shard's split linears
    run each part on its model device. CUDA launches are asynchronous per
    device, so one host thread drives every device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.distributed.device_mesh import init_device_mesh


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda"):
    """A DeviceMesh of `shape` with dims named `axes` over the default
    group's ranks, in rank order."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


@dataclass(frozen=True)
class ServeMesh:
    """An in-process (data, model) serving mesh: its sizes, its dim names
    and its devices, `grid[s][j]` the device of data shard s and model rank
    j. `devices` holds each data shard's first model device, where its
    slots, pool and outputs live. `shape` and `mesh_dim_names` read as a
    DeviceMesh's do (`dist.sharding.mesh_sizes`)."""

    data: int
    model: int
    grid: tuple[tuple[torch.device, ...], ...]

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return tuple(row[0] for row in self.grid)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.data, self.model)

    @property
    def mesh_dim_names(self) -> tuple[str, str]:
        return ("data", "model")


def _resolved(d) -> torch.device:
    """`d` as a torch.device with its card index ("cuda" is the current
    card), so that two names of one card compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_serve_mesh(data: int, model: int = 1, *, devices=None) -> ServeMesh:
    """The (data, model) mesh of mesh-sharded serving: decode slots and the
    slot-affine KV pool split over "data"; each linear weight's out-features
    split over "model" (`dist.sharding.split_serve_params`), the rest of a
    data shard's step on its first model device.

    `devices` lists data x model devices in (data, model) order: data shard
    s takes devices[s * model:(s + 1) * model]. `devices=None` puts them on
    cards 0 .. data x model - 1 and needs that many cards: fewer raises.
    Devices share a card only when asked for by name (`devices=["cuda:0"] *
    4`; the CPU tests pass `["cpu"] * 4`). Nothing falls back to the CPU or
    to fewer shards."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh sizes must be >= 1, got data={data}, "
                         f"model={model}")
    if devices is None:
        cards = torch.cuda.device_count()
        if cards < data * model:
            raise ValueError(
                f"make_serve_mesh(data={data}, model={model}) needs "
                f"{data * model} CUDA devices, one a (data, model) shard, and "
                f"{cards} are visible; name the devices to share one "
                f"(devices=['cuda:0'] * {data * model})")
        devices = [f"cuda:{i}" for i in range(data * model)]
    devices = tuple(_resolved(d) for d in devices)
    if len(devices) != data * model:
        raise ValueError(f"make_serve_mesh(data={data}, model={model}) got "
                         f"{len(devices)} devices: one a data shard and model "
                         "rank, in (data, model) order")
    return ServeMesh(data, model, tuple(devices[s * model:(s + 1) * model]
                                        for s in range(data)))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's (data 16, model 16) pod of 256 chips (512 with
    `multi_pod`). It serves the dry-run cost model, whose slice decides how
    256 ranks are modelled without them; until then it raises."""
    raise NotImplementedError(
        "make_production_mesh: the 16 x 16 production mesh "
        f"({'512' if multi_pod else '256'} ranks) comes with the dry-run "
        "slice (launch/dryrun.py, ShapeCell/SHAPES; ROADMAP.md, Queue 1 "
        "item 4)")
