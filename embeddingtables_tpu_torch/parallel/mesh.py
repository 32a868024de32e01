"""Meshes over `torch.distributed` (counterpart of
`embeddingtables_tpu/parallel/mesh.py`).

JAX runs a mesh from one process: one program, `shard_map` over a
`jax.sharding.Mesh`. The port runs one process per card (or per CPU rank),
joined in one `torch.distributed` process group: NCCL when the mesh's device
type is CUDA, gloo when the caller asks for the CPU. Nothing switches one for
the other when a group fails to form.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the initialized
default group, with JAX's axis names: `("data",)`, or `("data", "model")` for
the 2-D decomposition. The flattened device id of a rank over a tuple of
axes is JAX's `_flat_axis_index`: row-major over the rank's coordinates,
`data_idx * model_size + model_idx` (`parallel.sharded.flat_index`), so rank
r of `local_mesh(n)` holds the rows of JAX's device r.

`local_mesh(n)` and `default_mesh(devices=)` need n to equal the world
size: every rank of the group is on the mesh. JAX takes the first n devices
of its one process; here a sub-mesh would leave the other ranks outside
every collective of the step they run too (ROADMAP.md queue 3, "A mesh
covers the group").
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import resolve_device


def backend_for(device: torch.device) -> str:
    """NCCL for a card, gloo for the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def _init_method(address: str) -> str:
    """A `torch.distributed` init method: `tcp://...` and `file://...` as
    they are; a bare `host:port` (JAX's coordinator address) over TCP."""
    return address if "://" in address else f"tcp://{address}"


def ranks_per_host(device: torch.device, world: int) -> int:
    """Ranks on one host: `LOCAL_WORLD_SIZE` when the launcher sets it, else
    the cards of this host (one rank each), else the whole group (CPU)."""
    env = os.environ.get("LOCAL_WORLD_SIZE")
    if env:
        return int(env)
    if device.type == "cuda":
        return torch.cuda.device_count()
    return world


def init_process(coordinator_address: str, num_processes: int,
                 process_id: int, *, device=None, timeout=None,
                 local_size: Optional[int] = None) -> torch.device:
    """Join the default process group as rank `process_id` of
    `num_processes` (the counterpart of `jax.distributed.initialize`).
    On a card, `torch.cuda.set_device(local rank)` comes first, the local
    rank being `process_id % local_size` (`ranks_per_host` by default).
    Returns this rank's device."""
    device = resolve_device(device)
    if device.type == "cuda":
        local = local_size or ranks_per_host(device, num_processes)
        device = torch.device("cuda", process_id % local)
        torch.cuda.set_device(device)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend_for(device),
                            init_method=_init_method(coordinator_address),
                            world_size=num_processes, rank=process_id, **kw)
    return device


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank runs the mesh's work on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _require_group(device_type: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs the default process group: call "
            "parallel.mesh.init_process (or multihost_mesh with "
            "coordinator_address=) on every rank first")
    want = backend_for(torch.device(device_type))
    have = dist.get_backend()
    if have != want:
        raise RuntimeError(f"a {device_type} mesh needs a {want} group, the "
                           f"default group is {have}")
    return dist.get_world_size()


def _mesh_ranks(devices, n: int) -> torch.Tensor:
    """The ranks `devices` lays on the mesh, in order: ranks as ints, or
    one device per rank (a rank's position in the list). They must be the
    whole group."""
    devices = list(devices)
    ranks = [d if isinstance(d, int) else i for i, d in enumerate(devices)]
    if sorted(ranks) != list(range(n)):
        raise ValueError(
            f"a mesh of {len(ranks)} devices on a group of {n} ranks: a mesh "
            "covers every rank of the group (ROADMAP.md queue 3)")
    return torch.tensor(ranks)


def default_mesh(axes: Sequence[str] = ("data",),
                 shape: Optional[Tuple[int, ...]] = None,
                 devices=None, device=None) -> DeviceMesh:
    """Mesh over every rank of the default group (`devices`: the ranks, or
    one device per rank, in mesh order; default rank order). With one axis,
    all ranks land on it; with several, `shape` must multiply out to the
    world size (default: all on the first axis). The k-th rank of the order
    sits at the k-th position of the row-major grid."""
    if device is None and devices is not None:
        first = next((d for d in devices if not isinstance(d, int)), None)
        device = None if first is None else torch.device(first).type
    device_type = resolve_device(device).type
    n = _require_group(device_type)
    ranks = torch.arange(n) if devices is None else _mesh_ranks(devices, n)
    axes = tuple(axes)
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not name axes {axes}")
    total = 1
    for s in shape:
        total *= s
    if total != n:
        raise ValueError(f"mesh shape {shape} != world size {n}")
    return DeviceMesh(device_type, ranks.reshape(shape), mesh_dim_names=axes)


def local_mesh(n: int, axes: Sequence[str] = ("data",),
               device=None) -> DeviceMesh:
    """The mesh of the n ranks of the group (tests, one host). n must equal
    the world size (JAX takes its first n devices: ROADMAP.md queue 3)."""
    device_type = resolve_device(device).type
    world = _require_group(device_type)
    if n != world:
        raise ValueError(f"local_mesh({n}) on a group of {world} ranks: a "
                         "mesh covers every rank of the group (ROADMAP.md "
                         "queue 3)")
    return default_mesh(axes, device=device)


def multihost_mesh(axes: Sequence[str] = ("data", "model"),
                   data_parallel_within_host: bool = True,
                   coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, *, device=None,
                   local_size: Optional[int] = None) -> DeviceMesh:
    """Mesh for several hosts. With `coordinator_address` this rank joins
    the group first (`init_process`). The data axis, which carries the
    heavy exchanges (the batch's id all-gather and the partial-row
    reduce-scatter), stays inside a host: with two axes and
    `data_parallel_within_host`, the mesh is the `(ranks per host, hosts)`
    grid, so rank `host * local + i` sits at `(i, host)`, as JAX lays its
    devices with `jax.local_device_count()` per process."""
    if coordinator_address is not None:
        init_process(coordinator_address, num_processes, process_id,
                     device=device, local_size=local_size)
    dev = resolve_device(device)
    n = _require_group(dev.type)
    local = local_size or ranks_per_host(dev, n)
    axes = tuple(axes)
    if data_parallel_within_host and len(axes) == 2 and n % local == 0:
        grid = torch.arange(n).reshape(n // local, local).T
        return DeviceMesh(dev.type, grid, mesh_dim_names=axes)
    return default_mesh(axes, device=device)
