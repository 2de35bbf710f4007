"""Device meshes, the process-group runtime and the two collectives the
multi-device paths take.

A `Mesh` lists the devices that one program spreads over, with an axis name:

- ``"buckets"``: the bucket store is split into contiguous bucket ranges,
  one per mesh entry; queries are replicated and every entry's partial
  top-k is merged (`tpulmi_torch.parallel.sharded`);
- ``"data"``: the rows of a build and the batches of its training are
  split over the entries and the gradients averaged
  (`tpulmi_torch.parallel.dist_build`).

A mesh may list one device more than once: S entries of one card hold S
shards there, which is how one card runs an S-shard layout (and how the CPU
tests run one, with ``devices=[torch.device("cpu")] * 8``).

Several processes: call `init_distributed` once per process, before
`make_mesh`; a mesh then spans every process's devices in rank-major order,
and each entry records the rank that owns it. A process addresses only its
own entries. Every process must run the same calls on the same host inputs
(the SPMD contract of the JAX package's multi-host runtime).

The caller fixes the process group's backend: ``"nccl"`` takes card
tensors, ``"gloo"`` host tensors, by design. `gather_entries` and
`all_reduce` move a tensor to the host for gloo and leave it on the card
for nccl; nothing chooses the backend from what it finds on the machine.
"""

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpulmi_torch.utils.profiling import resolve_device


def process_count() -> int:
    """Processes of the group `init_distributed` joined; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def init_distributed(backend: str = "nccl", init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> int:
    """Join the process group (one call per process, before any mesh is
    made) and return this process's rank. `init_method` defaults to
    ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``); pass ``tcp://host:port`` with `world_size` and `rank` to
    give them here. With ``"nccl"`` each process selects its card
    (``torch.cuda.set_device``) before this call.

    A single process needs no group: every mesh helper works on the local
    devices without it."""
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)
    return dist.get_rank()


def _object_array(items, shape) -> np.ndarray:
    out = np.empty(len(items), dtype=object)
    for i, item in enumerate(items):
        out[i] = item
    return out.reshape(shape)


@dataclass(frozen=True, eq=False)
class Mesh:
    """Mesh entries: ``devices`` (an object ndarray of `torch.device`, one
    extent per axis), ``axis_names``, and ``ranks`` (the process that owns
    each entry, same shape). ``devices.size`` and ``devices.flat`` read as
    in the JAX package."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    ranks: np.ndarray

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def local_entries(self) -> List[int]:
        """Flat indices of this process's entries, in mesh order."""
        me = process_index()
        return [i for i, r in enumerate(self.ranks.flat) if r == me]

    def local_devices(self) -> List[torch.device]:
        """This process's distinct devices, in the order of its entries."""
        seen = []
        for i in self.local_entries():
            if self.devices.flat[i] not in seen:
                seen.append(self.devices.flat[i])
        return seen


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("buckets",), devices=None,
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over the first `n_devices` entries (all by default).

    `devices` are this process's entries (a device may repeat); by default
    every ``cuda:i`` it sees, and with no card that raises. Under
    `init_distributed` the mesh spans every process's entries, rank-major.
    1-D by default; for several axes pass `shape`, one extent per axis,
    whose product must equal the entry count."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=[torch.device("
                "'cpu'), ...] to make a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    ranks = [process_index()] * len(devices)
    if dist.is_initialized():
        everyone = [None] * process_count()
        dist.all_gather_object(everyone, [str(d) for d in devices])
        devices = [torch.device(d) for part in everyone for d in part]
        ranks = [r for r, part in enumerate(everyone) for _ in part]
    if n_devices is not None:
        devices, ranks = devices[:n_devices], ranks[:n_devices]
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError(f"{len(axis_names)} axes need an explicit `shape`")
        shape = (len(devices),)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} does not match axes {axis_names}")
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"shape {tuple(shape)} needs {int(np.prod(shape))} "
                         f"devices, have {len(devices)}")
    return Mesh(_object_array(devices, tuple(shape)), tuple(axis_names),
                np.asarray(ranks, dtype=np.int64).reshape(tuple(shape)))


def check_mesh(mesh) -> Mesh:
    """`mesh` if it is a `Mesh`; anything else raises TypeError."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"expected a tpulmi_torch.parallel.Mesh, got "
                        f"{type(mesh).__name__}")
    return mesh


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A private copy of `t` where the group's backend takes it: the host
    for gloo, the card for nccl."""
    if dist.get_backend() == "gloo":
        return t.to("cpu", copy=True)
    return t.clone()


def gather_entries(parts: Sequence[torch.Tensor], mesh: Mesh,
                   device) -> torch.Tensor:
    """Stack one equal-shaped part per mesh entry, in mesh order, on
    `device`: `parts` are this process's, one per local entry in mesh
    order; the others' come through ``dist.all_gather``."""
    local = torch.stack([p.to(device) for p in parts])
    if not dist.is_initialized():
        return local
    owners = [[i for i, r in enumerate(mesh.ranks.flat) if r == rank]
              for rank in range(process_count())]
    most = max(len(o) for o in owners)
    buf = local.new_zeros((most, *local.shape[1:]))
    buf[:len(parts)] = local
    buf = _wire(buf)
    got = [torch.empty_like(buf) for _ in owners]
    dist.all_gather(got, buf)
    out = local.new_empty((mesh.size, *local.shape[1:]))
    for entries, part in zip(owners, got):
        out[entries] = part[:len(entries)].to(device)
    return out


def all_reduce(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """`t` reduced ("sum" or "max") over every process, on `t`'s device;
    `t` itself without a process group. Every process gets the same
    bits."""
    if not dist.is_initialized():
        return t
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    w = _wire(t)
    dist.all_reduce(w, op=red)
    return w.to(t.device)
