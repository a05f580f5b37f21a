"""Meshes, after ``repro.launch.mesh``: the model-sharding meshes
(``make_production_mesh``, ``make_local_mesh``, ``use_mesh``) and the
shard mesh of the sharded fixpoint engine (``make_shard_mesh``).

The model-sharding meshes are ``torch.distributed`` ``DeviceMesh``es
with the reference's axis names, and a model placed on one holds its
parameters and inputs as DTensors (``models.common.placements``). Each
needs the default process group of its world, which ``process_group``
brings up and ``destroy_process_group`` tears down: only one default
group can exist in a process.

- ``make_production_mesh`` is the reference's pod, 16 x 16 ("data",
  "model") or 2 x 16 x 16 ("pod", "data", "model"), over the fake
  backend of ``torch.testing._internal.distributed.fake_pg`` at world
  size 256 or 512: no device and no peer exists, so a model on it runs
  on the meta device, where the collectives DTensor issues compute
  shapes only (the dry run's ``--mesh single|multi``).
- ``make_local_mesh`` is (1, n) over the ranks of the local group, so (1,
  1) on one card: an NCCL group of world size 1 brought up from an
  in-process store, with no network; on the CPU, when asked for, a gloo
  group of world size 1. A group that a launcher brought up already is
  used as it is.
- ``use_mesh`` makes a mesh the active one of the calling thread, which
  ``models.common.active_abstract_mesh`` reads back and
  ``models.common.maybe_shard`` resolves against.

The reference runs one ``shard_map`` over a 1-D ``jax`` mesh whose sole
axis is named "shards". The port is single-controller in the same way:
one thread per shard runs the engine's shard-local code, and this mesh
only says where each shard's blocks live. A device may repeat: S shards
on one card (or on the CPU) are the counterpart of the reference's
forced host devices, and the same code runs over distinct devices where
a machine has them.

``HARDWARE`` holds the roofline figures of the card the port runs on,
which the dry run (``launch/dryrun.py``) divides by; the reference's
table holds a TPU's.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.models.common import set_active_mesh

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")
_owned: Optional[tuple] = None      # (backend, world size) brought up here


def process_group(backend: str, world_size: int, device=None) -> None:
    """Makes the default process group one of ``backend`` ("fake", "nccl"
    or "gloo") at ``world_size``, this process rank 0, from an in-process
    store: kept when this module brought up that very group, else the one
    it brought up before is destroyed first. Raises when a group that this
    module did not bring up exists. ``device`` binds an NCCL group to a
    card (its communicator is made at once, so a failure shows here)."""
    global _owned
    if dist.is_initialized():
        if _owned is None:
            raise RuntimeError(
                "a default process group that launch.mesh did not bring up "
                "exists; destroy it first")
        if _owned == (backend, world_size):
            return
        destroy_process_group()
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        store = FakeStore()
    else:
        store = dist.HashStore()
    kwargs = {"device_id": torch.device(device)} if device is not None else {}
    dist.init_process_group(backend, rank=0, world_size=world_size,
                            store=store, **kwargs)
    _owned = (backend, world_size)


def destroy_process_group() -> None:
    """Tears down the default group that ``process_group`` brought up (a
    group it did not bring up is left alone)."""
    global _owned
    if _owned is not None and dist.is_initialized():
        dist.destroy_process_group()
    _owned = None


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 = 256 devices a pod, ("data", "model"); ``multi_pod`` adds
    a leading 2-pod axis. Over the fake backend: a model on it runs on the
    meta device."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = POD_AXES if multi_pod else AXES
    process_group("fake", 512 if multi_pod else 256)
    # device type "cuda" (the tensors are meta): DTensor then issues the
    # collectives it would on the cards (on a "cpu" mesh it takes an
    # all-to-all as an all-gather, gloo's)
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


def make_local_mesh(device="cuda"):
    """(1, n) ("data", "model") over the n ranks of the local group: (1,
    1) on one card from an NCCL group of world size 1 (``device`` "cuda",
    the default; raises without a card), or on the CPU from a gloo group
    when ``device`` is "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_local_mesh(device='cuda') but no CUDA "
                               "device is available; pass device='cpu'")
        if not dist.is_initialized() or _owned is not None:
            process_group("nccl", 1, device=torch.device(
                "cuda", torch.cuda.current_device()))
    elif not dist.is_initialized() or _owned is not None:
        process_group("gloo", 1)
    return init_device_mesh(device.type, (1, dist.get_world_size()),
                            mesh_dim_names=AXES)


def compute_mesh(mesh):
    """The mesh a model's DTensors live on for ``mesh``: ``mesh`` itself,
    but the 2-D ("pod_data", "model") for the multi-pod mesh, whose "pod"
    and "data" every spec names together (the data axes, "dp", "all"). A
    collective over both is then one over 32 devices where DTensor would
    issue two in turn, and its sharding propagation stays that of a 2-D
    mesh (on three dims its search for the cheapest layout of every op
    takes minutes a layer). The specs keep the reference's axis names:
    ``models.common.placements`` maps ("pod", "data") to "pod_data"."""
    names = tuple(mesh.mesh_dim_names)
    if names != POD_AXES:
        return mesh
    mesh["pod", "data"]._flatten("pod_data")
    return mesh["pod_data", "model"]


@contextlib.contextmanager
def use_mesh(mesh):
    """Makes ``mesh`` the active mesh of the calling thread for the
    block, as the reference's ``use_mesh``; the one before comes back
    after."""
    token = set_active_mesh(mesh)
    try:
        yield mesh
    finally:
        set_active_mesh(None, token)

SHARD_AXIS = "shards"


@dataclass(frozen=True)
class ShardMesh:
    """One ``torch.device`` per shard, on the single axis "shards"."""
    devices: tuple
    axis_names: tuple = (SHARD_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)


def _device(spec) -> torch.device:
    device = torch.device(spec)
    if device.type == "cuda" and device.index is None and (
            torch.cuda.is_available()):
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_shard_mesh(num_shards: int, devices=None) -> ShardMesh:
    """A 1-D mesh of ``num_shards`` shards. ``devices`` is one device for
    every shard (a string or ``torch.device``; the card by default) or a
    sequence of one device per shard."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if devices is None:
        devices = "cuda"
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * num_shards
    devices = tuple(_device(d) for d in devices)
    if len(devices) != num_shards:
        raise ValueError(f"{len(devices)} devices given for "
                         f"num_shards={num_shards}")
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"shard devices of mixed types: {devices}")
    return ShardMesh(devices)


HARDWARE = {
    # NVIDIA H100 SXM, from its data sheet: dense bf16 tensor-core peak,
    # HBM3 rate and capacity.
    "name": "NVIDIA H100 SXM",
    "peak_flops_bf16": 989e12,
    "hbm_bw": 3.35e12,
    "hbm_bytes": 80e9,
    # The collectives' rate, one link a device (the place of the
    # reference's ici_bw_per_link): a 16-way "model" axis of H100s spans
    # two 8-GPU NVLink nodes, so its collectives cross the 400 Gb/s NDR
    # InfiniBand adapter each H100 has in a DGX H100 (ConnectX-7, from
    # the DGX H100 data sheet): 50e9 B/s.
    "link_bw": 50e9,
}
