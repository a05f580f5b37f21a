"""The shard mesh of the sharded fixpoint engine (``engine/shard.py``) —
the counterpart of ``make_shard_mesh`` in ``repro.launch.mesh``.

The reference runs one ``shard_map`` over a 1-D ``jax`` mesh whose sole
axis is named "shards". The port is single-controller in the same way:
one thread per shard runs the engine's shard-local code, and this mesh
only says where each shard's blocks live. A device may repeat: S shards
on one card (or on the CPU) are the counterpart of the reference's
forced host devices, and the same code runs over distinct devices where
a machine has them.

``HARDWARE`` holds the roofline figures of the one card the port runs
on, which the dry run (``launch/dryrun.py``) divides by; the reference's
table holds a TPU's. The reference's model-sharding meshes (the
production pod meshes, ``use_mesh``, ``make_local_mesh``) are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

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
    # HBM3 rate and capacity. One card has no collectives, so no
    # interconnect entry.
    "name": "NVIDIA H100 SXM",
    "peak_flops_bf16": 989e12,
    "hbm_bw": 3.35e12,
    "hbm_bytes": 80e9,
}
