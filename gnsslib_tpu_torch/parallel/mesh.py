"""Device meshes (port of :mod:`gnsslib_tpu.parallel.mesh`).

A :class:`Mesh` is a 1-D list of shards, each a ``torch.device`` of this
process (or ``None``: a shard another process runs), along one named axis
(the channel axis, the analogue of the reference's thread per channel,
src/sdrmain.c:144-149).  Channels split into contiguous, possibly uneven
ranges over the shards (:meth:`Mesh.ranges`); shards left without a
channel are skipped.  Shards may repeat a device: ``["cpu"] * 8`` is the
counterpart of the JAX tests' 8 virtual CPU devices, and ``["cuda:0"] *
4`` runs four shards on one card, each with block programs of its own.
"""
from __future__ import annotations

import torch


class Mesh:
    """``devices``: one entry per shard, in channel order (``None`` for a
    shard of another process); ``owners``: the process rank of each shard
    (all 0 in a single process); ``rank``: this process's rank."""

    def __init__(self, devices, axis: str = "ch", owners=None,
                 rank: int = 0):
        self.devices = [None if d is None else torch.device(d)
                        for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self.axis = axis
        self.owners = ([0] * len(self.devices) if owners is None
                       else [int(r) for r in owners])
        self.rank = int(rank)
        self.nproc = max(self.owners) + 1
        if self.owners != sorted(self.owners):
            # the gathered telemetry joins the processes' channels in
            # rank order, which must be the channel order
            raise ValueError(f"shard owners {self.owners} not in rank "
                             "order")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}

    def ranges(self, n: int) -> list[tuple[int, int, int]]:
        """The (shard, start, stop) channel ranges of ``n`` items split
        contiguously over the shards, the first ``n % size`` shards one
        longer; shards left empty (n < size) are skipped."""
        q, r = divmod(int(n), self.size)
        out, start = [], 0
        for i in range(self.size):
            stop = start + q + (i < r)
            if stop > start:
                out.append((i, start, stop))
            start = stop
        return out

    def local(self, n: int) -> list[tuple[int, int, int]]:
        """The ranges of :meth:`ranges` that this process runs."""
        return [r for r in self.ranges(n) if self.owners[r[0]] == self.rank]

    def __repr__(self) -> str:
        return (f"Mesh({self.axis}={self.size}, devices={self.devices}, "
                f"owners={self.owners}, rank={self.rank})")


def make_mesh(n_devices: int | None = None, axis: str = "ch",
              devices=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` CUDA cards (all of them by
    default) with one named axis; raises ``ValueError("need n devices,
    have k")`` when there are fewer, and never falls back to the CPU.
    ``devices`` names the shards instead (and may repeat one); with both,
    ``n_devices`` must equal their number."""
    if devices is not None:
        devices = list(devices)
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"n_devices={n_devices} but {len(devices)} "
                             "devices named")
        return Mesh(devices, axis)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_devices is None:
        n_devices = max(have, 1)
    if n_devices < 1 or have < n_devices:
        raise ValueError(f"need {n_devices} devices, have {have}")
    return Mesh([torch.device("cuda", i) for i in range(n_devices)], axis)
