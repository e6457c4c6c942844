"""Multi-process channel sharding on ``torch.distributed`` (port of
:mod:`gnsslib_tpu.parallel.distributed`).

The reference is strictly single-process (SURVEY.md §2.4: no distributed
backend).  As in the JAX package, every process runs the same receiver
program on its channel shards of a global mesh (:func:`global_mesh`); the
IF block is read by every process from the same file or stream; the
sharded engines all-gather each block's telemetry and every acquisition
decision (:func:`allgather`), so every process holds the same host state;
and process 0 is the output host (the reference sync thread's role,
src/sdrsync.c), which alone writes RINEX (:func:`is_output_host`).

The process group is ``gloo`` on host tensors: the fan-in is host data
in both packages (JAX's ``process_allgather`` returns numpy), and gloo
lets two processes share one card, which NCCL refuses.  Every group has
a timeout; every collective runs on the caller's thread in block order,
led by a header that all processes must agree on (the engine's tag with
its block or search number, the tensors' sizes and dtypes): a process that skips or
reorders a collective makes the others raise at once, and one that stops
makes them raise when the timeout expires, never hang.
"""
from __future__ import annotations

import datetime
import os
import zlib

import torch
import torch.distributed as dist

from .mesh import Mesh

# seconds a collective (and the group's rendezvous) waits for the other
# processes before it raises
DEFAULT_TIMEOUT_S = 120.0
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the ``gloo`` process group.

    With no arguments, read the ``torchrun`` environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); without it the call
    is a single-process no-op, as the JAX function is.  With explicit
    arguments (``coordinator`` ``host:port``, the process count and this
    process's index) a failure raises."""
    timeout = datetime.timedelta(seconds=float(timeout_s))
    if coordinator is None and num_processes is None and process_id is None:
        if not all(k in os.environ for k in _ENV):
            return                               # single process
        dist.init_process_group("gloo", init_method="env://",
                                timeout=timeout)
    else:
        if coordinator is None or num_processes is None or \
                process_id is None:
            raise ValueError("init_distributed needs coordinator, "
                             "num_processes and process_id together")
        addr = coordinator if "://" in coordinator else \
            f"tcp://{coordinator}"
        dist.init_process_group("gloo", init_method=addr,
                                world_size=int(num_processes),
                                rank=int(process_id), timeout=timeout)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_output_host() -> bool:
    """True on the process that runs observable fan-in and RINEX/RTCM
    output (the reference sync thread's role, src/sdrsync.c:49-135)."""
    return process_index() == 0


def local_device(device: str = "cuda") -> torch.device:
    """This process's device: ``cuda:{local_rank % device_count}`` (the
    processes of one host share its cards in turn; with one card they all
    run on ``cuda:0``), or the CPU when ``device`` is ``"cpu"``.  Raises
    when a card is asked for and there is none."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise ValueError("need 1 devices, have 0")
    local = int(os.environ.get("LOCAL_RANK", process_index()))
    return torch.device("cuda", local % n)


def global_mesh(axis: str = "ch", per_process: int = 1,
                device: str = "cuda") -> Mesh:
    """1-D mesh of ``per_process`` shards in every process, in rank order:
    this process's shards on :func:`local_device`, the others' ``None``."""
    n, r = process_count(), process_index()
    dev = local_device(device)
    owners = [p for p in range(n) for _ in range(int(per_process))]
    return Mesh([dev if o == r else None for o in owners], axis,
                owners=owners, rank=r)


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()


def build_kernels(names=("band_taps",)) -> None:
    """Build the CUDA kernels ``names`` in process 0 while the others wait
    at a barrier, so that a cold machine runs one nvcc per source, not
    one per process (the others then only load the libraries)."""
    from .. import cuda_build
    if process_index() == 0:
        cuda_build.build_all(names)
    barrier()


def allgather(parts, counts, dim: int, tag: str) -> list:
    """Every process's host tensors ``parts`` joined along ``dim`` in rank
    order; process ``p`` holds ``counts[p]`` items along ``dim`` (uneven
    counts are padded to the largest and sliced off).  The processes must
    call it in the same order with the same ``tag`` (the caller puts its
    block or search number in it) and tensors of the same dtypes: a
    mismatch raises ``RuntimeError`` at once, a process that never comes makes the others raise after the
    group's timeout."""
    n, r = process_count(), process_index()
    if n == 1:
        return list(parts)
    m = max(counts)
    padded = []
    for t in parts:
        t = t.detach().cpu()
        if t.dtype == torch.bool:
            t = t.to(torch.uint8)
        if t.shape[dim] != counts[r]:
            raise ValueError(f"{tag}: {t.shape[dim]} items along dim {dim}, "
                             f"counts say {counts[r]}")
        if m > t.shape[dim]:
            shape = list(t.shape)
            shape[dim] = m - t.shape[dim]
            t = torch.cat([t, t.new_zeros(shape)], dim)
        padded.append(t.contiguous())
    kinds = ",".join(str(t.dtype) for t in padded)
    head = torch.tensor([zlib.crc32(tag.encode()), len(padded),
                         sum(t.numel() for t in padded),
                         zlib.crc32(kinds.encode())], dtype=torch.int64)
    heads = [torch.empty_like(head) for _ in range(n)]
    dist.all_gather(heads, head)
    if any(not torch.equal(h, head) for h in heads):
        raise RuntimeError(
            f"process {r}: processes out of step at {tag!r}: (tag's "
            f"CRC-32, tensors, elements, dtypes' CRC-32) " + ", ".join(
                f"process {p} {h.tolist()}" for p, h in enumerate(heads)))
    out = []
    for t, orig in zip(padded, parts):
        bufs = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(bufs, t)
        j = torch.cat([b.narrow(dim, 0, c) for b, c in zip(bufs, counts)],
                      dim)
        out.append(j.to(torch.bool) if orig.dtype == torch.bool else j)
    return out


def shutdown() -> None:
    """Leave the process group (a no-op in a single process)."""
    if dist.is_initialized():
        dist.destroy_process_group()
