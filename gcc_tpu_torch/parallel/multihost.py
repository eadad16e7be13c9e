"""Process-group initialization and per-host pipeline wiring.

Counterpart of ``gcc_tpu/parallel/multihost.py``. There each host runs
one JAX process that drives all of its devices; here every rank is one
process with one device (one GPU over NCCL, or one CPU process over
gloo), and a host is a group of ``LOCAL_WORLD_SIZE`` consecutive ranks
(``torchrun`` sets it; without it every rank counts as one host's). The
reference's ``process_count`` is :func:`host_count`, its
``process_index`` :func:`host_index`, its global device count the world
size. Single-process runs are a no-op.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import torch
import torch.distributed as dist

from gcc_tpu_torch.graph.corpus import partition_graphs
from gcc_tpu_torch.wire import wire_to_device


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         device="cuda") -> None:
    """``torch.distributed.init_process_group`` with explicit or
    environment-provided topology: NCCL for a CUDA device, gloo for the
    CPU. ``coordinator`` is ``host:port`` (or a full ``tcp://`` URL) of
    rank 0, with ``num_processes`` (the world size) and ``process_id``
    (this rank); without them the ``env://`` variables that ``torchrun``
    sets (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``) are read. A no-op
    without topology info, or when a group is already initialized.

    Under NCCL each rank takes device ``LOCAL_RANK`` (``torchrun``), or
    its rank modulo the visible cards."""
    if dist.is_initialized():
        return
    if coordinator is None and num_processes is None:
        if "WORLD_SIZE" not in os.environ or "MASTER_ADDR" not in os.environ:
            return
        init_method, kw = "env://", {}
    else:
        if coordinator is None or num_processes is None or process_id is None:
            raise ValueError("explicit topology needs coordinator, "
                             "num_processes and process_id")
        init_method = (coordinator if "://" in coordinator
                       else f"tcp://{coordinator}")
        kw = dict(world_size=num_processes, rank=process_id)
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_multihost: NCCL needs a CUDA "
                               "device and none is available")
        rank = kw.get("rank", int(os.environ.get("RANK", "0")))
        local = torch.device("cuda", int(os.environ.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", init_method=init_method,
                                device_id=local, **kw)
    else:
        dist.init_process_group("gloo", init_method=init_method, **kw)


@contextlib.contextmanager
def multihost_session(device="cuda"):
    """:func:`initialize_multihost` from the environment for the length of
    a command: yields the world group (None in a single process) and
    destroys the group it started on the way out. A rank that leaves its
    process with the gloo group alive can abort in the interpreter's
    teardown ("terminate called without an active exception", SIGABRT):
    10 of 96 two-rank ``cli generate`` runs under load did, 0 of 96 with
    the group destroyed (``python tests/test_torch_giant_dist.py stress 24
    4``). A group the caller started is left as it is."""
    started = not dist.is_initialized()
    initialize_multihost(device=device)
    try:
        yield dist.group.WORLD if dist.is_initialized() else None
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def world_size() -> int:
    """Ranks in the job (the reference's global device count); 1 without
    a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_world_size() -> int:
    """Ranks of this host: ``LOCAL_WORLD_SIZE`` (``torchrun``), else all
    of them."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))


def host_count() -> int:
    """Hosts in the job (the reference's ``jax.process_count()``)."""
    world, local = world_size(), local_world_size()
    if world % local:
        raise ValueError(f"world size {world} is not a whole number of "
                         f"hosts of {local} ranks")
    return world // local


def host_index() -> int:
    """This rank's host (the reference's ``jax.process_index()``)."""
    return rank() // local_world_size()


def local_rank() -> int:
    """This rank's position among its host's ranks: the slice of the
    host pipeline's device axis it trains on."""
    return rank() % local_world_size()


def host_local_batch_to_global(batch, device="cuda"):
    """The rank's slice of the global batch (a ``CompactWireBatch``), its
    arrays placed on ``device`` as int32 tensors.

    The reference assembles one global array from every host's local
    shard (``jax.make_array_from_process_local_data``) and lets GSPMD run
    the step on it. Here nothing global is assembled: each rank computes
    on its own slice, and the step's collectives (BatchNorm sums, the
    gradient all-reduce, the key all-gather) combine the ranks, so the
    slice a rank holds IS its part of the global batch, and the function
    is the identity on it apart from the upload."""
    edges, meta = wire_to_device(batch, device)
    return dataclasses.replace(batch, edges=edges, meta=meta)


def corpus_shard_for_host(graph_sizes, num_hosts: int | None = None,
                          host_id: int | None = None) -> list[int]:
    """Greedy size-balanced corpus assignment for this host (the
    multi-host extension of the reference's worker partition)."""
    num_hosts = num_hosts if num_hosts is not None else host_count()
    host_id = host_id if host_id is not None else host_index()
    return partition_graphs(graph_sizes, num_hosts)[host_id]
