"""Multi-host bootstrap and uuid partitioning.

The reference scales across machines by hand: operators split days of
data across N instances, and Kafka partitions spread uuids across worker
processes. The port keeps the JAX package's two pieces:

- **work partitioning**: :func:`partition_for_host` assigns uuids to
  hosts by a stable hash, the Kafka keyed-partition contract (all of one
  uuid's points go to one host, in order) without Kafka;
  :func:`host_uuid_filter` is the ownership predicate an entry point gives
  its ingest stage, so N processes reading one shared stream process each
  uuid exactly once;
- **process bootstrap**: :func:`init_multihost` joins a
  ``torch.distributed`` process group on the gloo backend. The decode runs
  no collective (each process decodes over its own cards, and the mesh is
  process-local), so the group is a rendezvous and nothing more: every
  process of the job has started and agrees on its size and its rank.
  NCCL would refuse two ranks on one card, and gloo does not.

This module imports no torch at its top: the batched pipeline's spawned
gather children call :func:`owned_by_host` and stay torch-free.
"""
from __future__ import annotations

import datetime
import hashlib
import logging
from typing import Callable, Optional, Sequence

logger = logging.getLogger("reporter_tpu_torch.parallel")

#: how long :func:`init_multihost` waits for every process of the job
DEFAULT_TIMEOUT_S = 300.0


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join a multi-host job; a no-op for a single host.

    ``coordinator_address`` is ``host:port`` (or ``tcp://host:port``) of
    process 0's rendezvous, with ``num_processes`` and ``process_id``
    given; or ``env://``, where torchrun's ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` say it (torch reads
    them). Returns True when the process group was joined, False without
    a coordinator (``num_processes`` and ``process_id`` alone still
    partition uuids through :func:`host_uuid_filter`: N independent
    workers splitting one stream need no rendezvous). A rendezvous that
    fails or outlasts ``timeout_s`` raises; so does a second call in a
    process that already joined."""
    if not coordinator_address:
        return False
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("this process already joined a process group")
    timeout = datetime.timedelta(seconds=float(timeout_s))
    if coordinator_address == "env://":
        dist.init_process_group("gloo", init_method="env://",
                                timeout=timeout)
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes "
                             "and process_id")
        if not 0 <= process_id < num_processes:
            raise ValueError(
                f"process_id {process_id} not in [0, {num_processes})")
        addr = coordinator_address
        if not addr.startswith("tcp://"):
            addr = "tcp://" + addr
        dist.init_process_group("gloo", init_method=addr,
                                world_size=int(num_processes),
                                rank=int(process_id), timeout=timeout)
    # the group's own barrier: every rank has joined before any goes on
    dist.barrier()
    logger.info("init_multihost: process %d of %d joined %s",
                dist.get_rank(), dist.get_world_size(), coordinator_address)
    return True


def shutdown_multihost() -> None:
    """Leave the process group :func:`init_multihost` joined (a no-op
    when none was); the entry points call it on their way out."""
    import sys
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def host_hash(uuid: str) -> int:
    """Stable across processes and runs (unlike the builtin hash under
    PYTHONHASHSEED randomisation)."""
    return int.from_bytes(
        hashlib.sha1(uuid.encode("utf-8")).digest()[:8], "big")


def owned_by_host(uuid: str, num_processes: int, process_id: int) -> bool:
    return host_hash(uuid) % num_processes == process_id


def partition_for_host(uuids: Sequence[str], num_processes: int,
                       process_id: int) -> list:
    """Indices of the traces this host owns: every trace of one uuid
    lands on exactly one host, hosts partition the uuid space disjointly,
    and the assignment is stable across runs."""
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"process_id {process_id} not in [0, {num_processes})")
    return [i for i, u in enumerate(uuids)
            if owned_by_host(u, num_processes, process_id)]


def host_uuid_filter(num_processes: Optional[int] = None,
                     process_id: Optional[int] = None
                     ) -> Optional[Callable[[str], bool]]:
    """This host's ownership predicate over uuids, or None for a single
    host (``num_processes`` None or at most 1). Raises on a
    ``process_id`` outside [0, num_processes). Entry points give it to
    their ingest stage so a shared, unpartitioned input is processed once
    across the job; with a uuid-keyed Kafka topic the broker already
    partitions and this stays None."""
    if not num_processes or num_processes <= 1:
        return None
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(
            f"process_id {process_id} not in [0, {num_processes})")
    return lambda u: owned_by_host(u, num_processes, process_id)


def add_multihost_args(parser) -> None:
    """The entry points' three multi-host flags."""
    parser.add_argument("--coordinator",
                        help="multi-host rendezvous: host:port of process "
                             "0, or env:// for torchrun's variables")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="processes in the job (partitions uuids even "
                             "without --coordinator)")
    parser.add_argument("--process-id", type=int, default=None,
                        help="this process's rank in [0, num-processes)")


__all__ = ["init_multihost", "shutdown_multihost", "host_hash",
           "owned_by_host", "partition_for_host", "host_uuid_filter",
           "add_multihost_args", "DEFAULT_TIMEOUT_S"]
