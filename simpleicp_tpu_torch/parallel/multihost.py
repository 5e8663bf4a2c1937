"""Multi-host initialization.

Every host (or every process of one host) runs the same program; one
``torch.distributed`` handshake joins them into the default process group,
and ``make_mesh()`` + ``icp_register_sharded`` then run the sharded
registration over it: NCCL between cards, gloo between CPU processes.
Every process holds the same whole clouds and takes its own row block of
each (``sharded._block``). No process runs a stage on the whole clouds, so
the warm start and the dilate gate's mask are refused here, as in the JAX
package's multi-host runs.

torchrun works as well: it sets ``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``, and ``initialize_multihost()``
with no arguments reads them.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import local_device

_log = logging.getLogger(__name__)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
) -> None:
    """One-time ``init_process_group`` handshake (no-op if a group exists).

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL) of
    process 0; with no arguments the environment's ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` are used (torchrun).
    ``backend`` is NCCL when this process has a card and gloo otherwise;
    pass "gloo" for processes that share one card (NCCL refuses two ranks
    on one device). With a card, this process's current device becomes the
    card of its local rank. Without one, this process runs on one torch
    thread from here on, as ``launch.run``'s CPU ranks do: a CPU sum over
    more rows than a thread's grain adds in another order on more threads,
    so ranks on hosts with different core counts would compute different
    bits of the replicated state (H, the stop flag) and then wait in
    different collectives."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if coordinator_address is not None:
        url = coordinator_address
        kwargs["init_method"] = url if "://" in url else f"tcp://{url}"
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(backend, **kwargs)
    dev = local_device()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        _log.info("initialize_multihost: a CPU rank runs on one torch thread "
                  "(was %d), so that every rank sums in the same order",
                  torch.get_num_threads())
        torch.set_num_threads(1)


def process_info() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()
