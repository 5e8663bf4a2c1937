"""The device mesh: a process group with one device a process.

The JAX package's mesh is one controller over many devices. The torch idiom
is one process a device, so a ``Mesh`` here is a ``torch.distributed``
process group with this process's place in it: its size, this rank, and
this rank's device (the card of its local rank, or the CPU). The one mesh
axis is still the points axis: both clouds are cut into contiguous row
blocks, block r on rank r.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

POINTS_AXIS = "points"

# True in a process that ``parallel.launch`` started (or in the calling
# process while it runs a world of one): there every rank holds both whole
# clouds, as the JAX package's single controller does, so the stages that
# need the whole clouds (the warm start's coarse pass, the dilate gate's
# mask) run on rank 0. Any other process group is multi-host.
_single_controller = False


class Mesh(NamedTuple):
    """One rank's view of a 1-D mesh. ``rank`` is None in a process of the
    default group that the mesh leaves out (``make_mesh(n)`` with fewer
    ranks than the group has). ``counts`` counts this rank's collectives by
    kind, and the bytes that gloo staged through host memory for tensors on
    the card (``sharded._Comm``)."""

    group: Optional[dist.ProcessGroup]
    size: int
    rank: Optional[int]
    device: torch.device
    backend: str
    multihost: bool
    counts: dict


def local_device() -> torch.device:
    """This process's device: the card of its local rank (``LOCAL_RANK``,
    else its rank, modulo the cards) when there is one, else the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` ranks of the default process
    group (all of them by default).

    Needs a process group: ``initialize_multihost`` makes one, and
    ``SimpleICP.run(num_devices=n)`` or ``parallel.launch.run`` start one
    process a device with theirs. A mesh smaller than the group is a new
    group, which every rank of the default group must make together."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a torch.distributed process group: call "
            "initialize_multihost(...) in every process, or run through "
            "SimpleICP.run(num_devices=n) / parallel.launch.run(n, ...)"
        )
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"requested {n} devices, only {world} available")
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    group = None if n == world else dist.new_group(ranks=list(range(n)))
    me = dist.get_rank()
    return Mesh(
        group=group, size=n, rank=me if me < n else None,
        device=local_device(), backend=dist.get_backend(),
        multihost=not _single_controller, counts={},
    )
