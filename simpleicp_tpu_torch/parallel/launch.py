"""One process a device, started from one call.

The JAX package shards over a mesh from a single controller. torch has no
such mesh: a process drives one device. ``run(n, fn, *args)`` gives the
caller the JAX package's single-call form: it starts ``n`` processes
(``torch.multiprocessing`` spawn), joins them into a process group over a
``FileStore`` in a temporary directory (NCCL when they run on cards, one
card each, gloo on the CPU), calls ``fn(*args)`` in each and returns what
each rank returned. Every rank holds the same whole arguments, as the JAX
package's controller holds the whole clouds (``mesh._single_controller``).

A world of one runs in the calling process, as a group of one. A rank that
fails makes the call raise with its traceback; no partial result is
returned. ``fn`` and ``args`` are pickled to the children, so ``fn`` is a
module-level function (``sharded.register_jobs``). The spawned processes
import the caller's main module, so a script that calls ``run`` keeps its
entry point under ``if __name__ == "__main__":``.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import mesh as mesh_mod
from ..utils.device import resolve


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def _run_rank(rank: int, n: int, dev_type: str, tmp: str, fn: Callable, args: tuple):
    """One rank: its device, the group, ``fn(*args)``, its result saved
    under ``tmp``."""
    dev = torch.device(dev_type)
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
    else:
        # Replicated math must give the same bits on every rank; one thread
        # each also keeps n ranks from oversubscribing the cores.
        torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), n)
    dist.init_process_group(_backend(dev), store=store, rank=rank, world_size=n)
    mesh_mod._single_controller = True
    try:
        out = fn(*args)
    finally:
        mesh_mod._single_controller = False
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"result_{rank}.pt"))


def run(n: int, fn: Callable, *args, device: Union[str, torch.device, None] = None) -> list:
    """``fn(*args)`` on each rank of a new world of ``n`` processes, one a
    device (``device``: the card by default, an error without one; "cpu"
    runs ``n`` CPU processes over gloo). Returns the ranks' results, rank 0
    first. Raises when a process group already exists (make a mesh of it
    instead) and when ``n`` exceeds the cards."""
    if dist.is_initialized():
        raise RuntimeError("launch.run starts its own process group; one exists "
                           "already: use make_mesh() in every rank instead")
    dev = resolve(device, None)[0]
    n = int(n)
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"requested {n} devices, only {torch.cuda.device_count()} available")
    with tempfile.TemporaryDirectory(prefix="simpleicp_launch_") as tmp:
        if n == 1:
            store = dist.FileStore(os.path.join(tmp, "store"), 1)
            dist.init_process_group(_backend(dev), store=store, rank=0, world_size=1)
            mesh_mod._single_controller = True
            try:
                return [fn(*args)]
            finally:
                mesh_mod._single_controller = False
                dist.destroy_process_group()
        mp.start_processes(_run_rank, args=(n, dev.type, tmp, fn, args), nprocs=n,
                           join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"result_{r}.pt"), weights_only=False)
                for r in range(n)]
