"""Multi-device scaling on torch.distributed: the mesh, multi-host
initialization, one process a device from one call, and the sharded
registration.

Point clouds are cut into row blocks over a 1-D mesh of processes (one
device each); nearest-neighbour minima combine with all-gathers, rows are
fetched with sums, the overlap gate passes movable blocks around a ring, and
the ICP loop runs replicated on every rank (``sharded.py``).
"""

from .mesh import make_mesh
from .multihost import initialize_multihost, process_info
from .sharded import icp_register_sharded

__all__ = [
    "icp_register_sharded",
    "initialize_multihost",
    "make_mesh",
    "process_info",
]
