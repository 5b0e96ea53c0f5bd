"""Device-mesh scale-out over the Monte-Carlo paths axis.

The reference is single-process (SURVEY.md §2.2: its only concurrency is MKL
threading inside QR).  The scale-out axis here is **paths**: simulations
are embarrassingly parallel except for the per-period regression reductions
(Gram/cross products) and result means, which become cross-shard ``psum``s.

Design: everything in the LSMC engine treats sims as the leading batch axis,
so scale-out is pure GSPMD — place the ``[.., S]``/``[S, G]`` arrays on a
1-D ``Mesh(('paths',))`` with the sims axis sharded, jit as usual, and XLA
inserts ``all-reduce`` for ``X^T X``, ``X^T V`` and every ``mean`` over sims,
which it hands to NCCL on GPUs.  Every card of a host reaches every other at
the same NVLink rate, so the 1-D mesh needs no topology.  No communication
code exists in the library; shardings are data placement plus
compiler-inserted collectives.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

PATHS_AXIS = "paths"


def paths_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """1-D mesh over all (or the given) devices with a single 'paths' axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (PATHS_AXIS,))


def shard_sims(mesh: Mesh, array: jax.Array, sims_axis: int) -> jax.Array:
    """Place an array with the simulations dimension sharded over the mesh.

    ``sims_axis`` indexes the sims dimension of ``array`` (e.g. 1 for
    ``[n, S]`` path panels, 0 for ``[S, G]`` value matrices).
    """
    spec = [None] * array.ndim
    spec[sims_axis] = PATHS_AXIS
    return jax.device_put(array, NamedSharding(mesh, P(*spec)))


def replicate(mesh: Mesh, array: jax.Array) -> jax.Array:
    """Fully replicate an array over the mesh."""
    return jax.device_put(array, NamedSharding(mesh, P()))
