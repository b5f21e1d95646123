"""Device-mesh helpers for single- and multi-host runs.

The reference has no distributed layer (SURVEY §2.4); here a mesh is the
unit of scaling: distributed BA shards map points over it (dist_ba).
This module wraps jax.distributed initialization for multi-host SPMD
and mesh construction.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh


def init_multi_host(coordinator: str | None = None,
                    num_processes: int | None = None,
                    process_id: int | None = None) -> None:
    """Initialize jax.distributed from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    No-op when single-process."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None:
        return
    if num_processes is None:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None:
        # NOTE: `process_id or env` would misroute process 0 (0 is falsy)
        process_id = int(os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def map_mesh(n_devices: int | None = None, axis: str = "mp") -> Mesh:
    """1-D mesh over all (or the first n) devices for map-point sharding."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def shard_map_state(m, mesh: Mesh, axis: str = "mp"):
    """Place a MapState on the mesh with its map-point axis sharded and
    everything else replicated (SURVEY §2.3 final row / §5.7: the map
    grows with the mesh).

    Every [P, ...] leaf (positions, descriptors, stats, validity) splits
    over `axis`; keyframe arrays and scalars replicate.  The jitted
    pipeline programs (tracking, the fused keyframe chain, loop closing)
    are sharding-agnostic jnp — XLA partitions the [K,P] observation
    matmuls, frustum tests and gathers and inserts the collectives
    (psum/all-gather on the [K]-sized reductions) over the device
    interconnect.
    """
    from jax.sharding import NamedSharding, PartitionSpec

    spec_pt = NamedSharding(mesh, PartitionSpec(axis))
    spec_rep = NamedSharding(mesh, PartitionSpec())
    P_ax = m.P

    def place(x):
        if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == P_ax:
            return jax.device_put(x, spec_pt)
        return jax.device_put(x, spec_rep)

    return jax.tree.map(place, m)
