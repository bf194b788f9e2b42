"""Multi-host runtime helpers.

The engine itself is topology-agnostic: `ik_sharded` takes any mesh.  On
several hosts the only extra step is initializing the JAX distributed
runtime and building a mesh whose "data" axis spans hosts (pose shards never
communicate; the network only carries the initial scatter/final gather)
while the "seed" axis stays within a host's cards (the argmin-reduce
collective runs over NCCL on NVLink).  This module wraps that recipe.

The reference has no distributed story at all (single process, rayon pool —
SURVEY.md §2); this is the scale-out path replacing it.
"""

from __future__ import annotations

from typing import Optional

import jax

from .mesh import make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Bring up the JAX distributed runtime (idempotent).

    Where a cluster environment is detected all arguments may be None
    (jax.distributed auto-detects); otherwise pass the coordinator address
    (``host:port``), the process count and this process's id.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    except RuntimeError as e:  # already initialized
        if "already initialized" not in str(e):
            raise


def pod_mesh(seed_per_host: int = 1):
    """A (data, seed) mesh over every host: data spans hosts, seed stays
    within each host's local cards.

    ``seed_per_host`` local devices per host are assigned to the seed axis;
    the rest extend the data axis.
    """
    n_local = jax.local_device_count()
    if n_local % seed_per_host:
        raise ValueError("seed_per_host must divide local device count")
    n_total = jax.device_count()
    seed = seed_per_host
    data = n_total // seed
    return make_mesh(jax.devices(), data=data, seed=seed)
