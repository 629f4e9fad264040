"""Multi-host runtime: jax.distributed initialization + 2-D process mesh.

The reference has no distributed runtime at all (SURVEY.md §2.3). Across
several hosts (or several processes) this module initializes
`jax.distributed`, builds a (processes, local_devices) mesh, and provides
the sharding placements the rest of the framework uses. The axis names
are "dcn" for the outer, between-process axis and "ici" for the inner,
within-process axis (on GPUs: the cards of one host, joined by NVLink):

- the front end shards frames over BOTH axes (pure data parallelism —
  collectives-free, so the slower between-host link does not matter);
- distributed BA shards point blocks over the inner axis (its per-CG-step
  psum of the (C,6,6) camera blocks stays within a host) and replicates
  over the outer axis, whose processes only exchange once per LM
  iteration via the cheap cost/accept scalars.

Single-host processes degrade gracefully: `initialize()` is a no-op when
no coordinator is configured, and the mesh collapses to 1-D.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed from args or the standard env vars.

    Returns True when a multi-process runtime was initialized. Safe to call
    on a single host (returns False, does nothing).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if not coordinator_address or num_processes in (None, 1):
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def slice_mesh(
    ici_axis: str = "ici", dcn_axis: str = "dcn"
) -> Mesh:
    """(processes, devices_per_process) mesh: outer axis between processes,
    inner axis within one."""
    devices = jax.devices()
    n_proc = jax.process_count()
    per_host = len(devices) // max(n_proc, 1)
    arr = np.array(devices).reshape(n_proc, per_host)
    return Mesh(arr, (dcn_axis, ici_axis))


def ba_shardings(mesh: Mesh, ici_axis: str = "ici"):
    """Placements for distributed BA on a slice mesh.

    Point-axis arrays shard over the inner axis (and replicate over the
    outer one); camera
    state replicates everywhere. Use with
    distributed_ba.run_ba_sharded(axis=ici_axis).
    """
    return {
        "points": NamedSharding(mesh, P(ici_axis)),
        "cameras": NamedSharding(mesh, P()),
    }
