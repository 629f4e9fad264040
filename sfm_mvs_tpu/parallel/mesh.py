"""Device mesh construction and sharding helpers."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data",),
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a Mesh over the available devices.

    Default: 1-D 'data' mesh over all devices. Multi-host setups pass an
    explicit shape (e.g. (hosts, devices_per_host) with ('dcn', 'ici'),
    as parallel/multihost.slice_mesh builds).
    """
    devs = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devs),)
    arr = np.array(devs[: int(np.prod(shape))]).reshape(tuple(shape))
    return Mesh(arr, tuple(axis_names))


def shard_batch(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Sharding for arrays whose leading dim is the data-parallel batch."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_map_state(state, mesh: Mesh, axis: str = "data"):
    """Lay a MapState out with its POINT axis sharded over the mesh.

    Point-indexed arrays (points, colors, point_valid, and the dense
    (P, C) observation grid) shard on their leading axis; camera state
    and counters replicate. Downstream jitted programs (register_frame,
    stitch injection, covisibility) then run GSPMD-partitioned — XLA
    inserts the collectives — while shard_map kernels
    (parallel/distributed_ba.py) consume the same layout directly.
    This is BASELINE config 4's "sharded map blocks" layout.
    """
    pt = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    def put(a, sh):
        return jax.device_put(a, sh)

    return state._replace(
        K=put(state.K, rep),
        poses=put(state.poses, rep),
        cam_valid=put(state.cam_valid, rep),
        num_cams=put(state.num_cams, rep),
        points=put(state.points, pt),
        colors=put(state.colors, pt),
        point_valid=put(state.point_valid, pt),
        num_points=put(state.num_points, rep),
        obs_uv=put(state.obs_uv, pt),
        obs_mask=put(state.obs_mask, pt),
    )
