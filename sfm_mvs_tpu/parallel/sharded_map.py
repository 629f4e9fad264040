"""Sharded map-store queries: 2D-3D correspondence lookup outside BA.

SURVEY.md §2.3 row 3 asks for a sharded map store whose 2D-3D
correspondence lookups run against a POINT-BLOCK-partitioned table — the
piece of the distributed design that serves the *front end* (registration,
merging, densification) rather than the BA solver (which shards the same
axis in parallel/distributed_ba.py).

Two query kernels, both `shard_map`-ped over contiguous point blocks with
tiny collectives:

- :func:`lookup_points_sharded` — gather 3D points (+validity) for a batch
  of track ids. Each device resolves the ids that fall inside its block
  (contiguous blocks = one range test, no routing tables) and contributes
  zeros elsewhere; a single psum assembles the answer. This is the
  sharded form of the driver's ``state.points[tids]`` 2D-3D association
  (models/incremental.py step 2).
- :func:`nearest_projected_sharded` — for query pixels, the nearest
  *projected* valid map point (squared pixel distance + its depth). Each
  device scans only its block with the same distance matmul the
  single-device dedup uses (models/densify.py), then an all_gather of the
  per-block minima (S x M scalars — bytes, not megabytes) finishes the
  argmin. This is the sharded form of the re-observation merge /
  densification dedup query.

Both are asserted equal to their replicated single-device forms in
tests/test_sharded_map.py on the 8-device virtual mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from sfm_mvs_tpu.ops import projection


def lookup_points_sharded(
    points: jnp.ndarray,
    point_valid: jnp.ndarray,
    tids: jnp.ndarray,
    mesh: Mesh,
    axis: str = "data",
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Sharded gather: points[tids] with the point table sharded by blocks.

    points: (P, 3) sharded over `axis` in contiguous blocks; point_valid:
    (P,); tids: (M,) int32 track ids, -1 or out-of-range -> invalid.
    Returns (X (M, 3), ok (M,)) — replicated.
    """
    n_dev = mesh.shape[axis]
    P_total = points.shape[0]
    block = P_total // n_dev

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def _lookup(pts_blk, val_blk, ids):
        lo = jax.lax.axis_index(axis) * block
        local = ids - lo
        mine = (ids >= lo) & (local < block) & (ids >= 0)
        safe = jnp.clip(local, 0, block - 1)
        X = jnp.where(mine[:, None], pts_blk[safe], 0.0)
        ok = mine & val_blk[safe]
        return (
            jax.lax.psum(X, axis),
            jax.lax.psum(ok.astype(jnp.int32), axis) > 0,
        )

    return _lookup(points, point_valid, tids.astype(jnp.int32))


def nearest_projected_sharded(
    points: jnp.ndarray,
    point_valid: jnp.ndarray,
    pose: jnp.ndarray,
    K: jnp.ndarray,
    uv_query: jnp.ndarray,
    mesh: Mesh,
    axis: str = "data",
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Nearest projected map point per query pixel, point table sharded.

    Each device projects its point block into the camera and computes the
    block-local (min squared pixel distance, depth at argmin) for every
    query with one (M, B) distance matmul; an all_gather over the S
    per-block minima (S x M floats) completes the global argmin. Returns
    (min_d2 (M,), depth (M,)) — replicated; invalid blocks contribute inf.
    """

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def _nearest(pts_blk, val_blk, pose_, K_, uv_q):
        uv_map, depth = projection.project_depth(pts_blk, pose_, K_)
        ok = val_blk & (depth > 0)
        d2 = (
            jnp.sum(uv_q * uv_q, axis=1)[:, None]
            + jnp.sum(uv_map * uv_map, axis=1)[None, :]
            - 2.0 * uv_q @ uv_map.T
        )
        d2 = jnp.where(ok[None, :], d2, jnp.inf)
        j = jnp.argmin(d2, axis=1)
        dmin = jnp.min(d2, axis=1)  # (M,) block-local
        zmin = depth[j]
        # (S, M) gathered minima -> global argmin. S x M scalars, tiny.
        dall = jax.lax.all_gather(dmin, axis)
        zall = jax.lax.all_gather(zmin, axis)
        best = jnp.argmin(dall, axis=0)
        m = jnp.arange(dmin.shape[0])
        return dall[best, m], zall[best, m]

    return _nearest(points, point_valid, pose, K, uv_query)
