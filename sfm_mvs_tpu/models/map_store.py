"""Fixed-capacity structure-of-arrays map: cameras, points, observations.

Replaces the reference's ad-hoc per-frame Python state (`Xtot`/`colorstot`
accumulated by np.vstack, sfm.py:284-285,387-395; the pts0/pts1/P1/P2
sliding window, sfm.py:399-409; and the exact-float-coordinate data
association of `common_points`, sfm.py:215-239) with the static-shape
idiom from SURVEY.md §7: every table has a static capacity and a validity mask, so
the entire incremental pipeline is jit-able and shardable. Data
association is by integer *track id* threaded through matching — each
feature slot of the most recent frame remembers which 3D point it
observes (-1 if none), which is both O(N) and exact where the reference's
float-equality matching is O(N*M) and fragile.

Observation layout: a DENSE (max_points, max_cameras) grid — obs_uv[p, c]
is point p's pixel observation in camera c, obs_mask[p, c] its validity.
Each point is observed at most once per camera, so the grid is exact, and
it makes bundle adjustment entirely gather/scatter-free: per-point
reductions are dense sums over the camera axis, per-camera reductions are
dense contractions over the point axis, and the grid shards by
point blocks across devices (per-point work fully local, only small
camera blocks collectively reduced). Appends are one masked scatter per
frame — outside every hot loop.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sfm_mvs_tpu.utils.config import MapConfig


class MapState(NamedTuple):
    """The reconstruction: sharding-friendly flat arrays + counters."""

    K: jnp.ndarray  # (3, 3) shared intrinsics
    poses: jnp.ndarray  # (max_cams, 3, 4) world->cam [R|t]
    cam_valid: jnp.ndarray  # (max_cams,) bool
    num_cams: jnp.ndarray  # () int32
    points: jnp.ndarray  # (max_pts, 3)
    colors: jnp.ndarray  # (max_pts, 3) BGR in [0, 255]
    point_valid: jnp.ndarray  # (max_pts,) bool
    num_points: jnp.ndarray  # () int32
    obs_uv: jnp.ndarray  # (max_pts, max_cams, 2) pixel observations
    obs_mask: jnp.ndarray  # (max_pts, max_cams) bool


def init_map(K: jnp.ndarray, cfg: MapConfig) -> MapState:
    """Empty map with the configured capacities."""
    return MapState(
        K=jnp.asarray(K, jnp.float32),
        poses=jnp.zeros((cfg.max_cameras, 3, 4), jnp.float32),
        cam_valid=jnp.zeros((cfg.max_cameras,), bool),
        num_cams=jnp.zeros((), jnp.int32),
        points=jnp.zeros((cfg.max_points, 3), jnp.float32),
        colors=jnp.zeros((cfg.max_points, 3), jnp.float32),
        point_valid=jnp.zeros((cfg.max_points,), bool),
        num_points=jnp.zeros((), jnp.int32),
        obs_uv=jnp.zeros((cfg.max_points, cfg.max_cameras, 2), jnp.float32),
        obs_mask=jnp.zeros((cfg.max_points, cfg.max_cameras), bool),
    )


def num_observations(state: MapState) -> jnp.ndarray:
    return jnp.sum(state.obs_mask.astype(jnp.int32))


def append_camera(state: MapState, pose: jnp.ndarray) -> tuple[MapState, jnp.ndarray]:
    """Add one camera; returns (state, cam_id)."""
    cam_id = state.num_cams
    return (
        state._replace(
            poses=state.poses.at[cam_id].set(pose),
            cam_valid=state.cam_valid.at[cam_id].set(True),
            num_cams=state.num_cams + 1,
        ),
        cam_id,
    )


def _append_indices(count: jnp.ndarray, valid: jnp.ndarray, capacity: int):
    """Scatter destinations for a masked append.

    Row i goes to `count + (#valid rows before i)`; invalid rows are routed
    to index `capacity`, which `.at[].set(mode="drop")` discards. Returns
    (dest (N,), new_count clamped to capacity).
    """
    offs = jnp.cumsum(valid.astype(jnp.int32)) - 1
    dest = count + offs
    dest = jnp.where(valid, dest, capacity)
    new_count = count + jnp.sum(valid.astype(jnp.int32))
    return dest, jnp.minimum(new_count, capacity)


def append_points(
    state: MapState,
    X: jnp.ndarray,
    colors: jnp.ndarray,
    valid: jnp.ndarray,
) -> tuple[MapState, jnp.ndarray]:
    """Masked-append new 3D points. Returns (state, point_ids (N,)).

    point_ids[i] is the map index for row i, or -1 where ~valid.
    """
    capacity = state.points.shape[0]
    dest, new_count = _append_indices(state.num_points, valid, capacity)
    return (
        state._replace(
            points=state.points.at[dest].set(X, mode="drop"),
            colors=state.colors.at[dest].set(colors, mode="drop"),
            point_valid=state.point_valid.at[dest].set(valid, mode="drop"),
            num_points=new_count,
        ),
        jnp.where(valid, dest, -1),
    )


def append_observations(
    state: MapState,
    cam_id: jnp.ndarray,
    point_ids: jnp.ndarray,
    uv: jnp.ndarray,
    valid: jnp.ndarray,
) -> MapState:
    """Record observations of `point_ids` in camera `cam_id` (scalar).

    One masked scatter into the dense (P, C) observation grid. Duplicate
    valid point_ids (two feature slots claiming the same track — the
    merge-reobservation path can produce them) are resolved
    DETERMINISTICALLY: the lowest slot index wins; XLA's scatter order
    between duplicate destinations is otherwise unspecified (advisor r4).
    """
    M = point_ids.shape[0]
    P = state.points.shape[0]
    dest = jnp.where(valid & (point_ids >= 0), point_ids, P)
    slot = jnp.arange(M, dtype=jnp.int32)
    winner = jnp.full((P + 1,), M, jnp.int32).at[dest].min(slot, mode="drop")
    valid = valid & (winner[jnp.clip(dest, 0, P)] == slot)
    dest = jnp.where(valid, dest, P)
    return state._replace(
        obs_uv=state.obs_uv.at[dest, cam_id].set(uv, mode="drop"),
        obs_mask=state.obs_mask.at[dest, cam_id].set(valid, mode="drop"),
    )


def compact_points(state: MapState) -> tuple[MapState, jnp.ndarray]:
    """Move valid points to the front of the point axis (one jit-safe
    masked scatter per array). Returns (state, remap) where remap[i] is a
    point's new index (-1 for dropped slots) — callers holding external
    track ids must remap them.

    BA cost on the dense (P, C) grid is CAPACITY-proportional, so a map
    whose live points are a fraction of capacity (after culling, or when
    provisioned generously) pays for the dead slots every LM iteration;
    compacting (+ shrink_map) right-sizes the grid before expensive
    global solves."""
    P = state.points.shape[0]
    valid = state.point_valid
    offs = jnp.cumsum(valid.astype(jnp.int32)) - 1
    dest = jnp.where(valid, offs, P)
    z = jnp.zeros_like
    return (
        state._replace(
            points=z(state.points).at[dest].set(state.points, mode="drop"),
            colors=z(state.colors).at[dest].set(state.colors, mode="drop"),
            point_valid=z(valid).at[dest].set(valid, mode="drop"),
            obs_uv=z(state.obs_uv).at[dest].set(state.obs_uv, mode="drop"),
            obs_mask=z(state.obs_mask).at[dest].set(state.obs_mask, mode="drop"),
            num_points=jnp.sum(valid.astype(jnp.int32)),
        ),
        jnp.where(valid, offs, -1),
    )


def shrink_map(state: MapState, new_max_points: int) -> MapState:
    """Slice the point axis down to `new_max_points` (host-side reshape;
    requires a prior compact_points and all live points fitting)."""
    if new_max_points >= state.points.shape[0]:
        return state
    assert int(state.num_points) <= new_max_points, "live points must fit"
    return state._replace(
        points=state.points[:new_max_points],
        colors=state.colors[:new_max_points],
        point_valid=state.point_valid[:new_max_points],
        obs_uv=state.obs_uv[:new_max_points],
        obs_mask=state.obs_mask[:new_max_points],
    )


def reorder_cameras(state: MapState, perm) -> MapState:
    """Permute camera slots: new slot k holds old camera perm[k].

    Used by the auto-bootstrap driver, which registers frames in view-graph
    order and then restores frame order for export/evaluation. `perm` must
    be a permutation of range(num_cams) (padded slots stay in place).
    """
    C = state.poses.shape[0]
    perm = jnp.asarray(perm, jnp.int32)
    full = jnp.concatenate(
        [perm, jnp.arange(perm.shape[0], C, dtype=jnp.int32)]
    )
    return state._replace(
        poses=state.poses[full],
        cam_valid=state.cam_valid[full],
        obs_uv=state.obs_uv[:, full],
        obs_mask=state.obs_mask[:, full],
    )


def grow_map(state: MapState, new_max_points: int) -> MapState:
    """Return a copy with point capacity enlarged to `new_max_points`.

    Point indices are preserved (pure zero-padding along the point axis),
    so track ids held outside the map stay valid. Used by the finalize
    densification sweep: the registration loop runs at a right-sized
    capacity (BA cost is capacity-proportional on the dense grid) and only
    the one-time sweep pays for the bigger grid.
    """
    P = state.points.shape[0]
    if new_max_points <= P:
        return state
    pad = new_max_points - P
    return state._replace(
        points=jnp.pad(state.points, ((0, pad), (0, 0))),
        colors=jnp.pad(state.colors, ((0, pad), (0, 0))),
        point_valid=jnp.pad(state.point_valid, ((0, pad),)),
        obs_uv=jnp.pad(state.obs_uv, ((0, pad), (0, 0), (0, 0))),
        obs_mask=jnp.pad(state.obs_mask, ((0, pad), (0, 0))),
    )


def update_points(state: MapState, point_ids: jnp.ndarray, X: jnp.ndarray, valid: jnp.ndarray) -> MapState:
    """Overwrite existing points (BA write-back)."""
    capacity = state.points.shape[0]
    dest = jnp.where(valid & (point_ids >= 0), point_ids, capacity)
    return state._replace(points=state.points.at[dest].set(X, mode="drop"))


def update_poses(state: MapState, cam_ids: jnp.ndarray, poses: jnp.ndarray, valid: jnp.ndarray) -> MapState:
    """Overwrite existing camera poses (BA write-back)."""
    capacity = state.poses.shape[0]
    dest = jnp.where(valid & (cam_ids >= 0), cam_ids, capacity)
    return state._replace(poses=state.poses.at[dest].set(poses, mode="drop"))


@partial(jax.jit, static_argnames=("block",))
def merge_duplicate_points(
    state: MapState,
    eps_3d: jnp.ndarray,
    merge_px: jnp.ndarray,
    block: int = 1024,
) -> tuple[MapState, jnp.ndarray, jnp.ndarray]:
    """Merge map points that describe the SAME landmark twice.

    Loop closure / stitching can re-associate a landmark that already
    exists as two independent track chains (created on different passes
    of the camera); the duplicate survives with its own observation row
    and double-counts its evidence in BA. Closes the "track merging
    across arbitrary gaps" gap (DESIGN.md §9; reference behavior anchor:
    the track-based variant's one global track table, test.py:10-26,
    which cannot hold duplicates by construction).

    A pair (i, j<i) merges when (a) the 3D points are within `eps_3d`,
    (b) every camera observing BOTH sees them within `merge_px` pixels
    (no geometric conflict), (c) j is itself a merge ROOT (no chains),
    and (d) i is j's CLOSEST merge candidate (unique winner per target,
    so observation-row transfers never collide). Point i's observations
    fill the cameras where j has none; i is invalidated.

    One pass merges pairs; call again to collapse larger clusters.
    Returns (state, remap (P,) int32 — remap[i] = surviving id, identity
    for unmerged — and n_merged ()).
    """
    P = state.points.shape[0]
    block = min(block, P)  # capacities are powers of two, so P % block == 0
    pts = state.points
    pv = state.point_valid

    # Blockwise nearest LOWER-INDEX valid neighbor within eps_3d.
    eps2 = eps_3d * eps_3d
    idx_all = jnp.arange(P, dtype=jnp.int32)

    def row_block(i0):
        rows = jax.lax.dynamic_slice(pts, (i0, 0), (block, 3))
        rv = jax.lax.dynamic_slice(pv, (i0,), (block,))
        ri = i0 + jnp.arange(block, dtype=jnp.int32)
        d2 = (
            jnp.sum(rows * rows, axis=1)[:, None]
            + jnp.sum(pts * pts, axis=1)[None, :]
            - 2.0 * rows @ pts.T
        )  # (block, P)
        ok = rv[:, None] & pv[None, :] & (idx_all[None, :] < ri[:, None])
        d2 = jnp.where(ok & (d2 < eps2), d2, jnp.inf)
        j = jnp.argmin(d2, axis=1).astype(jnp.int32)
        dmin = jnp.min(d2, axis=1)
        return jnp.where(jnp.isfinite(dmin), j, -1), dmin

    n_blocks = P // block
    starts = jnp.arange(n_blocks, dtype=jnp.int32) * block
    partner, pair_d2 = jax.lax.map(row_block, starts)
    partner = partner.reshape(P)
    pair_d2 = pair_d2.reshape(P)

    # (b) pixel-conflict test on the candidate pairs only: (P, C) work.
    safe_j = jnp.clip(partner, 0, P - 1)
    both = state.obs_mask & state.obs_mask[safe_j]  # (P, C)
    duv = jnp.linalg.norm(state.obs_uv - state.obs_uv[safe_j], axis=-1)
    conflict = jnp.any(both & (duv > merge_px), axis=1)

    # (c) target must be a root; (d) unique winner per target.
    is_root = partner < 0
    cand = (partner >= 0) & is_root[safe_j] & ~conflict
    best_at_j = (
        jnp.full((P,), jnp.inf)
        .at[jnp.where(cand, partner, P)]
        .min(pair_d2, mode="drop")
    )
    winner = cand & (pair_d2 <= best_at_j[safe_j])
    # Tie-break exact-equal distances: lowest source index wins.
    first_at_j = (
        jnp.full((P,), P, dtype=jnp.int32)
        .at[jnp.where(winner, partner, P)]
        .min(idx_all, mode="drop")
    )
    winner = winner & (idx_all == first_at_j[safe_j])

    # Transfer observations i -> j where j lacks them; drop point i.
    src_mask = jnp.where(winner[:, None], state.obs_mask, False)
    src_uv = state.obs_uv
    dest = jnp.where(winner, partner, P)
    add_mask = (
        jnp.zeros_like(state.obs_mask).at[dest].set(src_mask, mode="drop")
    )
    add_uv = (
        jnp.zeros_like(state.obs_uv).at[dest].set(src_uv, mode="drop")
    )
    new_mask = state.obs_mask | add_mask
    new_uv = jnp.where(state.obs_mask[..., None], state.obs_uv, add_uv)
    new_valid = pv & ~winner
    cleared = winner[:, None]
    state = state._replace(
        point_valid=new_valid,
        obs_mask=jnp.where(cleared, False, new_mask),
        obs_uv=jnp.where(cleared[..., None], 0.0, new_uv),
    )
    remap = jnp.where(winner, partner, idx_all)
    return state, remap, jnp.sum(winner)
