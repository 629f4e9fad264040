"""Exhaustive all-pairs match graph: the reference's isfm.py, completed.

The reference's isfm.py matches every new image against every earlier one
(O(N^2) adjacent loop, isfm.py:56-94) and prints per-pair inlier counts,
but never builds anything from them (SURVEY.md §3.5 "dead end"). Here the
same exhaustive matching becomes a *view graph*: all pairs are matched in
parallel batches (sharded across the mesh — the embarrassingly parallel
axis), each pair gets an E-RANSAC inlier count and relative pose, and the
result is a (F, F) match-strength matrix plus per-pair geometry that a
global or incremental reconstruction can consume (e.g. picking the best
bootstrap pair instead of blindly using frames 0,1).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from sfm_mvs_tpu.ops import matching, projection, ransac, sift
from sfm_mvs_tpu.ops.epipolar import recover_pose
from sfm_mvs_tpu.ops.sift import Features
from sfm_mvs_tpu.utils.config import SfmConfig


class ViewGraph(NamedTuple):
    """All-pairs geometry. F frames, M = F*(F-1)/2 pairs."""

    pair_i: np.ndarray  # (M,) first frame index per pair
    pair_j: np.ndarray  # (M,) second frame index
    num_matches: np.ndarray  # (M,) ratio-test survivors
    num_inliers: np.ndarray  # (M,) E-RANSAC inliers
    R: np.ndarray  # (M, 3, 3) relative rotations
    t: np.ndarray  # (M, 3) relative translations (unit)
    adjacency: np.ndarray  # (F, F) symmetric inlier-count matrix
    parallax_deg: np.ndarray  # (M,) mean rotation-compensated ray angle


@partial(jax.jit, static_argnames=("cfg",))
def _pair_geometry(key, desc0, desc1, xy0, xy1, v0, v1, K, cfg: SfmConfig):
    """Match + E-RANSAC + pose for one pair (vmapped over the pair batch)."""
    fc, rc = cfg.frontend, cfg.ransac
    m = matching.knn_match(desc0, desc1, v0, v1, ratio=fc.lowe_ratio)
    uv0 = xy0[m.idx0]
    uv1 = xy1[m.idx1]
    n0 = projection.normalize_points(uv0, K)
    n1 = projection.normalize_points(uv1, K)
    res = ransac.ransac_essential(
        key, n0, n1, m.valid, 0.5 * (K[0, 0] + K[1, 1]),
        threshold_px=rc.essential_threshold_px, iters=rc.essential_iters,
    )
    R, t, _ = recover_pose(res.model, n0, n1, res.inliers)
    # Parallax: mean angle between the rotation-compensated ray from view
    # 0 and the matching ray in view 1, over inliers. A zero-baseline pair
    # (the degenerate-bootstrap trap) scores many E-inliers but ~0 here.
    def rays(n):
        h = jnp.concatenate([n, jnp.ones_like(n[:, :1])], axis=1)
        return h / jnp.linalg.norm(h, axis=1, keepdims=True)

    r0 = rays(n0) @ R.T
    r1 = rays(n1)
    cosang = jnp.clip(jnp.sum(r0 * r1, axis=1), -1.0, 1.0)
    ang = jnp.degrees(jnp.arccos(cosang))
    wsum = jnp.maximum(jnp.sum(res.inliers), 1)
    parallax = jnp.sum(jnp.where(res.inliers, ang, 0.0)) / wsum
    return jnp.sum(m.valid), res.num_inliers, R, t, parallax


_pair_geometry_batch = jax.jit(
    jax.vmap(_pair_geometry, in_axes=(0, 0, 0, 0, 0, 0, 0, None, None)),
    static_argnames=("cfg",),
)


def build_view_graph(
    images_gray: Sequence[np.ndarray],
    cfg: Optional[SfmConfig] = None,
    seed: int = 0,
    batch_size: int = 8,
    feats: Optional[list[Features]] = None,
    window: int = 0,
) -> ViewGraph:
    """Exhaustively match all frame pairs (batched; shardable).

    images_gray: list of (H, W) float32. Pairs are processed in batches of
    `batch_size` through one vmapped match+RANSAC program; on a multi-chip
    mesh the batch axis shards across devices (parallel/frontend.py).
    window > 0 limits pairs to |i - j| <= window (O(N*w) instead of
    O(N^2) — enough for bootstrap selection on video sequences).
    """
    cfg = cfg or SfmConfig()
    K = jnp.asarray(cfg.intrinsic_matrix())
    if feats is None:
        feats = [
            sift.detect_and_compute(jnp.asarray(g), cfg.frontend)
            for g in images_gray
        ]
    F = len(feats)
    pairs = [
        (i, j)
        for i in range(F)
        for j in range(i + 1, F)
        if not window or j - i <= window
    ]
    desc = jnp.stack([f.desc for f in feats])
    xy = jnp.stack([f.xy for f in feats])
    valid = jnp.stack([f.valid for f in feats])

    key = jax.random.PRNGKey(seed)
    nm_all, ni_all, R_all, t_all, px_all = [], [], [], [], []
    for s in range(0, len(pairs), batch_size):
        chunk = pairs[s : s + batch_size]
        pad = batch_size - len(chunk)
        chunk_p = chunk + [chunk[-1]] * pad  # pad the last batch
        ii = jnp.asarray([c[0] for c in chunk_p])
        jj = jnp.asarray([c[1] for c in chunk_p])
        key, kb = jax.random.split(key)
        keys = jax.random.split(kb, batch_size)
        nm, ni, R, t, px = _pair_geometry_batch(
            keys, desc[ii], desc[jj], xy[ii], xy[jj], valid[ii], valid[jj], K, cfg
        )
        n = len(chunk)
        nm_all.append(np.asarray(nm)[:n])
        ni_all.append(np.asarray(ni)[:n])
        R_all.append(np.asarray(R)[:n])
        t_all.append(np.asarray(t)[:n])
        px_all.append(np.asarray(px)[:n])

    num_matches = np.concatenate(nm_all)
    num_inliers = np.concatenate(ni_all)
    adjacency = np.zeros((F, F), dtype=np.int32)
    for (i, j), n in zip(pairs, num_inliers):
        adjacency[i, j] = adjacency[j, i] = n
    return ViewGraph(
        pair_i=np.asarray([p[0] for p in pairs]),
        pair_j=np.asarray([p[1] for p in pairs]),
        num_matches=num_matches,
        num_inliers=num_inliers,
        R=np.concatenate(R_all),
        t=np.concatenate(t_all),
        adjacency=adjacency,
        parallax_deg=np.concatenate(px_all),
    )


def best_bootstrap_pair(
    graph: ViewGraph,
    min_inliers: int = 50,
    min_parallax_deg: float = 1.0,
    max_gap: int = 0,
) -> tuple[int, int]:
    """Pick the strongest non-degenerate pair to initialize from.

    Among pairs with enough inliers AND enough parallax (the
    rotation-compensated ray angle — a near-zero-baseline pair has many
    E-inliers but no triangulable depth), the highest inlier count wins
    (the information isfm.py printed but never used, isfm.py:86).
    max_gap > 0 restricts to pairs at most that many frames apart.
    """
    order = np.argsort(-graph.num_inliers)
    gaps = np.abs(graph.pair_j - graph.pair_i)
    for required_px in (min_parallax_deg, 0.25 * min_parallax_deg, 0.0):
        for idx in order:
            if max_gap and gaps[idx] > max_gap:
                continue
            if (
                graph.num_inliers[idx] >= min_inliers
                and graph.parallax_deg[idx] >= required_px
            ):
                return int(graph.pair_i[idx]), int(graph.pair_j[idx])
    idx = order[0]
    return int(graph.pair_i[idx]), int(graph.pair_j[idx])


@partial(jax.jit, static_argnames=("cfg", "max_err_px", "epipolar_verify"))
def inject_reobservations(
    state,
    cam_i: jnp.ndarray,
    cam_j: jnp.ndarray,
    feats_i: Features,
    feats_j: Features,
    track_i: jnp.ndarray,
    cfg: SfmConfig,
    key: Optional[jnp.ndarray] = None,
    max_err_px: Optional[float] = None,
    epipolar_verify: bool = False,
):
    """Add loop-closure observations: match the (non-adjacent) pair
    (cam_i, cam_j); wherever frame i's feature already tracks a map point,
    record that point's observation in camera j (gated by positive depth,
    reprojection error, and not already observed there). One direction —
    call twice with swapped arguments for both.

    Gate semantics matter for drift correction. The default gate
    (`max_err_px=None` -> cfg.ransac.pnp_threshold_px) accepts only
    matches that already agree with the CURRENT global geometry — safe,
    but on a drifted map it rejects exactly the long-range constraints
    that would reveal the drift (measured: a 250-camera 145-degree arc
    stayed at ATE 1.7% because every >4px stitch match was dropped).
    For stitching drifted maps pass `epipolar_verify=True` (+ a `key`):
    matches are verified by pair-local E-RANSAC — a DRIFT-INDEPENDENT
    two-view check — and `max_err_px` should be loosened to a sanity
    bound (e.g. 64px) so the bend becomes visible to the global BA,
    which then pulls it out (robust phase of `refine.finalize_map`).

    Returns (state, num_injected)."""
    from sfm_mvs_tpu.models import map_store

    if epipolar_verify and key is None:
        raise ValueError("epipolar_verify=True requires a PRNG key")
    tids, uv_j, ok, _err = _reobservation_candidates(
        state, cam_j, feats_i, feats_j, track_i, cfg,
        key if key is not None else jax.random.PRNGKey(0),
        max_err_px, epipolar_verify,
    )
    state = map_store.append_observations(state, cam_j, tids, uv_j, ok)
    return state, jnp.sum(ok)


def _reobservation_candidates(
    state, cam_j, feats_i, feats_j, track_i, cfg: SfmConfig,
    key, max_err_px, epipolar_verify,
):
    """Match + gate one pair; returns (tids, uv_j, ok, err) without
    writing (err = reprojection error, the within-row dedup key)."""
    from sfm_mvs_tpu.models import map_store

    m = matching.knn_match(
        feats_i.desc, feats_j.desc, feats_i.valid, feats_j.valid,
        ratio=cfg.frontend.lowe_ratio,
    )
    uv_i, uv_j, mvalid = matching.gather_match_points(feats_i.xy, feats_j.xy, m)
    if epipolar_verify:
        K = state.K
        n_i = projection.normalize_points(uv_i, K)
        n_j = projection.normalize_points(uv_j, K)
        res = ransac.ransac_essential(
            key, n_i, n_j, mvalid, 0.5 * (K[0, 0] + K[1, 1]),
            threshold_px=cfg.ransac.essential_threshold_px,
            iters=cfg.ransac.essential_iters,
        )
        # Require a real two-view geometry before trusting its inliers:
        # a spurious far pair yields a degenerate E with few inliers.
        enough = res.num_inliers >= cfg.ransac.stitch_min_inliers
        mvalid = mvalid & res.inliers & enough
    gate_px = cfg.ransac.pnp_threshold_px if max_err_px is None else max_err_px
    tids = track_i[m.idx0]
    P = state.points.shape[0]
    safe = jnp.clip(tids, 0, P - 1)
    has = mvalid & (tids >= 0) & state.point_valid[safe]
    X = state.points[safe]
    pose_j = state.poses[cam_j]
    uv_proj, depth = projection.project_depth(X, pose_j, state.K)
    err = jnp.linalg.norm(uv_proj - uv_j, axis=-1)
    fresh = ~state.obs_mask[safe, cam_j]
    ok = (
        has
        & (depth > 0)
        & (err < gate_px)
        & fresh
    )
    return tids, uv_j, ok, err


@partial(jax.jit, static_argnames=("cfg", "max_err_px", "epipolar_verify"))
def inject_reobservations_batch(
    state,
    cam_js: jnp.ndarray,
    feats_i: Features,
    feats_j: Features,
    tracks_i: jnp.ndarray,
    pair_valid: jnp.ndarray,
    cfg: SfmConfig,
    keys: jnp.ndarray,
    max_err_px: Optional[float] = None,
    epipolar_verify: bool = False,
):
    """Batched `inject_reobservations`: B pairs in ONE dispatch.

    feats_*: Features trees with a leading (B,) axis; tracks_i: (B, F);
    pair_valid: (B,) mask (pad slots False, so one compiled program
    serves any pair count). Duplicate scatter destinations are resolved
    deterministically in-library (see `_dedup_scatter_targets`): rows
    sharing a target camera keep the lowest row index, matches sharing a
    track id within a row keep the lowest-reprojection-error one.

    Motivation: the sequential stitch in benchmarks/large_scene.py paid
    per-dispatch latency once per pair; batching moves the pair loop
    on-device, the same design as `build_view_graph`'s vmapped pair
    geometry.

    Returns (state, per-pair injected counts (B,)).
    """
    from sfm_mvs_tpu.models import map_store

    def one(key, cam_j, fi, fj, ti):
        return _reobservation_candidates(
            state, cam_j, fi, fj, ti, cfg, key, max_err_px, epipolar_verify
        )

    tids, uv, ok, err = jax.vmap(one)(keys, cam_js, feats_i, feats_j, tracks_i)
    ok = ok & pair_valid[:, None]
    P = state.points.shape[0]
    ok = _dedup_scatter_targets(
        ok, tids, err, cam_js, P, state.poses.shape[0]
    )
    dest = jnp.where(ok & (tids >= 0), tids, P)  # (B, M)
    cam = jnp.where(pair_valid, cam_js, state.poses.shape[0])[:, None]
    state = state._replace(
        obs_uv=state.obs_uv.at[dest, cam].set(uv, mode="drop"),
        obs_mask=state.obs_mask.at[dest, cam].set(ok, mode="drop"),
    )
    return state, jnp.sum(ok, axis=1)


class StitchCandidates(NamedTuple):
    """Verified (match + pair-local E-RANSAC) stitch candidates for a batch
    of pairs, BOTH directions, with the expensive geometry-independent work
    done exactly once. Re-applying them against updated map geometry
    (apply_stitch_batch) costs only a projection gate + scatter — so the
    stitch<->robust-BA alternation pays for matching/RANSAC once, not once
    per round (round-3's second stitch round re-ran the full match+verify
    per pair and was ~half of the 335 s stitch wall)."""

    cam_a: jnp.ndarray  # (B,) destination cameras, direction i->j
    tids_a: jnp.ndarray  # (B, M) map point ids (from tracks_i via idx0)
    uv_a: jnp.ndarray  # (B, M, 2) observation pixels in cam_a
    cam_b: jnp.ndarray  # (B,) destination cameras, direction j->i
    tids_b: jnp.ndarray  # (B, M)
    uv_b: jnp.ndarray  # (B, M, 2)
    ok: jnp.ndarray  # (B, M) epipolar-verified match mask (shared)


@partial(jax.jit, static_argnames=("cfg",))
def stitch_candidates_batch(
    state,
    cam_is: jnp.ndarray,
    cam_js: jnp.ndarray,
    feats_i: Features,
    feats_j: Features,
    tracks_i: jnp.ndarray,
    tracks_j: jnp.ndarray,
    pair_valid: jnp.ndarray,
    cfg: SfmConfig,
    keys: jnp.ndarray,
) -> StitchCandidates:
    """Match + epipolar-verify B pairs in one dispatch; derive BOTH
    injection directions from the single match set (the match and the
    E-RANSAC are symmetric in the pair — round 3 ran them twice).

    feats_*: Features trees with a leading (B,) axis; tracks_*: (B, F);
    pair_valid: (B,). Gating against map geometry is NOT done here — see
    apply_stitch_batch — so candidates stay valid across BA rounds.
    """

    def one(key, fi, fj, ti, tj):
        m = matching.knn_match(
            fi.desc, fj.desc, fi.valid, fj.valid,
            ratio=cfg.frontend.lowe_ratio,
        )
        uv_i, uv_j, mvalid = matching.gather_match_points(fi.xy, fj.xy, m)
        K = state.K
        n_i = projection.normalize_points(uv_i, K)
        n_j = projection.normalize_points(uv_j, K)
        res = ransac.ransac_essential(
            key, n_i, n_j, mvalid, 0.5 * (K[0, 0] + K[1, 1]),
            threshold_px=cfg.ransac.essential_threshold_px,
            iters=cfg.ransac.essential_iters,
        )
        enough = res.num_inliers >= cfg.ransac.stitch_min_inliers
        ok = mvalid & res.inliers & enough
        return ti[m.idx0], uv_j, tj[m.idx1], uv_i, ok

    tids_a, uv_a, tids_b, uv_b, ok = jax.vmap(one)(
        keys, feats_i, feats_j, tracks_i, tracks_j
    )
    ok = ok & pair_valid[:, None]
    return StitchCandidates(
        cam_a=cam_js, tids_a=tids_a, uv_a=uv_a,
        cam_b=cam_is, tids_b=tids_b, uv_b=uv_b, ok=ok,
    )


@jax.jit
def apply_stitch_batch(
    state,
    cam_dst: jnp.ndarray,
    tids: jnp.ndarray,
    uv: jnp.ndarray,
    ok_epi: jnp.ndarray,
    gate_px: jnp.ndarray,
):
    """Map-gated injection of pre-verified candidates (ONE direction).

    Gates: live point, positive depth, reprojection within gate_px
    against CURRENT geometry, not already observed. Cheap (projection +
    scatter, no matching/RANSAC) — safe to re-run after every BA round
    as the geometry straightens.

    Scatter destinations are made DISTINCT in-library (VERDICT r4 item 9
    — previously a documented caller-side precondition): rows sharing a
    destination camera keep only the lowest row index, and within a row
    matches sharing a track id keep only the lowest-reprojection-error
    one (advisor r4). Both winners are deterministic, so duplicate
    targets can no longer hit unspecified XLA scatter order. Callers that
    chunk pairs to distinct cameras (benchmarks/large_scene.py) are
    unaffected; a caller that passes duplicates gets the first row
    applied and the rest reported as 0 in the returned counts.

    Returns (state, per-pair injected counts (B,)).
    """
    from sfm_mvs_tpu.models import map_store

    P = state.points.shape[0]
    B, M = tids.shape
    safe = jnp.clip(tids, 0, P - 1)
    has = ok_epi & (tids >= 0) & state.point_valid[safe]
    X = state.points[safe]  # (B, M, 3)
    poses = state.poses[cam_dst]  # (B, 3, 4)

    def gate_one(Xb, pose, uvb, hasb):
        uv_proj, depth = projection.project_depth(Xb, pose, state.K)
        err = jnp.linalg.norm(uv_proj - uvb, axis=-1)
        return hasb & (depth > 0) & (err < gate_px), err

    ok, err = jax.vmap(gate_one)(X, poses, uv, has)
    fresh = ~state.obs_mask[safe, cam_dst[:, None]]
    ok = ok & fresh
    ok = _dedup_scatter_targets(ok, tids, err, cam_dst, P, state.poses.shape[0])
    dest = jnp.where(ok & (tids >= 0), tids, P)
    cam = jnp.clip(cam_dst, 0, state.poses.shape[0] - 1)[:, None]
    state = state._replace(
        obs_uv=state.obs_uv.at[dest, cam].set(uv, mode="drop"),
        obs_mask=state.obs_mask.at[dest, cam].set(ok, mode="drop"),
    )
    return state, jnp.sum(ok, axis=1)


def _dedup_scatter_targets(ok, tids, err, cam_dst, P, C):
    """Make batched (point, camera) scatter destinations distinct.

    (a) Cross-row: among rows with any valid candidate sharing a
    destination camera, the LOWEST row index wins (rest fully masked).
    (b) Within-row: among valid matches sharing a track id, the
    lowest-`err` one wins (ties -> lowest match index via stable sort).
    Both choices are deterministic — the in-library guard replacing the
    caller-side distinctness precondition (VERDICT r4 item 9/advisor).
    """
    B, M = tids.shape
    row_idx = jnp.arange(B, dtype=jnp.int32)
    any_ok = jnp.any(ok, axis=1)
    cam_key = jnp.where(any_ok, jnp.clip(cam_dst, 0, C - 1), C)
    winner = jnp.full((C + 1,), B, jnp.int32).at[cam_key].min(row_idx)
    ok = ok & (winner[cam_key] == row_idx)[:, None]

    def dedup_row(t, o, e):
        key_t = jnp.where(o, t, P)  # masked slots sort last
        order = jnp.lexsort((e, key_t))
        st = key_t[order]
        first = jnp.concatenate([jnp.ones((1,), bool), st[1:] != st[:-1]])
        return o & jnp.zeros((M,), bool).at[order].set(first)

    return jax.vmap(dedup_row)(tids, ok, err)


@partial(jax.jit, static_argnames=("image_size",))
def covisibility_matrix(
    state, image_size: Optional[tuple[int, int]] = None
) -> jnp.ndarray:
    """(C, C) covisibility counts from the CURRENT map — the retrieval
    signal for stitch-pair selection (replaces round-3's fixed strides).

    cnt[i, j] = number of points camera i observes that also project
    inside camera j's image with positive depth. One (C, P) x (P, C)
    matmul over the dense observation grid (~8.6 GFLOP at C=256,
    P=128k). Same projected-geometry notion as
    parallel/sharded_map.nearest_projected_sharded, reduced to a
    camera-pair statistic.

    image_size: (W, H) pixel bounds of the cameras' images. Pass it
    whenever the caller holds the images — the fallback infers W=2*cx,
    H=2*cy from the principal point, which silently degrades the
    retrieval signal for off-center principal points (advisor r4).
    """
    pts = state.points  # (P, 3)
    R = state.poses[:, :, :3]  # (C, 3, 3)
    t = state.poses[:, :, 3]  # (C, 3)
    Xc = jnp.einsum("cij,pj->cpi", R, pts) + t[:, None, :]
    z = Xc[..., 2]
    K = state.K
    u = Xc[..., 0] / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z) * K[0, 0] + K[0, 2]
    v = Xc[..., 1] / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z) * K[1, 1] + K[1, 2]
    if image_size is not None:
        W = jnp.asarray(float(image_size[0]), K.dtype)
        H = jnp.asarray(float(image_size[1]), K.dtype)
    else:
        W = 2.0 * K[0, 2]
        H = 2.0 * K[1, 2]
    sees = (
        (z > 0.0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        & state.point_valid[None, :] & state.cam_valid[:, None]
    )  # (C, P)
    obs = (state.obs_mask & state.point_valid[:, None]).astype(jnp.float32)
    cnt = obs.T @ sees.T.astype(jnp.float32)  # (C, C)
    return cnt.astype(jnp.int32)


def retrieve_stitch_pairs(
    cnt: "np.ndarray",
    n_cams: int,
    min_gap: int = 4,
    min_covis: int = 48,
    octaves: tuple = ((4, 8), (8, 16), (16, 32), (32, 64), (64, 1 << 30)),
):
    """Select stitch pairs from the covisibility matrix (host-side).

    For each camera j, pick at most one partner i < j per DISTANCE OCTAVE
    — the farthest covisible camera in each bucket (longest-range links
    carry the most drift-straightening power; short ones densify local
    tracks). Covisibility-driven, so non-overlapping pairs are never
    matched (fixed strides wasted full match+RANSAC on them whenever the
    stride outran the field of view). Returns a list of (i, j), i < j.
    """
    import numpy as _np

    pairs = []
    for j in range(n_cams):
        for lo, hi in octaves:
            cands = [
                i
                for i in range(max(0, j - min(hi - 1, j)), j - lo + 1)
                if (j - i) >= max(lo, min_gap)
                and cnt[i, j] >= min_covis
            ]
            if cands:
                pairs.append((min(cands), j))
    # Dedup while preserving order.
    seen = set()
    out = []
    for p in pairs:
        if p not in seen:
            seen.add(p)
            out.append(p)
    return out


def strongest_loop_pairs(
    graph: ViewGraph,
    top_k: int,
    min_gap: int = 3,
    min_inliers: int = 30,
) -> list[tuple[int, int]]:
    """Top-K strong NON-adjacent pairs — loop-closure candidates whose
    re-observations tie distant cameras together before the final BA."""
    gaps = np.abs(graph.pair_j - graph.pair_i)
    cand = np.where((gaps >= min_gap) & (graph.num_inliers >= min_inliers))[0]
    cand = cand[np.argsort(-graph.num_inliers[cand])][:top_k]
    return [(int(graph.pair_i[i]), int(graph.pair_j[i])) for i in cand]
