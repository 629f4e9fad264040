"""Track-based global SfM: the reference's test.py pipeline, in JAX.

Capability parity with the reference's experimental variant (SURVEY.md
§3.4): per-adjacent-pair matching with homography estimation
(test.py:219-281), homography-chained feature tracks (feat_to_tracks,
test.py:10-26), triangulation of the (0,1) pair from track columns
(test.py:296-311), PnP of every later camera against that single cloud
(test.py:315-326), a global reprojection audit + global bundle adjustment
(test.py:330-335), and a final per-adjacent-pair triangulation sweep for
the dense-ish export (test.py:339-380, isparse.ply).

Differences by design (not accident):
- Homographies come from the vectorized 4-point DLT RANSAC (ransac.py),
  not cv2.findHomography.
- The global BA optimizes cameras + points with observations FIXED
  (models/ba.py) — the reference's variant optimizes the 2D tracks too,
  a documented defect (test.py:115-132, SURVEY.md §2.1).
- Track chaining is one vmapped composed-homography warp per frame, with
  validity masks instead of dynamic filtering.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from sfm_mvs_tpu.models import ba as ba_mod
from sfm_mvs_tpu.models import map_store
from sfm_mvs_tpu.models.map_store import MapState
from sfm_mvs_tpu.ops import homography, matching, projection, ransac, sift, triangulation
from sfm_mvs_tpu.ops.epipolar import recover_pose
from sfm_mvs_tpu.utils.config import SfmConfig


class PairEstimate(NamedTuple):
    """Adjacent-pair geometry (the reference's per-pair loop state)."""

    H: jnp.ndarray  # (3, 3) homography frame i -> i+1
    R: jnp.ndarray  # (3, 3) relative rotation
    t: jnp.ndarray  # (3,) relative translation (unit norm)
    num_inliers: jnp.ndarray  # () E-RANSAC inliers


@partial(jax.jit, static_argnames=("cfg",))
def estimate_pair(key, feats0, feats1, K, cfg: SfmConfig) -> PairEstimate:
    """Match one adjacent pair; estimate E (-> relative pose) and H."""
    fc, rc = cfg.frontend, cfg.ransac
    m = matching.match_with_config(
        feats0.desc, feats1.desc, feats0.valid, feats1.valid, fc
    )
    uv0, uv1, mvalid = matching.gather_match_points(feats0.xy, feats1.xy, m)
    n0 = projection.normalize_points(uv0, K)
    n1 = projection.normalize_points(uv1, K)
    k1, k2 = jax.random.split(key)
    e_res = ransac.ransac_essential(
        k1, n0, n1, mvalid, 0.5 * (K[0, 0] + K[1, 1]),
        threshold_px=rc.essential_threshold_px, iters=rc.essential_iters,
    )
    R, t, _ = recover_pose(e_res.model, n0, n1, e_res.inliers)
    h_res = ransac.ransac_homography(
        k2, uv0, uv1, mvalid,
        threshold_px=rc.homography_threshold_px, iters=rc.homography_iters,
    )
    return PairEstimate(H=h_res.model, R=R, t=t, num_inliers=e_res.num_inliers)


@jax.jit
def chain_tracks(
    kp_last: jnp.ndarray,
    valid_last: jnp.ndarray,
    homographies: jnp.ndarray,
    image_size: jnp.ndarray,
):
    """Warp the last frame's keypoints back through chained homographies.

    The reference's feat_to_tracks (test.py:10-26): for F frames and F-1
    adjacent homographies H_i (frame i -> i+1), the last frame's keypoint
    positions are mapped into every earlier frame via composed inverses.

    kp_last: (N, 2); homographies: (F-1, 3, 3); image_size: (2,) = (W, H).
    Returns (tracks (F, N, 2), track_valid (F, N)).
    """
    F = homographies.shape[0] + 1
    W, H = image_size[0], image_size[1]

    def step(carry, Hmat):
        pts = carry
        prev = homography.apply_homography(jnp.linalg.inv(Hmat), pts)
        return prev, prev

    # scan backward over homographies: frame F-1 -> F-2 -> ... -> 0
    _, warped = jax.lax.scan(step, kp_last, homographies[::-1])
    tracks = jnp.concatenate([warped[::-1], kp_last[None]], axis=0)  # (F, N, 2)
    inside = (
        (tracks[..., 0] >= 0)
        & (tracks[..., 0] <= W - 1)
        & (tracks[..., 1] >= 0)
        & (tracks[..., 1] <= H - 1)
    )
    return tracks, inside & valid_last[None, :]


class GlobalSfM:
    """Host driver for the track-based global pipeline (test.py analog)."""

    def __init__(self, config: Optional[SfmConfig] = None):
        self.config = config or SfmConfig()
        self.stats: list[dict] = []

    def run(
        self,
        images_gray: Sequence[np.ndarray],
        seed: int = 0,
        run_ba: bool = True,
    ) -> MapState:
        cfg = self.config
        K = jnp.asarray(cfg.intrinsic_matrix())
        key = jax.random.PRNGKey(seed)
        feats = [
            sift.detect_and_compute(jnp.asarray(g), cfg.frontend)
            for g in images_gray
        ]
        F = len(feats)

        # 1. Adjacent-pair geometry (test.py:219-281).
        pairs = []
        for i in range(F - 1):
            key, ki = jax.random.split(key)
            pairs.append(estimate_pair(ki, feats[i], feats[i + 1], K, cfg))
        Hs = jnp.stack([p.H for p in pairs])

        # 2. Homography-chained tracks from the last frame's keypoints
        #    (test.py:289 -> feat_to_tracks).
        H_img, W_img = images_gray[0].shape
        tracks, tvalid = chain_tracks(
            feats[-1].xy, feats[-1].valid, Hs,
            jnp.asarray([W_img, H_img], jnp.float32),
        )

        # 3. Bootstrap poses for frames 0,1 from the chained relative pose,
        #    triangulate the track columns (test.py:296-311).
        pose0 = jnp.concatenate(
            [jnp.eye(3, dtype=jnp.float32), jnp.zeros((3, 1), jnp.float32)], axis=1
        )
        R01, t01 = pairs[0].R, pairs[0].t
        pose1 = jnp.concatenate([R01, t01[:, None]], axis=1)
        X = triangulation.triangulate_euclidean(
            K @ pose0, K @ pose1, tracks[0], tracks[1]
        )
        d0, d1 = triangulation.triangulation_depths(pose0, pose1, X)
        pvalid = tvalid[0] & tvalid[1] & (d0 > 0) & (d1 > 0)
        err1 = projection.masked_mean_reprojection_error(
            X, tracks[1], pose1, K, pvalid
        )
        self.stats.append(
            {
                "frame": 1,
                "pnp_inliers": int(jnp.sum(pvalid)),
                "reproj_error": float(err1),
            }
        )

        # 4. Register every later camera by PnP against this one cloud
        #    (test.py:315-326), then collect per-camera observations.
        poses = [pose0, pose1]
        for i in range(2, F):
            key, ki = jax.random.split(key)
            uv_i = tracks[i]
            uvn_i = projection.normalize_points(uv_i, K)
            res = ransac.ransac_pnp(
                ki, X, uv_i, uvn_i, pvalid & tvalid[i], K,
                threshold_px=cfg.ransac.pnp_threshold_px,
                iters=cfg.ransac.pnp_iters,
                use_p3p=cfg.ransac.pnp_use_p3p,
            )
            poses.append(res.model)
            err_i = projection.masked_mean_reprojection_error(
                X, uv_i, res.model, K, res.inliers
            )
            self.stats.append(
                {
                    "frame": i,
                    "pnp_inliers": int(res.num_inliers),
                    "reproj_error": float(err_i),
                }
            )

        # 5. Materialize the map: cameras, points, per-frame observations.
        state = map_store.init_map(K, cfg.map)
        for pose in poses:
            state, _ = map_store.append_camera(state, pose)
        g0 = jnp.asarray(images_gray[0])
        Hh, Ww = g0.shape
        xi = jnp.clip(tracks[0][:, 0].astype(jnp.int32), 0, Ww - 1)
        yi = jnp.clip(tracks[0][:, 1].astype(jnp.int32), 0, Hh - 1)
        gval = g0[yi, xi] * 255.0
        colors = jnp.stack([gval, gval, gval], axis=-1)
        state, pids = map_store.append_points(state, X, colors, pvalid)
        for i in range(F):
            obs_ok = pvalid & tvalid[i]
            state = map_store.append_observations(
                state, i, pids, tracks[i], obs_ok
            )

        # 6. Global audit + global BA (test.py:330-335; our BA keeps the
        #    observations fixed, unlike the reference's defective pack).
        prob = ba_mod.problem_from_map(state)
        cost_before = float(ba_mod._cost(prob))
        if run_ba:
            state, ba_stats = ba_mod.bundle_adjust_map(
                state, max_iterations=cfg.ba.max_iterations
            )
            self.stats.append(
                {
                    "event": "global_ba",
                    "cost_before": cost_before,
                    "cost_after": float(ba_stats.final_cost),
                }
            )
        self.state = state
        self.tracks = tracks
        self.track_valid = tvalid
        return state

    def final_sweep(
        self, images_gray: Sequence[np.ndarray], seed: int = 1
    ) -> MapState:
        """Per-adjacent-pair match + triangulation sweep (test.py:339-380):
        densifies the cloud using the bundle-adjusted poses."""
        cfg = self.config
        K = jnp.asarray(cfg.intrinsic_matrix())
        state = self.state
        key = jax.random.PRNGKey(seed)
        feats = [
            sift.detect_and_compute(jnp.asarray(g), cfg.frontend)
            for g in images_gray
        ]
        for i in range(len(feats) - 1):
            m = matching.knn_match(
                feats[i].desc, feats[i + 1].desc, feats[i].valid, feats[i + 1].valid,
                ratio=cfg.frontend.lowe_ratio,
            )
            uv0, uv1, mvalid = matching.gather_match_points(
                feats[i].xy, feats[i + 1].xy, m
            )
            p0 = state.poses[i]
            p1 = state.poses[i + 1]
            X = triangulation.triangulate_euclidean(K @ p0, K @ p1, uv0, uv1)
            d0, d1 = triangulation.triangulation_depths(p0, p1, X)
            e0 = jnp.linalg.norm(
                projection.reprojection_residuals(X, uv0, p0, K), axis=-1
            )
            e1 = jnp.linalg.norm(
                projection.reprojection_residuals(X, uv1, p1, K), axis=-1
            )
            good = (
                mvalid & (d0 > 0) & (d1 > 0)
                & (e0 < cfg.ransac.pnp_threshold_px)
                & (e1 < cfg.ransac.pnp_threshold_px)
            )
            gi = jnp.asarray(images_gray[i])
            Hh, Ww = gi.shape
            xi = jnp.clip(uv0[:, 0].astype(jnp.int32), 0, Ww - 1)
            yi = jnp.clip(uv0[:, 1].astype(jnp.int32), 0, Hh - 1)
            gval = gi[yi, xi] * 255.0
            colors = jnp.stack([gval, gval, gval], axis=-1)
            state, pids = map_store.append_points(state, X, colors, good)
            state = map_store.append_observations(state, i, pids, uv0, good)
            state = map_store.append_observations(state, i + 1, pids, uv1, good)
        self.state = state
        return state
