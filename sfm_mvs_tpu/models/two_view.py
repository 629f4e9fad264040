"""Two-view bootstrap: the reconstruction's initialization.

JAX equivalent of the reference's bootstrap block (sfm.py:300-325):
match features -> essential-matrix RANSAC -> pose recovery (SVD +
cheirality) -> pose composition with the reference frame -> DLT
triangulation -> reprojection audit -> (PnP re-registration is subsumed by
the Gauss-Newton polish inside our PnP). Everything below is one jitted
function over fixed-capacity masked arrays.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sfm_mvs_tpu.ops import epipolar, matching, projection, ransac, triangulation
from sfm_mvs_tpu.ops.sift import Features
from sfm_mvs_tpu.utils.config import SfmConfig


class TwoViewResult(NamedTuple):
    pose0: jnp.ndarray  # (3, 4) world->cam0 (identity by convention)
    pose1: jnp.ndarray  # (3, 4) world->cam1
    points: jnp.ndarray  # (M, 3) triangulated points (M = match capacity)
    uv0: jnp.ndarray  # (M, 2) pixel obs in image 0
    uv1: jnp.ndarray  # (M, 2) pixel obs in image 1
    idx0: jnp.ndarray  # (M,) feature slot in image 0
    idx1: jnp.ndarray  # (M,) feature slot in image 1
    valid: jnp.ndarray  # (M,) surviving correspondences
    num_matches: jnp.ndarray  # () ratio-test survivors
    num_inliers: jnp.ndarray  # () E-RANSAC inliers
    reproj_error: jnp.ndarray  # () mean reprojection error (reference metric)


@partial(jax.jit, static_argnames=("cfg",))
def bootstrap(
    key: jax.Array,
    feats0: Features,
    feats1: Features,
    K: jnp.ndarray,
    cfg: SfmConfig,
    pose0: jnp.ndarray | None = None,
) -> TwoViewResult:
    """Initialize from the first image pair.

    pose0 defaults to [I|0] (the reference's R_t_0, sfm.py:277); pose1 is
    composed as R1 = R_rel R0, t1 = t0 + R0 t_rel — matching the reference's
    chain (sfm.py:314-315).
    """
    fc, rc = cfg.frontend, cfg.ransac
    m = matching.match_with_config(
        feats0.desc, feats1.desc, feats0.valid, feats1.valid, fc
    )
    uv0, uv1, mvalid = matching.gather_match_points(feats0.xy, feats1.xy, m)
    n0 = projection.normalize_points(uv0, K)
    n1 = projection.normalize_points(uv1, K)
    focal = 0.5 * (K[0, 0] + K[1, 1])

    k_e, k_h = jax.random.split(key)
    res = ransac.ransac_essential(
        k_e, n0, n1, mvalid, focal,
        threshold_px=rc.essential_threshold_px, iters=rc.essential_iters,
        refit_rounds=rc.refit_rounds, solver=rc.essential_solver,
    )
    R_e, t_e, cheir_e = epipolar.recover_pose(res.model, n0, n1, res.inliers)

    # Model selection (ORB-SLAM style): for (near-)planar scenes the
    # essential matrix is ambiguous and its recovered pose bends the map
    # (measured: 12.8 deg rotation error on a shallow-relief scene). Fit a
    # homography on the same normalized correspondences; when it explains
    # clearly more matches, take the pose from its Faugeras decomposition.
    h_res = ransac.ransac_homography(
        k_h, n0, n1, mvalid,
        threshold_px=rc.essential_threshold_px / focal,
        iters=rc.homography_iters,
    )
    R_h, t_h, cheir_h = epipolar.recover_pose_from_homography(
        h_res.model, n0, n1, h_res.inliers
    )
    s_e = res.num_inliers.astype(jnp.float32)
    s_h = h_res.num_inliers.astype(jnp.float32)
    # Threshold: measured non-planar scenes top out at ratio ~0.38 and
    # planar ones start at ~0.45; 0.42 splits them with margin both ways.
    use_h = s_h > 0.42 * (s_h + s_e)
    R_rel = jnp.where(use_h, R_h, R_e)
    t_rel = jnp.where(use_h, t_h, t_e)
    cheir = jnp.where(use_h, cheir_h, cheir_e)
    inl = jnp.where(use_h, h_res.inliers, res.inliers)
    # Manifold polish: Gauss-Newton on inlier Sampson error over the 5-dof
    # (R, t-direction) parameterization — 5-point-level accuracy from the
    # linear initialization (epipolar.refine_relative_pose).
    R_rel, t_rel = epipolar.refine_relative_pose(
        R_rel, t_rel, n0, n1, inl & cheir
    )

    if pose0 is None:
        pose0 = jnp.concatenate(
            [jnp.eye(3, dtype=K.dtype), jnp.zeros((3, 1), K.dtype)], axis=1
        )
    R0 = pose0[:, :3]
    t0 = pose0[:, 3]
    R1 = R_rel @ R0
    t1 = t0 + R0 @ t_rel  # reference composition sfm.py:315
    pose1 = jnp.concatenate([R1, t1[:, None]], axis=1)

    P0 = K @ pose0
    P1 = K @ pose1
    X = triangulation.triangulate_euclidean(P0, P1, uv0, uv1)
    d0, d1 = triangulation.triangulation_depths(pose0, pose1, X)
    # Survivors: E-inliers, in front of both cameras, small reprojection.
    err1 = jnp.linalg.norm(projection.reprojection_residuals(X, uv1, pose1, K), axis=-1)
    err0 = jnp.linalg.norm(projection.reprojection_residuals(X, uv0, pose0, K), axis=-1)
    good = (
        cheir
        & (d0 > 0)
        & (d1 > 0)
        & (err0 < rc.pnp_threshold_px)
        & (err1 < rc.pnp_threshold_px)
    )
    mean_err = projection.masked_mean_reprojection_error(X, uv1, pose1, K, good)
    return TwoViewResult(
        pose0=pose0,
        pose1=pose1,
        points=X,
        uv0=uv0,
        uv1=uv1,
        idx0=m.idx0,
        idx1=m.idx1,
        valid=good,
        num_matches=jnp.sum(mvalid),
        num_inliers=res.num_inliers,
        reproj_error=mean_err,
    )
