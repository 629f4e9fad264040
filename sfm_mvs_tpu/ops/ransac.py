"""Vectorized RANSAC: one batched hypothesis-score-select engine.

Replaces OpenCV's sequential C++ RANSAC loops (``cv2.findEssentialMat``
sfm.py:307, ``cv2.solvePnPRansac`` sfm.py:67, ``cv2.findHomography``
test.py:259) with the batched idiom from SURVEY.md §7: draw ALL hypothesis
minimal samples at once, ``vmap`` the minimal solver over the hypothesis
batch, score every hypothesis against every correspondence as one dense
masked computation, and ``argmax`` the inlier count. Fixed shapes
throughout; validity is carried by masks. After selection, the model is
re-fit on its inliers (inlier-weighted least squares) for `refit_rounds`
rounds — the vectorized analog of OpenCV's final refinement.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sfm_mvs_tpu.ops import epipolar, five_point, homography, masking, p3p, pnp


class RansacResult(NamedTuple):
    model: jnp.ndarray  # best model parameters
    inliers: jnp.ndarray  # (N,) boolean inlier mask (in original order)
    num_inliers: jnp.ndarray  # scalar int


def _sample_indices(key, iters: int, sample_size: int, count: jnp.ndarray, capacity: int):
    """(iters, sample_size) int32 indices uniform in [0, count).

    Sampling is i.i.d. (collisions possible); a collided sample yields a
    degenerate hypothesis which simply loses the argmax — with thousands of
    hypotheses this costs nothing and avoids per-hypothesis top-k machinery.
    """
    u = jax.random.uniform(key, (iters, sample_size))
    cnt = jnp.maximum(count, sample_size).astype(u.dtype)
    idx = jnp.floor(u * cnt).astype(jnp.int32)
    return jnp.clip(idx, 0, capacity - 1)


def _select_and_count(residuals, mask, threshold):
    """residuals: (iters, N); mask: (N,). Returns (best_idx, counts)."""
    inl = (residuals < threshold) & mask[None, :]
    counts = jnp.sum(inl, axis=1)
    best = jnp.argmax(counts)
    return best, inl, counts


@partial(jax.jit, static_argnames=("iters", "solver"))
def ransac_essential(
    key,
    norm0: jnp.ndarray,
    norm1: jnp.ndarray,
    mask: jnp.ndarray,
    focal: jnp.ndarray,
    threshold_px: float = 1.0,
    iters: int = 2048,
    refit_rounds: int = 2,
    solver: str = "8pt",
) -> RansacResult:
    """Essential matrix via vmapped minimal-solver RANSAC.

    norm0, norm1: (N, 2) K^-1-normalized correspondences; mask: (N,) valid;
    focal: pixel focal length used to express Sampson distance in ~pixels so
    `threshold_px` is comparable to the reference's (0.4px at sfm.py:307 —
    we default 1.0 since the 8-point minimal solver is noisier than Nister's
    5-point but refit recovers the precision).

    solver: "8pt" (8-point + manifold projection — cheap, but degenerate on
    planar scenes), "5pt" (Nister minimal solver, the reference's actual
    OpenCV solver, five_point.py — exact on planar scenes and far more
    sample-efficient at low inlier ratios: each sample yields up to 10
    hypotheses, so `iters` samples score `10*iters` models), or "both"
    (joint hypothesis pool — 8pt's `iters` samples plus 5pt's `iters//4`
    samples scored together, the same multi-family design as ransac_pnp;
    the inlier count auto-selects whichever family fits the data, so
    small-N / planar / low-inlier pairs get Nister robustness while dense
    well-conditioned pairs keep the cheap 8pt winners).
    """
    N = norm0.shape[0]
    count, cmask, c0, c1 = masking.compact(mask, norm0, norm1)
    k1, k2 = jax.random.split(key)

    def hyps_5pt(key5, n_samples):
        idx = _sample_indices(key5, n_samples, 5, count, N)

        def solve5(sample_idx):
            return five_point.essential_five_point(
                c0[sample_idx], c1[sample_idx]
            )

        Es, valid = jax.vmap(solve5)(idx)  # (S, 10, 3, 3), (S, 10)
        return Es.reshape(-1, 3, 3), valid.reshape(-1)

    def hyps_8pt(key8, n_samples):
        idx = _sample_indices(key8, n_samples, 8, count, N)

        def solve(sample_idx):
            # SVD hypotheses: the eigh form's ~1.3px null-vector noise
            # exceeds the 1px inlier threshold and collapses small-baseline
            # pairs (measured: 134 matches -> 2 inliers). E is the one
            # solver whose threshold sits below eigh precision; PnP/H
            # hypotheses use eigh.
            return epipolar.essential_eight_point(
                c0[sample_idx], c1[sample_idx]
            )

        Es = jax.vmap(solve)(idx)  # (S, 3, 3)
        return Es, jnp.ones(Es.shape[0], bool)

    if solver == "5pt":
        Es, hyp_valid = hyps_5pt(k1, iters)
    elif solver == "both":
        E8, v8 = hyps_8pt(k1, iters)
        E5, v5 = hyps_5pt(k2, max(iters // 4, 1))
        Es = jnp.concatenate([E8, E5], axis=0)
        hyp_valid = jnp.concatenate([v8, v5], axis=0)
    else:
        Es, _ = hyps_8pt(k1, iters)
        hyp_valid = None

    def score(E):
        return epipolar.epipolar_residual_pixels(E, norm0, norm1, focal)

    residuals = jax.vmap(score)(Es)  # (hyps, N)
    inl = (residuals < threshold_px) & mask[None, :]
    counts = jnp.sum(inl, axis=1)
    if hyp_valid is not None:
        counts = jnp.where(hyp_valid, counts, -1)
    best = jnp.argmax(counts)
    E = Es[best]
    # If every hypothesis was invalid (possible with the gated 5pt solver),
    # argmax picked an arbitrary slot: report zero inliers so callers'
    # rejection guards trigger, and skip the refit (an all-zero-weight
    # 8-point refit is an SVD of the zero matrix -> NaN E).
    any_valid = counts[best] >= 0
    inliers = inl[best] & any_valid

    # Inlier-weighted refits (all correspondences, weights = inlier mask).
    # Guarded STRICTLY: the 8-point refit is degenerate on planar inlier
    # sets (>=3-dim null space of the design matrix), where a wrong-family
    # E can fit every planar inlier and TIE the count — a tie must keep
    # the minimal-solver E, so only a strict inlier gain accepts the refit.
    def refit(_, carry):
        E, inliers = carry
        w = inliers.astype(norm0.dtype)
        E2 = epipolar.essential_eight_point(norm0, norm1, w)
        res2 = epipolar.epipolar_residual_pixels(E2, norm0, norm1, focal)
        inl2 = (res2 < threshold_px) & mask
        better = jnp.sum(inl2) > jnp.sum(inliers)
        return (jnp.where(better, E2, E), jnp.where(better, inl2, inliers))

    E, inliers = jax.lax.fori_loop(0, refit_rounds, refit, (E, inliers))
    return RansacResult(E, inliers, jnp.sum(inliers))


@partial(jax.jit, static_argnames=("iters", "refine_iters", "use_p3p"))
def ransac_pnp(
    key,
    X: jnp.ndarray,
    uv_pix: jnp.ndarray,
    uv_norm: jnp.ndarray,
    mask: jnp.ndarray,
    K: jnp.ndarray,
    threshold_px: float = 4.0,
    iters: int = 1024,
    refine_iters: int = 10,
    use_p3p: bool = True,
) -> RansacResult:
    """Pose via vmapped multi-family minimal-solver RANSAC + GN polish.

    X: (N, 3) world points; uv_pix: (N, 2) pixels; uv_norm: K^-1 pixels.
    Returns model = Rt (3, 4).
    """
    N = X.shape[0]
    count, cmask, cX, cuvn = masking.compact(mask, X, uv_norm)
    k1, k2 = jax.random.split(key)
    idx = _sample_indices(k1, iters, 6, count, N)

    # Three hypothesis families per batch, scored jointly; inlier counting
    # picks the winner:
    #  - 6-point 12-dof DLT (general; degenerate for coplanar samples),
    #  - planar homography decomposition (exact for coplanar samples),
    #  - 3-point Grunert P3P (w^3 vs w^6 all-inlier sample odds — dominates
    #    on contaminated correspondence sets; up to 6 pose slots/sample).
    def solve_dlt(sample_idx):
        return pnp.pnp_dlt(cX[sample_idx], cuvn[sample_idx], method="inviter")

    def solve_planar(sample_idx):
        return pnp.pnp_planar(cX[sample_idx], cuvn[sample_idx], method="inviter")

    Rts = jnp.concatenate(
        [jax.vmap(solve_dlt)(idx), jax.vmap(solve_planar)(idx)], axis=0
    )  # (2*iters, 3, 4)
    hyp_valid = jnp.ones(Rts.shape[0], bool)

    if use_p3p:
        idx3 = _sample_indices(k2, max(iters // 4, 1), 3, count, N)

        def solve_p3p(sample_idx):
            return p3p.p3p_grunert(cX[sample_idx], cuvn[sample_idx])

        Rts3, valid3 = jax.vmap(solve_p3p)(idx3)  # (S, 6, 3, 4), (S, 6)
        Rts = jnp.concatenate([Rts, Rts3.reshape(-1, 3, 4)], axis=0)
        hyp_valid = jnp.concatenate([hyp_valid, valid3.reshape(-1)], axis=0)

    def score(Rt):
        return pnp.pnp_residual_pixels(Rt, X, uv_pix, K)

    residuals = jax.vmap(score)(Rts)
    inl = (residuals < threshold_px) & mask[None, :]
    counts = jnp.where(hyp_valid, jnp.sum(inl, axis=1), -1)
    best = jnp.argmax(counts)
    Rt = Rts[best]
    inliers = inl[best]

    # Gauss-Newton polish + reclassification rounds (no DLT refit: it
    # would re-enter the planar degeneracy; GN is degeneracy-free).
    # Each round is GUARDED against CATASTROPHIC divergence: a polish
    # that loses more than half the consensus is rejected and the
    # pre-polish pose kept (round 5: the theta~pi log-map defect made GN
    # diverge from a perfect 161/161-inlier pose and the reclassify
    # zeroed the result). The guard is deliberately loose — a refined
    # pose routinely reclassifies a borderline pixel or two out of the
    # threshold band while being geometrically BETTER, so requiring a
    # non-decreasing count would reject genuinely improved poses
    # (measured: the KLT variant's max rotation error regressed
    # 1.3 -> 1.58 deg under a strict >= guard).
    for _ in range(2):
        Rt2 = pnp.refine_pose_gauss_newton(
            Rt, X, uv_pix, inliers, K, iters=refine_iters
        )
        res2 = pnp.pnp_residual_pixels(Rt2, X, uv_pix, K)
        inl2 = (res2 < threshold_px) & mask
        keep = jnp.sum(inl2) * 2 >= jnp.sum(inliers)
        Rt = jnp.where(keep, Rt2, Rt)
        inliers = jnp.where(keep, inl2, inliers)
    return RansacResult(Rt, inliers, jnp.sum(inliers))


@partial(jax.jit, static_argnames=("iters",))
def ransac_homography(
    key,
    pts1: jnp.ndarray,
    pts2: jnp.ndarray,
    mask: jnp.ndarray,
    threshold_px: float = 4.0,
    iters: int = 1024,
    refit_rounds: int = 2,
) -> RansacResult:
    """Homography via vmapped 4-point DLT RANSAC. pts in pixels."""
    N = pts1.shape[0]
    count, cmask, c1, c2 = masking.compact(mask, pts1, pts2)
    k1, _ = jax.random.split(key)
    idx = _sample_indices(k1, iters, 4, count, N)

    def solve(sample_idx):
        return homography.homography_dlt(
            c1[sample_idx], c2[sample_idx], method="inviter"
        )

    Hs = jax.vmap(solve)(idx)

    def score(H):
        return homography.transfer_error(H, pts1, pts2)

    residuals = jax.vmap(score)(Hs)
    best, inl, counts = _select_and_count(residuals, mask, threshold_px)
    H = Hs[best]
    inliers = inl[best]

    def refit(_, carry):
        H, inliers = carry
        H = homography.homography_dlt(pts1, pts2, inliers.astype(pts1.dtype))
        res = homography.transfer_error(H, pts1, pts2)
        return H, (res < threshold_px) & mask

    H, inliers = jax.lax.fori_loop(0, refit_rounds, refit, (H, inliers))
    return RansacResult(H, inliers, jnp.sum(inliers))
