"""Essential/fundamental matrix estimation and pose recovery.

JAX replacement for ``cv2.findEssentialMat`` (sfm.py:307; the 5-point
Nister solver inside OpenCV's RANSAC) and ``cv2.recoverPose`` (sfm.py:311).

Design (SURVEY.md §7): the minimal solver is the normalized 8-point
algorithm with projection onto the essential manifold (equal singular
values, rank 2) — float32-friendly on normalized coordinates and exact
enough at the reference's inlier ratios. It is fully vmappable, so RANSAC
becomes thousands of simultaneous hypothesis solves (see ransac.py) instead
of OpenCV's sequential C++ loop. Pose recovery decomposes E into its 4
(R, t) candidates and selects by batched cheirality voting, exactly the
behavior of cv2.recoverPose.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sfm_mvs_tpu.ops import triangulation
from sfm_mvs_tpu.ops.projection import hartley_normalization


def essential_eight_point(
    pts1: jnp.ndarray,
    pts2: jnp.ndarray,
    weights: jnp.ndarray | None = None,
    method: str = "svd",
) -> jnp.ndarray:
    """Weighted 8-point essential matrix on *normalized camera* coordinates.

    pts1, pts2: (N, 2) normalized coords (pixels pre-multiplied by K^-1);
    weights: optional (N,) non-negative weights (0 masks a row out).
    Returns E: (3, 3) projected onto the essential manifold
    (singular values (1, 1, 0)).

    method: null-vector solver. "svd" of A directly is precise (forming
    the normal matrix squares the condition number and costs ~3 decimal
    digits in f32 — measured 1.3px vs 0.0005px max Sampson residual at
    f=1200); "eigh" of A^T A is cheaper. RANSAC uses
    "eigh" for its thousands of vmapped hypothesis solves (threshold-level
    precision suffices there) and "svd" for the few inlier refits.

    N may be the 8-point minimal sample or all inliers (for refit).
    """
    x1, y1 = pts1[:, 0], pts1[:, 1]
    x2, y2 = pts2[:, 0], pts2[:, 1]
    ones = jnp.ones_like(x1)
    # Epipolar constraint rows: x2^T E x1 = 0.
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], axis=-1
    )
    if weights is not None:
        A = A * weights[:, None]
    if method == "eigh":
        _, V = jnp.linalg.eigh(A.T @ A)
        E = V[:, 0].reshape(3, 3)
    else:
        _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
        E = Vt[-1].reshape(3, 3)
    # Project onto the essential manifold: singular values -> (1, 1, 0).
    U, _, Vt = jnp.linalg.svd(E)
    E = U @ jnp.diag(jnp.array([1.0, 1.0, 0.0], dtype=E.dtype)) @ Vt
    return E


def fundamental_eight_point(
    pts1: jnp.ndarray,
    pts2: jnp.ndarray,
    mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Hartley-normalized 8-point fundamental matrix on *pixel* coords.

    Rank-2 projection included. Returns F: (3, 3).
    """
    if mask is None:
        mask = jnp.ones(pts1.shape[0], dtype=bool)
    n1, T1 = hartley_normalization(pts1, mask)
    n2, T2 = hartley_normalization(pts2, mask)
    x1, y1 = n1[:, 0], n1[:, 1]
    x2, y2 = n2[:, 0], n2[:, 1]
    ones = jnp.ones_like(x1)
    A = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], axis=-1
    )
    A = A * mask.astype(A.dtype)[:, None]
    _, _, Vt0 = jnp.linalg.svd(A, full_matrices=True)
    F = Vt0[-1].reshape(3, 3)
    U, S, Vt = jnp.linalg.svd(F)
    S = S.at[2].set(0.0)
    F = U @ jnp.diag(S) @ Vt
    return T2.T @ F @ T1


def sampson_error(E: jnp.ndarray, pts1: jnp.ndarray, pts2: jnp.ndarray) -> jnp.ndarray:
    """First-order geometric (Sampson) distance per correspondence.

    E (or F): (3, 3); pts1, pts2: (N, 2) in the same coordinate frame as E.
    Returns (N,) squared Sampson distances.
    """
    x1 = jnp.concatenate([pts1, jnp.ones_like(pts1[:, :1])], axis=-1)  # (N,3)
    x2 = jnp.concatenate([pts2, jnp.ones_like(pts2[:, :1])], axis=-1)
    Ex1 = x1 @ E.T  # (N, 3) = (E @ x1^T)^T
    Etx2 = x2 @ E  # (N, 3) = (E^T @ x2^T)^T
    x2tEx1 = jnp.sum(x2 * Ex1, axis=-1)
    denom = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
    return (x2tEx1 * x2tEx1) / jnp.maximum(denom, 1e-12)


def epipolar_residual_pixels(
    E: jnp.ndarray, pts1: jnp.ndarray, pts2: jnp.ndarray, focal: jnp.ndarray
) -> jnp.ndarray:
    """Sampson distance (not squared) rescaled to ~pixels via the focal length.

    Used as the RANSAC residual so thresholds are directly comparable to the
    reference's pixel threshold (0.4 px, sfm.py:307).
    """
    return jnp.sqrt(sampson_error(E, pts1, pts2)) * focal


def decompose_essential(E: jnp.ndarray):
    """E -> the 4 candidate (R, t) relative poses.

    Returns (Rs: (4, 3, 3), ts: (4, 3)). t is unit-norm; candidates are
    (R1, +t), (R1, -t), (R2, +t), (R2, -t) per Hartley & Zisserman 9.6.2.
    """
    U, _, Vt = jnp.linalg.svd(E)
    # Enforce proper rotations.
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    Rs = jnp.stack([R1, R1, R2, R2])
    ts = jnp.stack([t, -t, t, -t])
    return Rs, ts


def refine_relative_pose(
    R0: jnp.ndarray,
    t0: jnp.ndarray,
    pts1: jnp.ndarray,
    pts2: jnp.ndarray,
    mask: jnp.ndarray,
    iters: int = 10,
    damping: float = 1e-8,
):
    """Gauss-Newton refinement of a relative pose on inlier Sampson error.

    Minimizes the squared Sampson distances of E(R, t) = [t]_x R over the
    5-dof pose manifold: 3 rotation parameters (left-multiplied axis-angle
    increment) + 2 translation-direction parameters (tangent basis of the
    unit sphere at t). This is the practical equivalent of a 5-point
    polish: it recovers minimal-parameterization accuracy from any
    initialization (8-point+cheirality or homography decomposition)
    without polynomial solvers. Steps that increase the masked SSE are
    rejected (1-step trust region), so the call never degrades its input.
    """
    from sfm_mvs_tpu.ops import lie  # local import to avoid cycles

    t0 = t0 / jnp.maximum(jnp.linalg.norm(t0), 1e-12)
    # Tangent basis of S^2 at t0.
    ref = jnp.where(jnp.abs(t0[0]) < 0.9, jnp.array([1.0, 0.0, 0.0], t0.dtype),
                    jnp.array([0.0, 1.0, 0.0], t0.dtype))
    b1 = jnp.cross(t0, ref)
    b1 = b1 / jnp.maximum(jnp.linalg.norm(b1), 1e-12)
    b2 = jnp.cross(t0, b1)
    m = mask.astype(R0.dtype)

    def unpack(p):
        R = lie.so3_exp(p[:3]) @ R0
        t = t0 + p[3] * b1 + p[4] * b2
        t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)
        return R, t

    def residuals(p):
        R, t = unpack(p)
        E = lie.hat(t) @ R
        return jnp.sqrt(sampson_error(E, pts1, pts2) + 1e-18) * m

    def sse(p):
        r = residuals(p)
        return jnp.sum(r * r)

    jac = jax.jacfwd(residuals)

    def step(_, p):
        r = residuals(p)
        J = jac(p)  # (N, 5)
        H = J.T @ J + damping * jnp.eye(5, dtype=R0.dtype)
        g = J.T @ r
        cand = p - jnp.linalg.solve(H, g)
        return jnp.where(sse(cand) < sse(p), cand, p)

    p = jax.lax.fori_loop(0, iters, step, jnp.zeros(5, R0.dtype))
    return unpack(p)


def decompose_homography(Hn: jnp.ndarray):
    """Faugeras SVD decomposition of a *normalized* homography.

    Hn maps normalized camera coords of view 1 to view 2 (Hn = K^-1 H_px
    K for pixel-frame H). Returns (Rs (4,3,3), ts (4,3), ns (4,3)): the
    four physical (R, t/d, n) candidates for the underlying plane motion
    x2 ~ (R + t n^T) x1. Callers disambiguate by plane-visibility
    (n_z > 0) and cheirality, exactly as recover_pose does for E.

    This is the planar-scene complement to the essential path: for (near-)
    planar scenes E is ambiguous but H is well-determined, so the
    bootstrap selects between them by inlier support (two_view.bootstrap).
    """
    U, d, Vt = jnp.linalg.svd(Hn)
    s = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    # Normalize so the middle singular value is 1.
    a = d1 / d2
    c = d3 / d2
    denom = jnp.maximum(a * a - c * c, 1e-12)
    x1 = jnp.sqrt(jnp.clip((a * a - 1.0) / denom, 0.0, 1.0))
    x3 = jnp.sqrt(jnp.clip((1.0 - c * c) / denom, 0.0, 1.0))
    sin_t = (a - c) * x1 * x3
    cos_t = a * x3 * x3 + c * x1 * x1

    V = Vt.T
    Rs, ts, ns = [], [], []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            st = e1 * e3 * sin_t
            Rp = jnp.array(
                [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                dtype=Hn.dtype,
            )
            Rp = Rp.at[0, 0].set(cos_t).at[2, 2].set(cos_t)
            Rp = Rp.at[0, 2].set(-st).at[2, 0].set(st)
            tp = (a - c) * jnp.stack([e1 * x1, 0.0, -e3 * x3])
            np_ = jnp.stack([e1 * x1, 0.0, e3 * x3])
            R = s * U @ Rp @ Vt
            t = U @ tp
            n = V @ np_
            # Plane must face camera 1: flip (t, n) so n_z > 0.
            flip = jnp.where(n[2] < 0, -1.0, 1.0)
            Rs.append(R)
            ts.append(t * flip)
            ns.append(n * flip)
    return jnp.stack(Rs), jnp.stack(ts), jnp.stack(ns)


def recover_pose_from_homography(
    Hn: jnp.ndarray,
    pts1: jnp.ndarray,
    pts2: jnp.ndarray,
    mask: jnp.ndarray,
):
    """Best (R, t) from a normalized homography by cheirality + reprojection.

    Same contract as recover_pose: pts in normalized camera coordinates.
    Returns (R, t, per-point positive-depth mask).
    """
    Rs, ts, _ = decompose_homography(Hn)
    P1 = jnp.concatenate(
        [jnp.eye(3, dtype=Hn.dtype), jnp.zeros((3, 1), Hn.dtype)], axis=1
    )

    def score(R, t):
        Rt2 = jnp.concatenate([R, t[:, None]], axis=1)
        X = triangulation.triangulate_euclidean(P1, Rt2, pts1, pts2)
        d1, d2 = triangulation.triangulation_depths(P1, Rt2, X)
        good = (d1 > 0) & (d2 > 0) & mask
        # tiebreak equal cheirality counts by reprojection agreement
        proj2 = X @ Rt2[:, :3].T + Rt2[:, 3]
        uv2 = proj2[:, :2] / jnp.where(
            jnp.abs(proj2[:, 2:3]) < 1e-9, 1e-9, proj2[:, 2:3]
        )
        err = jnp.sum(jnp.where(good, jnp.sum((uv2 - pts2) ** 2, axis=-1), 0.0))
        return good, jnp.sum(good).astype(jnp.float32) - 1e-3 * err

    goods, scores = [], []
    for k in range(4):
        g, sc = score(Rs[k], ts[k])
        goods.append(g)
        scores.append(sc)
    best = jnp.argmax(jnp.stack(scores))
    t_best = ts[best]
    # decompose_homography returns t/d (plane-distance scale); normalize to
    # match recover_pose's unit-translation convention.
    t_best = t_best / jnp.maximum(jnp.linalg.norm(t_best), 1e-12)
    return Rs[best], t_best, jnp.stack(goods)[best]


def recover_pose(
    E: jnp.ndarray,
    pts1: jnp.ndarray,
    pts2: jnp.ndarray,
    mask: jnp.ndarray,
):
    """Select the (R, t) candidate with the most points in front of both cams.

    pts1, pts2: (N, 2) *normalized camera* coordinates; mask: (N,) validity.
    Returns (R (3,3), t (3,), cheirality_mask (N,) — valid & positive-depth
    in both cameras under the winning pose). Matches cv2.recoverPose
    (sfm.py:311-313) including its output inlier mask semantics.
    """
    Rs, ts = decompose_essential(E)
    P1 = jnp.concatenate([jnp.eye(3, dtype=E.dtype), jnp.zeros((3, 1), E.dtype)], axis=1)

    def cheirality(R, t):
        Rt2 = jnp.concatenate([R, t[:, None]], axis=1)
        X = triangulation.triangulate_euclidean(P1, Rt2, pts1, pts2)
        d1, d2 = triangulation.triangulation_depths(P1, Rt2, X)
        good = (d1 > 0) & (d2 > 0) & mask
        return good, jnp.sum(good)

    goods, counts = [], []
    for k in range(4):
        g, c = cheirality(Rs[k], ts[k])
        goods.append(g)
        counts.append(c)
    counts = jnp.stack(counts)
    goods = jnp.stack(goods)
    best = jnp.argmax(counts)
    return Rs[best], ts[best], goods[best]
