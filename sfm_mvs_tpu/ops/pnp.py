"""Perspective-n-Point: DLT minimal solver + Gauss-Newton refinement.

JAX replacement for ``cv2.solvePnPRansac(..., SOLVEPNP_ITERATIVE)``
(sfm.py:67; test.py:319). The minimal solver is a 6-point DLT for the
projection matrix on normalized image coordinates with 3D-point
conditioning — fully vmappable so RANSAC runs thousands of hypotheses in
one batched solve (ransac.py). The winner is polished by a damped
Gauss-Newton on the 6-dof (axis-angle, translation) parameterization with
jit-compatible fixed iteration count, replacing OpenCV's iterative LM.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sfm_mvs_tpu.ops import lie, linalg, projection


def pnp_dlt(
    X: jnp.ndarray, uv_norm: jnp.ndarray, weights: jnp.ndarray | None = None,
    method: str = "svd",
):
    """DLT pose from n>=6 3D-2D correspondences (normalized image coords).

    X: (N, 3) world points; uv_norm: (N, 2) = K^-1-normalized pixels;
    weights: optional (N,) row weights (0 masks out).
    Returns Rt: (3, 4) with R orthonormalized onto SO(3) and cheirality-
    corrected sign (majority positive depth).
    """
    # Condition the 3D points: zero mean, RMS norm sqrt(3).
    w = jnp.ones(X.shape[0], X.dtype) if weights is None else weights
    wsum = jnp.maximum(jnp.sum(w), 1e-6)
    mean = jnp.sum(X * w[:, None], axis=0) / wsum
    Xc = X - mean
    rms = jnp.sqrt(jnp.sum(jnp.sum(Xc * Xc, axis=-1) * w) / wsum)
    s = jnp.sqrt(3.0) / jnp.maximum(rms, 1e-9)
    Xn = Xc * s

    x, y, z = Xn[:, 0], Xn[:, 1], Xn[:, 2]
    u, v = uv_norm[:, 0], uv_norm[:, 1]
    one = jnp.ones_like(x)
    zero = jnp.zeros_like(x)
    row_u = jnp.stack(
        [x, y, z, one, zero, zero, zero, zero, -u * x, -u * y, -u * z, -u], axis=-1
    )
    row_v = jnp.stack(
        [zero, zero, zero, zero, x, y, z, one, -v * x, -v * y, -v * z, -v], axis=-1
    )
    A = jnp.concatenate([row_u * w[:, None], row_v * w[:, None]], axis=0)
    if method == "inviter":
        # Cheapest null vector for vmapped RANSAC hypotheses: damped
        # inverse iteration (ops/linalg.py). The GN polish restores full
        # accuracy downstream.
        P = linalg.smallest_eigvec(A.T @ A).reshape(3, 4)
    elif method == "eigh":
        _, V = jnp.linalg.eigh(A.T @ A)
        P = V[:, 0].reshape(3, 4)
    else:
        _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
        P = Vt[-1].reshape(3, 4)

    # Undo the 3D conditioning: X_n = s*(X - mean)  =>  P_orig = P @ S.
    S = jnp.concatenate(
        [
            jnp.concatenate([s * jnp.eye(3, dtype=X.dtype), (-s * mean)[:, None]], axis=1),
            jnp.array([[0.0, 0.0, 0.0, 1.0]], dtype=X.dtype),
        ],
        axis=0,
    )
    P = P @ S

    # Fix global sign by majority cheirality (weighted).
    depths = X @ P[2, :3] + P[2, 3]
    sign = jnp.sign(jnp.sum(jnp.sign(depths) * w))
    sign = jnp.where(sign == 0, 1.0, sign)
    P = P * sign

    # Factor out scale and project M onto SO(3).
    M = P[:, :3]
    scale = jnp.exp(jnp.mean(jnp.log(jnp.maximum(jnp.linalg.svd(M, compute_uv=False), 1e-12))))
    R = lie.orthonormalize(M / scale)
    t = P[:, 3] / scale
    return jnp.concatenate([R, t[:, None]], axis=1)


def pnp_planar(
    X: jnp.ndarray, uv_norm: jnp.ndarray, weights: jnp.ndarray | None = None,
    method: str = "svd",
) -> jnp.ndarray:
    """Pose from a world-plane homography (planar-degenerate-safe PnP).

    The 12-dof DLT (:func:`pnp_dlt`) is structurally rank-deficient when
    the 3D points are (near-)coplanar — the classic planar PnP degeneracy.
    This solver fits the dominant plane of the sample by weighted PCA,
    estimates the homography from in-plane coordinates to normalized image
    coordinates (4+ points suffice), and decomposes H = s [R e1 | R e2 |
    R m + t] into a pose (Zhang-style). Exact for coplanar points, a
    reasonable hypothesis otherwise; RANSAC runs both families and lets
    inlier counting pick (ransac.ransac_pnp).
    """
    w = jnp.ones(X.shape[0], X.dtype) if weights is None else weights
    wsum = jnp.maximum(jnp.sum(w), 1e-6)
    mean = jnp.sum(X * w[:, None], axis=0) / wsum
    Xc = X - mean
    cov = (Xc * w[:, None]).T @ Xc / wsum
    evals, evecs = jnp.linalg.eigh(cov)  # ascending
    e1 = evecs[:, 2]
    e2 = evecs[:, 1]
    pu = Xc @ e1
    pv = Xc @ e2
    from sfm_mvs_tpu.ops.homography import homography_dlt

    H = homography_dlt(jnp.stack([pu, pv], axis=-1), uv_norm, w, method=method)
    # Choose the sign that puts the plane in front of the camera.
    H = H * jnp.where(H[2, 2] > 0, 1.0, -1.0)
    h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
    n1 = jnp.linalg.norm(h1)
    n2 = jnp.linalg.norm(h2)
    s = jnp.sqrt(jnp.maximum(n1 * n2, 1e-12))
    r1 = h1 / jnp.maximum(n1, 1e-12)
    r2 = h2 - jnp.dot(r1, h2) * r1
    r2 = r2 / jnp.maximum(jnp.linalg.norm(r2), 1e-12)
    r3 = jnp.cross(r1, r2)
    # R maps world->cam with R e1 = r1, R e2 = r2, R e3 = r3.
    e3 = jnp.cross(e1, e2)
    E = jnp.stack([e1, e2, e3], axis=1)  # world basis as columns
    R = jnp.stack([r1, r2, r3], axis=1) @ E.T
    R = lie.orthonormalize(R)
    t = h3 / s - R @ mean
    return jnp.concatenate([R, t[:, None]], axis=1)


def refine_pose_gauss_newton(
    Rt: jnp.ndarray,
    X: jnp.ndarray,
    uv_pix: jnp.ndarray,
    mask: jnp.ndarray,
    K: jnp.ndarray,
    iters: int = 10,
    damping: float = 1e-6,
    dist: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Damped Gauss-Newton polish of a pose on masked reprojection error.

    Rt: (3,4) initial pose; X: (N,3); uv_pix: (N,2) pixels; mask: (N,).
    Fixed iteration count (jit-friendly); each step solves the 6x6 normal
    equations built from the analytic (AD) Jacobian. A step is rejected
    (identity update) if it increases the masked SSE — a 1-step
    trust-region in the spirit of LM. With `dist` = (k1, k2), residuals
    use the DISTORTED projection against raw observations — matching
    cv2.solvePnPRansac's handling of distortion coefficients (sfm.py:67).
    """
    rvec0, tvec0 = lie.matrix_to_rt(Rt)
    m = mask.astype(Rt.dtype)

    def residuals(params):
        rvec, tvec = params[:3], params[3:]
        pose = lie.rt_to_matrix(rvec, tvec)
        res = projection.project(X, pose, K, dist=dist) - uv_pix
        return (res * m[:, None]).reshape(-1)

    def sse(params):
        r = residuals(params)
        return jnp.sum(r * r)

    jac_fn = jax.jacfwd(residuals)

    def step(_, params):
        r = residuals(params)
        J = jac_fn(params)  # (2N, 6)
        H = J.T @ J + damping * jnp.eye(6, dtype=Rt.dtype)
        g = J.T @ r
        delta = jnp.linalg.solve(H, g)
        new_params = params - delta
        better = sse(new_params) < sse(params)
        return jnp.where(better, new_params, params)

    params = jnp.concatenate([rvec0, tvec0])
    params = jax.lax.fori_loop(0, iters, step, params)
    return lie.rt_to_matrix(params[:3], params[3:])


def pnp_residual_pixels(
    Rt: jnp.ndarray,
    X: jnp.ndarray,
    uv_pix: jnp.ndarray,
    K: jnp.ndarray,
    dist: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Per-point reprojection distance in pixels (N,). RANSAC residual.

    With `dist` = (k1, k2), projection is distorted to match raw
    (uncorrected) observations, like cv2.solvePnPRansac (sfm.py:67).
    """
    res = projection.project(X, Rt, K, dist=dist) - uv_pix
    return jnp.linalg.norm(res, axis=-1)
