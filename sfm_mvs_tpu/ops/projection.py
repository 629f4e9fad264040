"""Pinhole projection and homogeneous-coordinate kernels.

JAX replacement for ``cv2.projectPoints`` (sfm.py:88,121),
``cv2.convertPointsFromHomogeneous`` / ``ToHomogeneous`` (sfm.py:86,351;
test.py:19,22) and the reference's mean-reprojection audit
(``ReprojectionError``, sfm.py:79-100). All point arrays are fixed-capacity
with boolean validity masks so the whole pipeline stays jit-compatible.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-12


def to_homogeneous(pts: jnp.ndarray) -> jnp.ndarray:
    """(..., D) -> (..., D+1) by appending ones."""
    return jnp.concatenate([pts, jnp.ones_like(pts[..., :1])], axis=-1)


def from_homogeneous(pts: jnp.ndarray) -> jnp.ndarray:
    """(..., D+1) -> (..., D) by dividing by the last coordinate."""
    w = pts[..., -1:]
    return pts[..., :-1] / jnp.where(jnp.abs(w) < _EPS, _EPS, w)


def compose_projection(K: jnp.ndarray, Rt: jnp.ndarray) -> jnp.ndarray:
    """P = K [R|t]. K: (..., 3, 3), Rt: (..., 3, 4) -> (..., 3, 4)."""
    return K @ Rt


def distort_normalized(xy: jnp.ndarray, dist: jnp.ndarray) -> jnp.ndarray:
    """Apply radial distortion in normalized camera coords.

    xy: (..., 2) ideal normalized coords; dist: (2,) = (k1, k2) — the
    radial model the reference threads through cv2.solvePnPRansac /
    projectPoints (sfm.py:67,88) and the notebook's 9-param camera
    (rvec, t, f, k1, k2). x_d = x * (1 + k1 r^2 + k2 r^4).
    """
    r2 = jnp.sum(xy * xy, axis=-1, keepdims=True)
    return xy * (1.0 + dist[0] * r2 + dist[1] * r2 * r2)


def undistort_normalized(
    xy_d: jnp.ndarray, dist: jnp.ndarray, iters: int = 5
) -> jnp.ndarray:
    """Invert :func:`distort_normalized` by fixed-point iteration.

    Standard cv2.undistortPoints scheme: x <- x_d / (1 + k1 r^2(x) + k2
    r^4(x)), converges in a handful of iterations for |k r^2| << 1.
    """
    xy = xy_d
    for _ in range(iters):
        r2 = jnp.sum(xy * xy, axis=-1, keepdims=True)
        f = 1.0 + dist[0] * r2 + dist[1] * r2 * r2
        xy = xy_d / jnp.where(jnp.abs(f) < _EPS, _EPS, f)
    return xy


def undistort_pixels(
    pts: jnp.ndarray, K: jnp.ndarray, dist: jnp.ndarray, iters: int = 5
) -> jnp.ndarray:
    """Observed (distorted) pixels -> ideal pinhole pixels.

    Front-door correction: applied once to detected keypoints, it makes
    every downstream stage (E-RANSAC, triangulation, PnP, BA, MVS rays)
    consistent with the pure pinhole model — the same factorization as
    undistorting the images, at keypoint rather than pixel cost.
    """
    xn = normalize_points(pts, K)
    xu = undistort_normalized(xn, dist, iters=iters)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    return jnp.stack(
        [xu[..., 0] * fx + cx, xu[..., 1] * fy + cy], axis=-1
    )


def project(
    points: jnp.ndarray,
    Rt: jnp.ndarray,
    K: jnp.ndarray,
    dist: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Project world points into pixel coordinates.

    points: (N, 3); Rt: (3, 4); K: (3, 3); dist: optional (2,) = (k1, k2)
    radial coefficients. Equivalent to cv2.projectPoints (sfm.py:88) —
    with zero distortion when dist is None.
    """
    Xc = points @ Rt[:3, :3].T + Rt[:3, 3]
    if dist is None:
        return from_homogeneous(Xc @ K.T)
    z = Xc[..., 2:]
    xy = Xc[..., :2] / jnp.where(jnp.abs(z) < _EPS, _EPS, z)
    xd = distort_normalized(xy, dist)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    return jnp.stack(
        [xd[..., 0] * fx + cx, xd[..., 1] * fy + cy], axis=-1
    )


def project_depth(points: jnp.ndarray, Rt: jnp.ndarray, K: jnp.ndarray):
    """Like :func:`project` but also returns the camera-frame depth (N,)."""
    Xc = points @ Rt[:3, :3].T + Rt[:3, 3]
    uv = Xc @ K.T
    return from_homogeneous(uv), Xc[..., 2]


def reprojection_residuals(
    points: jnp.ndarray, observed: jnp.ndarray, Rt: jnp.ndarray, K: jnp.ndarray
) -> jnp.ndarray:
    """Per-point 2D pixel residual (projected - observed). (N, 2)."""
    return project(points, Rt, K) - observed


def masked_mean_reprojection_error(
    points: jnp.ndarray,
    observed: jnp.ndarray,
    Rt: jnp.ndarray,
    K: jnp.ndarray,
    mask: jnp.ndarray,
) -> jnp.ndarray:
    """Mean L2 pixel reprojection error over valid entries.

    Matches the reference audit semantics (sfm.py:93-97: cv2.norm(...,
    NORM_L2)/len = sqrt(sum of squared coordinate diffs) / N) — NOT the mean
    of per-point L2 norms. Kept bug-compatible so printed errors are directly
    comparable to the reference's.
    """
    res = reprojection_residuals(points, observed, Rt, K)
    sq = jnp.sum(jnp.where(mask[:, None], res * res, 0.0))
    n = jnp.maximum(jnp.sum(mask), 1)
    return jnp.sqrt(sq) / n


def masked_rms_reprojection_error(
    points: jnp.ndarray,
    observed: jnp.ndarray,
    Rt: jnp.ndarray,
    K: jnp.ndarray,
    mask: jnp.ndarray,
) -> jnp.ndarray:
    """RMS per-point reprojection error in pixels (the standard SfM metric)."""
    res = reprojection_residuals(points, observed, Rt, K)
    sq = jnp.sum(jnp.where(mask[:, None], res * res, 0.0), axis=-1)
    n = jnp.maximum(jnp.sum(mask), 1)
    return jnp.sqrt(jnp.sum(jnp.where(mask, sq, 0.0)) / n)


def normalize_points(pts: jnp.ndarray, K: jnp.ndarray) -> jnp.ndarray:
    """Pixel coords -> normalized camera coords via K^{-1}. pts: (N, 2)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    skew = K[0, 1]
    y = (pts[..., 1] - cy) / fy
    x = (pts[..., 0] - cx - skew * y) / fx
    return jnp.stack([x, y], axis=-1)


def hartley_normalization(pts: jnp.ndarray, mask: jnp.ndarray):
    """Similarity transform T s.t. T*pts has zero mean and RMS distance sqrt(2).

    Standard conditioning for DLT / 8-point in float32. pts: (N, 2),
    mask: (N,). Returns (pts_normalized (N,2), T (3,3)).
    """
    m = mask.astype(pts.dtype)[:, None]
    n = jnp.maximum(jnp.sum(m), 1.0)
    mean = jnp.sum(pts * m, axis=0) / n
    centered = pts - mean
    rms = jnp.sqrt(jnp.sum(jnp.sum(centered * centered, axis=-1) * m[:, 0]) / n)
    scale = jnp.sqrt(2.0) / jnp.maximum(rms, _EPS)
    T = jnp.array(
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], dtype=pts.dtype
    )
    T = T.at[0, 0].set(scale).at[1, 1].set(scale)
    T = T.at[0, 2].set(-scale * mean[0]).at[1, 2].set(-scale * mean[1])
    return centered * scale, T
