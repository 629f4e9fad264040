"""Homography estimation (4-point DLT) + transfer error.

JAX replacement for ``cv2.findHomography`` (test.py:259, used by the
track-based global-SfM variant to chain keypoints across frames). Fully
vmappable: RANSAC runs batched hypothesis solves (see ransac.py).
"""

from __future__ import annotations

import jax.numpy as jnp

from sfm_mvs_tpu.ops import linalg


def homography_dlt(
    pts1: jnp.ndarray, pts2: jnp.ndarray, weights: jnp.ndarray | None = None,
    method: str = "svd",
) -> jnp.ndarray:
    """DLT homography H s.t. pts2 ~ H pts1 from n>=4 correspondences.

    pts1, pts2: (N, 2); weights: optional (N,). Returns (3, 3), H[2,2]-ish
    scale left as unit-norm vector (callers use transfer error, which is
    scale-invariant).
    """
    w = jnp.ones(pts1.shape[0], pts1.dtype) if weights is None else weights
    wsum = jnp.maximum(jnp.sum(w), 1e-6)

    def condition(p):
        mean = jnp.sum(p * w[:, None], axis=0) / wsum
        c = p - mean
        rms = jnp.sqrt(jnp.sum(jnp.sum(c * c, axis=-1) * w) / wsum)
        s = jnp.sqrt(2.0) / jnp.maximum(rms, 1e-9)
        T = jnp.array(
            [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], dtype=p.dtype
        )
        T = T.at[0, 0].set(s).at[1, 1].set(s)
        T = T.at[0, 2].set(-s * mean[0]).at[1, 2].set(-s * mean[1])
        return c * s, T

    n1, T1 = condition(pts1)
    n2, T2 = condition(pts2)
    x1, y1 = n1[:, 0], n1[:, 1]
    x2, y2 = n2[:, 0], n2[:, 1]
    one = jnp.ones_like(x1)
    zero = jnp.zeros_like(x1)
    row1 = jnp.stack(
        [zero, zero, zero, -x1, -y1, -one, y2 * x1, y2 * y1, y2], axis=-1
    )
    row2 = jnp.stack(
        [x1, y1, one, zero, zero, zero, -x2 * x1, -x2 * y1, -x2], axis=-1
    )
    A = jnp.concatenate([row1 * w[:, None], row2 * w[:, None]], axis=0)
    if method == "inviter":
        # Damped inverse iteration (ops/linalg.py) — the fast path for
        # vmapped RANSAC hypothesis batches.
        Hn = linalg.smallest_eigvec(A.T @ A).reshape(3, 3)
    elif method == "eigh":
        _, V = jnp.linalg.eigh(A.T @ A)
        Hn = V[:, 0].reshape(3, 3)
    else:
        _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
        Hn = Vt[-1].reshape(3, 3)
    H = jnp.linalg.inv(T2) @ Hn @ T1
    return H / jnp.maximum(jnp.abs(H[2, 2]), 1e-12) * jnp.sign(H[2, 2])


def transfer_error(H: jnp.ndarray, pts1: jnp.ndarray, pts2: jnp.ndarray) -> jnp.ndarray:
    """Forward transfer distance |H p1 - p2| in pixels. (N,)."""
    h = jnp.concatenate([pts1, jnp.ones_like(pts1[:, :1])], axis=-1) @ H.T
    proj = h[:, :2] / jnp.where(jnp.abs(h[:, 2:3]) < 1e-12, 1e-12, h[:, 2:3])
    return jnp.linalg.norm(proj - pts2, axis=-1)


def apply_homography(H: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Warp 2D points by H. (N, 2) -> (N, 2)."""
    h = jnp.concatenate([pts, jnp.ones_like(pts[:, :1])], axis=-1) @ H.T
    return h[:, :2] / jnp.where(jnp.abs(h[:, 2:3]) < 1e-12, 1e-12, h[:, 2:3])
