"""Batched DLT triangulation.

JAX replacement for ``cv2.triangulatePoints`` (sfm.py:53;
test.py:310,367). Instead of a per-point C++ loop, the homogeneous DLT
system is solved for all correspondences at once: build the 4x4 A matrix
per point, take the eigenvector of A^T A with smallest eigenvalue via a
closed-form small solve (see :func:`triangulate_dlt`), all under jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _dlt_system(P1: jnp.ndarray, P2: jnp.ndarray, x1: jnp.ndarray, x2: jnp.ndarray):
    """Build the 4x4 DLT matrix for one correspondence.

    Rows: u1*P1_3 - P1_1 ; v1*P1_3 - P1_2 ; u2*P2_3 - P2_1 ; v2*P2_3 - P2_2.
    """
    return jnp.stack(
        [
            x1[0] * P1[2] - P1[0],
            x1[1] * P1[2] - P1[1],
            x2[0] * P2[2] - P2[0],
            x2[1] * P2[2] - P2[1],
        ]
    )


def triangulate_points(
    P1: jnp.ndarray,
    P2: jnp.ndarray,
    pts1: jnp.ndarray,
    pts2: jnp.ndarray,
) -> jnp.ndarray:
    """DLT-triangulate N correspondences.

    P1, P2: (3, 4) projection matrices. pts1, pts2: (N, 2) pixel coords.
    Returns homogeneous points (N, 4), scaled so the last component is 1
    (matching the reference's `cloud / cloud[3]`, sfm.py:54).

    Solved in INHOMOGENEOUS form: with X = (x, y, z, 1), the 4x2-row DLT
    system A X = 0 becomes the 3-unknown least squares A[:, :3] x = -A[:,
    3], closed via 3x3 normal equations and an adjugate inverse — pure
    elementwise math, no per-point eigendecompositions. Valid
    whenever the point is finite (w != 0), which the pipeline's depth
    filters assume anyway. Rows are normalized for f32 conditioning.
    """

    def solve_one(x1, x2):
        A = _dlt_system(P1, P2, x1, x2)
        # Row-normalize for conditioning (projection matrices contain pixel-
        # scale entries; unnormalized normal equations square that range).
        norm = jnp.linalg.norm(A, axis=1, keepdims=True)
        A = A / jnp.maximum(norm, 1e-12)
        M = A[:, :3]
        b = -A[:, 3]
        AtA = M.T @ M  # (3, 3)
        Atb = M.T @ b
        # Adjugate 3x3 solve.
        a, b_, c = AtA[0]
        d, e, f = AtA[1]
        g, h, i = AtA[2]
        c00 = e * i - f * h
        c01 = c * h - b_ * i
        c02 = b_ * f - c * e
        c10 = f * g - d * i
        c11 = a * i - c * g
        c12 = c * d - a * f
        c20 = d * h - e * g
        c21 = b_ * g - a * h
        c22 = a * e - b_ * d
        det = a * c00 + b_ * c10 + c * c20
        inv_det = jnp.where(jnp.abs(det) < 1e-18, 0.0, 1.0 / det)
        x = (
            jnp.stack(
                [
                    c00 * Atb[0] + c01 * Atb[1] + c02 * Atb[2],
                    c10 * Atb[0] + c11 * Atb[1] + c12 * Atb[2],
                    c20 * Atb[0] + c21 * Atb[1] + c22 * Atb[2],
                ]
            )
            * inv_det
        )
        return jnp.concatenate([x, jnp.ones((1,), x.dtype)])

    return jax.vmap(solve_one)(pts1, pts2)


def triangulate_euclidean(
    P1: jnp.ndarray, P2: jnp.ndarray, pts1: jnp.ndarray, pts2: jnp.ndarray
) -> jnp.ndarray:
    """Like :func:`triangulate_points` but returns Euclidean (N, 3)."""
    return triangulate_points(P1, P2, pts1, pts2)[..., :3]


def triangulation_depths(
    Rt1: jnp.ndarray, Rt2: jnp.ndarray, X: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Camera-frame depths of Euclidean points X (N,3) in both cameras."""
    d1 = X @ Rt1[2, :3] + Rt1[2, 3]
    d2 = X @ Rt2[2, :3] + Rt2[2, 3]
    return d1, d2
