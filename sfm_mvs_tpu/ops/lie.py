"""SO(3) / SE(3) Lie-group operations: closed-form axis-angle exp/log maps.

JAX replacement for ``cv2.Rodrigues`` (reference call sites:
sfm.py:69,84,119; test.py:73,98,251,305,320). Everything is branch-free
(``jnp.where`` with Taylor fallbacks near theta=0) so it is jit/vmap/grad
safe, unlike the C++ routine it replaces.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix [w]_x from a 3-vector. w: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zero, -wz, wy], axis=-1),
            jnp.stack([wz, zero, -wx], axis=-1),
            jnp.stack([-wy, wx, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of hat: (..., 3, 3) skew matrix -> (..., 3) vector."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Axis-angle rotation vector -> rotation matrix (Rodrigues formula).

    w: (..., 3). Returns (..., 3, 3). Uses 2nd-order Taylor expansions of
    sin(t)/t and (1-cos(t))/t^2 below _EPS so gradients stay finite at 0.
    """
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < _EPS
    # sin(t)/t and (1-cos(t))/t^2 with Taylor fallbacks.
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> axis-angle vector. R: (..., 3, 3) -> (..., 3).

    Valid on ALL of SO(3), including theta = pi. The antisymmetric-part
    formula (w = vee(R - R^T)/2 = sin(theta) * axis) collapses as
    sin(theta) -> 0 at theta = pi, where theta/sin(theta) amplifies f32
    noise unboundedly (round-5 field failure: a full-orbit camera at
    azimuth ~180 deg produced rvec norms of ~240 and the PnP polish
    diverged from a perfect pose — the replay-vs-pose.csv scene is
    exactly the geometry the docstring previously claimed "the pipeline
    never produces"). Near pi the axis comes from the SYMMETRIC part
    instead: R + I -> 2 n n^T as theta -> pi, so the largest column of
    R + I is the axis; the sign is aligned with the antisymmetric part
    while it is still meaningful (and is irrelevant AT pi, where +/- n
    give the same rotation).
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    w = vee(R - jnp.swapaxes(R, -1, -2)) * 0.5  # = sin(theta) * axis
    sin_theta = jnp.sin(theta)
    small = theta < 1e-4
    # theta / sin(theta) with Taylor fallback 1 + t^2/6.
    scale = jnp.where(
        small,
        1.0 + theta * theta / 6.0,
        theta / jnp.where(small, jnp.ones_like(sin_theta), sin_theta + _EPS),
    )
    v_std = w * scale[..., None]

    # theta ~ pi: axis^2 from the dominant column of S = R + I (~ 2nn^T).
    S = R + jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)
    col_norm2 = jnp.sum(S * S, axis=-2)  # (..., 3)
    j = jnp.argmax(col_norm2, axis=-1)
    onehot = jax.nn.one_hot(j, 3, dtype=R.dtype)  # (..., 3)
    n = jnp.sum(S * onehot[..., None, :], axis=-1)  # column j of S
    n = n / jnp.maximum(
        jnp.linalg.norm(n, axis=-1, keepdims=True), _EPS
    )
    # Align with the antisymmetric part where it still carries sign info.
    sgn = jnp.where(jnp.sum(n * w, axis=-1) < 0.0, -1.0, 1.0)
    v_pi = theta[..., None] * n * sgn[..., None]

    near_pi = theta > (jnp.pi - 1e-2)
    return jnp.where(near_pi[..., None], v_pi, v_std)


def rt_to_matrix(rvec: jnp.ndarray, tvec: jnp.ndarray) -> jnp.ndarray:
    """(rvec (...,3), tvec (...,3)) -> [R|t] (..., 3, 4)."""
    R = so3_exp(rvec)
    return jnp.concatenate([R, tvec[..., :, None]], axis=-1)


def matrix_to_rt(Rt: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """[R|t] (..., 3, 4) -> (rvec (...,3), tvec (...,3))."""
    return so3_log(Rt[..., :3, :3]), Rt[..., :3, 3]


def orthonormalize(R: jnp.ndarray) -> jnp.ndarray:
    """Project an approximate rotation onto SO(3) via SVD (det +1)."""
    U, _, Vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(U @ Vt)
    D = jnp.stack(
        [jnp.ones_like(det), jnp.ones_like(det), det], axis=-1
    )
    return (U * D[..., None, :]) @ Vt
