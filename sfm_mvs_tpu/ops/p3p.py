"""Perspective-3-Point minimal solver (Grunert 1841 quartic form).

A third hypothesis family for PnP RANSAC (ransac.ransac_pnp) alongside the
6-point DLT and the planar-homography solver. Three-point minimal samples
dominate on contaminated correspondence sets: at inlier ratio w the odds of
an all-inlier sample are w^3 vs the DLT's w^6 — at w=0.5 that is 8x more
effective hypotheses per batch, which lets the driver hold `pnp_iters` low.
The reference's RANSAC resector is ``cv2.solvePnPRansac`` (sfm.py:67);
OpenCV's RANSAC likewise draws minimal samples (its iterative model uses
4+, P3P is its dedicated minimal solver family).

Static-shape discipline mirrors ops/five_point.py: the quartic's real roots
are extracted with fixed-shape sign-change bracketing + bisection on a
tan-spaced grid over v > 0 (depth ratios are positive), plus local-minimum
slots for near-double roots; every slot carries a validity flag, and
invalid hypotheses simply lose the RANSAC argmax.

Derivation (law of cosines on the camera-point triangle; Haralick et al.,
"Review and Analysis of Solutions of the Three Point Perspective Pose
Estimation Problem"): with depths d_i along unit bearings f_i and
inter-point distances a=|X2-X3|, b=|X1-X3|, c=|X1-X2|, setting
u = d2/d1, v = d3/d1 eliminates d1 and then u, leaving a quartic in v.
Each real root gives depths, camera-frame points d_i f_i, and the pose by
exact 3-point rigid alignment (Kabsch).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

N_P3P_SLOTS = 6  # 4 sign-change brackets + 2 near-double-root candidates


def _polyval(coeffs, z):
    acc = jnp.zeros_like(z) + coeffs[..., 0]
    for k in range(1, coeffs.shape[-1]):
        acc = acc * z + coeffs[..., k]
    return acc


def _real_roots_quartic_pos(coeffs, grid: int = 256, bisect_iters: int = 30,
                            newton_iters: int = 2):
    """Positive real-root candidates of a quartic (coeffs (5,), highest
    first). Returns (roots (6,), valid (6,)).

    tan-spaced grid over (0, inf) — depth ratios are positive by
    construction, so negative roots are never geometrically useful. Slots
    4..5 are the two deepest non-crossing local minima of |p| (near-double
    roots merged by f32 coefficient noise, e.g. symmetric configurations).
    """
    dtype = coeffs.dtype
    scale = jnp.maximum(jnp.max(jnp.abs(coeffs)), 1e-30)
    c = coeffs / scale

    theta = jnp.linspace(1e-3, jnp.pi / 2 - 1e-3, grid, dtype=dtype)
    zs = jnp.tan(theta)
    # Overflow-safe sign evaluation: for z>1 use the reversed polynomial at
    # 1/z (p(z) = z^4 p_rev(1/z), z^4 > 0).
    c_rev = c[::-1]

    def safe_eval(z):
        inner = z <= 1.0
        zi = jnp.where(inner, z, 1.0 / jnp.maximum(z, 1e-30))
        return jnp.where(inner, _polyval(c, zi), _polyval(c_rev, zi))

    vals = safe_eval(zs)
    signs = jnp.sign(vals)
    flips = signs[:-1] * signs[1:] < 0

    idx = jnp.where(flips, jnp.arange(grid - 1), grid)
    idx = jnp.sort(idx)[:4]
    valid = idx < grid
    idx = jnp.minimum(idx, grid - 2)

    mag = jnp.abs(vals)
    locmin = (mag[1:-1] <= mag[:-2]) & (mag[1:-1] <= mag[2:])
    near_flip = flips[:-1] | flips[1:]
    cand_mag = jnp.where(locmin & ~near_flip, mag[1:-1], jnp.inf)
    _, cand_pos = jax.lax.top_k(-cand_mag, 2)
    extra_z = zs[cand_pos + 1]
    extra_valid = jnp.isfinite(cand_mag[cand_pos])

    lo, hi = zs[idx], zs[idx + 1]
    slo = jnp.sign(safe_eval(lo))

    def bisect(_, carry):
        lo, hi, slo = carry
        mid = 0.5 * (lo + hi)
        smid = jnp.sign(safe_eval(mid))
        go_left = slo * smid < 0
        return (jnp.where(go_left, lo, mid),
                jnp.where(go_left, mid, hi),
                jnp.where(go_left, slo, smid))

    lo, hi, _ = jax.lax.fori_loop(0, bisect_iters, bisect, (lo, hi, slo))
    z = 0.5 * (lo + hi)

    dc = c[:-1] * jnp.arange(4, 0, -1, dtype=dtype)

    def newton(_, z):
        f = _polyval(c, z)
        df = _polyval(dc, z)
        step = f / jnp.where(jnp.abs(df) < 1e-20, 1e-20, df)
        return z - jnp.clip(step, -0.05, 0.05)

    z = jax.lax.fori_loop(0, newton_iters, newton, z)
    return jnp.concatenate([z, extra_z]), jnp.concatenate([valid, extra_valid])


def _kabsch(Xw: jnp.ndarray, Yc: jnp.ndarray):
    """Exact rigid alignment Y ~= R X + t for 3-point triads."""
    cX = jnp.mean(Xw, axis=0)
    cY = jnp.mean(Yc, axis=0)
    H = (Xw - cX).T @ (Yc - cY)
    U, _, Vt = jnp.linalg.svd(H)
    d = jnp.sign(jnp.linalg.det(Vt.T @ U.T))
    S = jnp.diag(jnp.array([1.0, 1.0, 1.0], H.dtype).at[2].set(d))
    R = Vt.T @ S @ U.T
    t = cY - R @ cX
    return R, t


def p3p_grunert(X: jnp.ndarray, uv_norm: jnp.ndarray):
    """Up to 4 poses from 3 world points + 3 normalized image points.

    X: (3, 3) world points; uv_norm: (3, 2) K^-1-normalized pixels.
    Returns (Rts (6, 3, 4), valid (6,) bool) — fixed slots, invalid slots
    flagged (degenerate samples: collinear points, coincident bearings,
    spurious quartic roots). Callers score all slots; garbage loses argmax.
    """
    dtype = X.dtype
    f = jnp.concatenate([uv_norm, jnp.ones((3, 1), dtype)], axis=1)
    f = f / jnp.linalg.norm(f, axis=1, keepdims=True)  # unit bearings

    a2 = jnp.sum((X[1] - X[2]) ** 2)
    b2 = jnp.sum((X[0] - X[2]) ** 2)
    c2 = jnp.sum((X[0] - X[1]) ** 2)
    cos_a = jnp.dot(f[1], f[2])
    cos_b = jnp.dot(f[0], f[2])
    cos_g = jnp.dot(f[0], f[1])

    b2s = jnp.maximum(b2, 1e-20)
    r = (a2 - c2) / b2s
    q = c2 / b2s

    # u = N(v) / D(v); substituting into the third law-of-cosines ratio
    # gives the quartic N^2 - 2 cos(gamma) N D + G D^2 = 0 (see module doc).
    Nc = jnp.stack([r - 1.0, -2.0 * r * cos_b, 1.0 + r])         # deg 2
    Dc = jnp.stack([-2.0 * cos_a, 2.0 * cos_g])                  # deg 1
    Gc = jnp.stack([-q, 2.0 * q * cos_b, 1.0 - q])               # deg 2

    conv = lambda p1, p2: jnp.convolve(p1, p2)
    quart = conv(Nc, Nc)                                          # deg 4
    quart = quart - 2.0 * cos_g * jnp.pad(conv(Nc, Dc), (1, 0))   # deg 3
    quart = quart + conv(Gc, conv(Dc, Dc))                        # deg 4

    roots, valid = _real_roots_quartic_pos(quart)

    def polish_depths(d):
        """Gauss-Newton on the three law-of-cosines equations (exact
        system; the quartic root carries f32 elimination noise)."""
        def step(_, d):
            d1, d2, d3 = d[0], d[1], d[2]
            g = jnp.stack([
                d2 * d2 + d3 * d3 - 2 * d2 * d3 * cos_a - a2,
                d1 * d1 + d3 * d3 - 2 * d1 * d3 * cos_b - b2,
                d1 * d1 + d2 * d2 - 2 * d1 * d2 * cos_g - c2,
            ])
            z = jnp.zeros_like(d1)
            J = 2.0 * jnp.stack([
                jnp.stack([z, d2 - d3 * cos_a, d3 - d2 * cos_a]),
                jnp.stack([d1 - d3 * cos_b, z, d3 - d1 * cos_b]),
                jnp.stack([d1 - d2 * cos_g, d2 - d1 * cos_g, z]),
            ])
            JtJ = J.T @ J + 1e-9 * jnp.eye(3, dtype=dtype)
            return d - jnp.linalg.solve(JtJ, J.T @ g)

        return jax.lax.fori_loop(0, 3, step, d)

    def pose_from_v(v):
        Nv = _polyval(Nc, v)
        Dv = _polyval(Dc, v)
        ok_d = jnp.abs(Dv) > 1e-9
        u = Nv / jnp.where(ok_d, Dv, 1.0)
        denom = 1.0 + v * v - 2.0 * v * cos_b
        ok_den = denom > 1e-12
        d1 = jnp.sqrt(b2 / jnp.where(ok_den, denom, 1.0))
        d = polish_depths(jnp.stack([d1, u * d1, v * d1]))
        ok_depth = jnp.all(d > 0)
        Yc = d[:, None] * f
        R, t = _kabsch(X, Yc)
        Rt = jnp.concatenate([R, t[:, None]], axis=1)
        ok = ok_d & ok_den & ok_depth & jnp.all(jnp.isfinite(Rt))
        return jnp.where(ok, Rt, jnp.eye(3, 4, dtype=dtype)), ok

    Rts, ok = jax.vmap(pose_from_v)(roots)
    return Rts, valid & ok
