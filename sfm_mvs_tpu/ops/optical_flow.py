"""Pyramidal Lucas-Kanade feature tracking.

The reference contains a disabled alternative front end built on
``cv2.calcOpticalFlowPyrLK`` (sfm.py:249-257, commented out) — track
keypoints frame-to-frame instead of re-matching descriptors. This module
supplies that capability in fixed-shape JAX: a coarse-to-fine pyramidal LK
tracker, vmapped over keypoints with fixed iteration counts.

Design: per pyramid level, each keypoint iterates the classic LK normal
equations — sample an (2r+1)^2 patch of spatial gradients from the
previous image around the current estimate (bilinear gathers), build the
2x2 structure tensor, and step by the closed-form solve against the
temporal difference. All levels/iterations are statically unrolled or
`fori_loop`ed; validity tracks in-bounds + well-conditioned structure
tensors (min eigenvalue threshold).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sfm_mvs_tpu.ops import pyramid


class FlowResult(NamedTuple):
    points: jnp.ndarray  # (N, 2) tracked positions in the next image
    valid: jnp.ndarray  # (N,) bool — converged, in-bounds, well-conditioned
    error: jnp.ndarray  # (N,) mean absolute patch residual


def _sample_patch(img: jnp.ndarray, cx, cy, offs):
    """Bilinear-sample a patch around (cx, cy). offs: (P, 2) static grid.

    img: (H, W); cx, cy scalars (traced). Returns (P,) values.
    """
    H, W = img.shape
    x = jnp.clip(cx + offs[:, 0], 0.0, W - 1.001)
    y = jnp.clip(cy + offs[:, 1], 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    flat = img.reshape(-1)

    def at(yy, xx):
        return flat[yy * W + xx]

    return (
        at(y0, x0) * (1 - fy) * (1 - fx)
        + at(y0, x0 + 1) * (1 - fy) * fx
        + at(y0 + 1, x0) * fy * (1 - fx)
        + at(y0 + 1, x0 + 1) * fy * fx
    )


@partial(jax.jit, static_argnames=("levels", "window_radius", "iterations"))
def track_points(
    img0: jnp.ndarray,
    img1: jnp.ndarray,
    pts0: jnp.ndarray,
    valid0: jnp.ndarray,
    levels: int = 3,
    window_radius: int = 7,
    iterations: int = 10,
    min_eig: float = 1e-4,
    max_error: float = 0.15,
) -> FlowResult:
    """Track pts0 from img0 into img1 (the cv2.calcOpticalFlowPyrLK slot).

    img0, img1: (H, W) float32 in [0, 1]; pts0: (N, 2) pixel coords.
    Returns FlowResult with positions in img1's frame.
    """
    H, W = img0.shape
    r = window_radius
    lin = jnp.arange(-r, r + 1, dtype=jnp.float32)
    oy, ox = jnp.meshgrid(lin, lin, indexing="ij")
    offs = jnp.stack([ox.reshape(-1), oy.reshape(-1)], axis=-1)  # (P, 2)

    # Build pyramids (host-unrolled; static level count).
    pyr0 = [img0]
    pyr1 = [img1]
    for _ in range(levels - 1):
        pyr0.append(pyramid.pyr_down(pyr0[-1]))
        pyr1.append(pyramid.pyr_down(pyr1[-1]))

    def track_one(p0):
        flow = jnp.zeros(2)
        ok = jnp.asarray(True)
        err = jnp.asarray(0.0)
        for lvl in range(levels - 1, -1, -1):
            scale = 0.5**lvl
            i0 = pyr0[lvl]
            i1 = pyr1[lvl]
            base = p0 * scale
            # Template patch + gradients from img0 at this level (fixed).
            t = _sample_patch(i0, base[0], base[1], offs)
            gx = 0.5 * (
                _sample_patch(i0, base[0] + 1, base[1], offs)
                - _sample_patch(i0, base[0] - 1, base[1], offs)
            )
            gy = 0.5 * (
                _sample_patch(i0, base[0], base[1] + 1, offs)
                - _sample_patch(i0, base[0], base[1] - 1, offs)
            )
            a = jnp.sum(gx * gx)
            b = jnp.sum(gx * gy)
            c = jnp.sum(gy * gy)
            det = a * c - b * b
            trace = a + c
            eig_min = 0.5 * (trace - jnp.sqrt(jnp.maximum(trace * trace - 4 * det, 0.0)))
            cond_ok = eig_min / offs.shape[0] > min_eig
            inv_det = jnp.where(jnp.abs(det) < 1e-12, 0.0, 1.0 / det)

            def step(_, fl):
                q = base + fl
                w = _sample_patch(i1, q[0], q[1], offs)
                d = w - t
                b1 = jnp.sum(gx * d)
                b2 = jnp.sum(gy * d)
                du = -(c * b1 - b * b2) * inv_det
                dv = -(-b * b1 + a * b2) * inv_det
                return fl + jnp.stack([du, dv])

            flow = jax.lax.fori_loop(0, iterations, step, flow)
            ok = ok & cond_ok
            if lvl > 0:
                flow = flow * 2.0
            else:
                w = _sample_patch(i1, base[0] + flow[0], base[1] + flow[1], offs)
                err = jnp.mean(jnp.abs(w - t))
        p1 = p0 + flow
        inside = (
            (p1[0] >= r) & (p1[0] < W - r) & (p1[1] >= r) & (p1[1] < H - r)
        )
        return p1, ok & inside & (err < max_error), err

    p1, ok, err = jax.vmap(track_one)(pts0)
    return FlowResult(points=p1, valid=ok & valid0, error=err)
