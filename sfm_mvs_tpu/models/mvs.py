"""Multi-view stereo densification: plane-sweep depth maps + fusion.

The reference DECLARES multiview stereo (repo name "sfm-mvs", README.md:5,
the `densify` flag at sfm.py:298 and the dense.ply branch at sfm.py:199)
but never implements it. This module supplies the capability, designed
for an accelerator:

- For each reference frame, a plane-sweep cost volume over D fronto-
  parallel inverse-depth hypotheses: every neighbor image is warped onto
  the reference via the plane-induced homography H(d) = K (R - t n^T/d)
  K^-1 and compared with a locally-normalized photometric cost. Warps are
  batched bilinear gathers; cost aggregation is a separable box filter
  (XLA convs); everything is one jitted program per frame.
- Depth = argmin over the volume with parabolic sub-plane refinement,
  filtered by photometric confidence and best-vs-second ratio.
- Fusion back-projects valid pixels into world points with colors,
  optionally subsampled, appended to the sparse map's cloud for export
  as dense.ply (the output slot the reference left empty).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from sfm_mvs_tpu.models.map_store import MapState


class DepthMap(NamedTuple):
    depth: jnp.ndarray  # (H, W) metric depth in the reference frame
    confidence: jnp.ndarray  # (H, W) in [0, 1]
    valid: jnp.ndarray  # (H, W) bool


def _bilinear_sample(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray):
    """Sample img (H, W) at float coords; returns (values, inside_mask)."""
    H, W = img.shape
    inside = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    x = jnp.clip(x, 0.0, W - 1.001)
    y = jnp.clip(y, 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    flat = img.reshape(-1)

    def at(yy, xx):
        return flat[yy * W + xx]

    v = (
        at(y0, x0) * (1 - fy) * (1 - fx)
        + at(y0, x0 + 1) * (1 - fy) * fx
        + at(y0 + 1, x0) * fy * (1 - fx)
        + at(y0 + 1, x0 + 1) * fy * fx
    )
    return v, inside


def _box_filter(x: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Separable box filter over the last two axes. x: (..., H, W)."""
    k = 2 * radius + 1
    pad = [(0, 0)] * (x.ndim - 2) + [(radius, radius), (radius, radius)]
    xp = jnp.pad(x, pad, mode="edge")
    c = jnp.cumsum(xp, axis=-1)
    c = jnp.concatenate([jnp.zeros_like(c[..., :1]), c], axis=-1)
    x1 = (c[..., k:] - c[..., :-k]) / k
    c = jnp.cumsum(x1, axis=-2)
    c = jnp.concatenate([jnp.zeros_like(c[..., :1, :]), c], axis=-2)
    return (c[..., k:, :] - c[..., :-k, :]) / k


def _downsample2(img: jnp.ndarray) -> jnp.ndarray:
    """2x average-pool over the last two axes (crops odd trailing row/col)."""
    H, W = img.shape[-2], img.shape[-1]
    H2, W2 = H // 2, W // 2
    x = img[..., : H2 * 2, : W2 * 2]
    x = x.reshape(*img.shape[:-2], H2, 2, W2, 2)
    return x.mean(axis=(-3, -1))


def _scale_K(K: jnp.ndarray, s: float) -> jnp.ndarray:
    """Intrinsics for an image downsampled by factor s (pixel centers at
    integer coords: x_l = (x + 0.5)/s - 0.5)."""
    S = jnp.array(
        [[1.0 / s, 0.0, 0.5 / s - 0.5],
         [0.0, 1.0 / s, 0.5 / s - 0.5],
         [0.0, 0.0, 1.0]],
        dtype=K.dtype,
    )
    return S @ K


def _nearest_sample(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray):
    """1-tap nearest sample; a quarter of bilinear's gathers."""
    H, W = img.shape
    inside = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    ix = jnp.clip(jnp.round(x).astype(jnp.int32), 0, W - 1)
    iy = jnp.clip(jnp.round(y).astype(jnp.int32), 0, H - 1)
    return img.reshape(-1)[iy * W + ix], inside


def _pool3(x: jnp.ndarray, op) -> jnp.ndarray:
    """3x3 min/max pool (op = lax.min/lax.max), SAME padding."""
    init = jnp.inf if op is jax.lax.min else -jnp.inf
    return jax.lax.reduce_window(
        x, jnp.asarray(init, x.dtype), op, (3, 3), (1, 1), "SAME"
    )


def _sweep_select(
    ref_zm, nbrs_zm, Kl, R_rel, t_rel, center, offsets, cost_radius,
    dist=None, sample_mode="bilinear", extra=(),
):
    """Evaluate per-pixel inverse-depth hypotheses `center + offsets[d]`
    and select the best with parabolic sub-step refinement.

    The per-depth warp never forms a homography: with a_m = R_rel ray_p
    (per pixel, per neighbor, depth-independent; ray_p the ref pixel's
    ideal camera ray) and h_m = t_rel, the warped camera point is
    a_m + h_m * invd — one FMA per hypothesis. Neighbors are zero-meaned
    ONCE in their own frame before warping, and the box filter (linear)
    runs on the neighbor-AGGREGATED difference, so each hypothesis costs
    2 filtered planes instead of 2M. With `dist` = (k1, k2), ref rays are
    undistorted and neighbor projections re-distorted (both images remain
    raw), at pure elementwise cost — no extra gathers.

    Returns (invd_map, best_cost, mean_cost, den_at_best), each (H, W).
    """
    from sfm_mvs_tpu.ops import projection as proj

    H, W = ref_zm.shape
    dt = ref_zm.dtype
    Kinv = jnp.linalg.inv(Kl)
    ys, xs = jnp.meshgrid(
        jnp.arange(H, dtype=dt), jnp.arange(W, dtype=dt), indexing="ij"
    )
    pix = jnp.stack([xs, ys, jnp.ones_like(xs)], axis=-1).reshape(-1, 3)
    rays = pix @ Kinv.T  # (HW, 3) ideal camera rays (z = 1)
    if dist is not None:
        xy_u = proj.undistort_normalized(rays[:, :2], dist)
        rays = jnp.concatenate([xy_u, jnp.ones_like(rays[:, 2:])], axis=1)
    a = jnp.einsum("mij,pj->mpi", R_rel, rays)  # (M, HW, 3)
    hv = t_rel  # (M, 3)
    fx, fy = Kl[0, 0], Kl[1, 1]
    cx, cy = Kl[0, 2], Kl[1, 2]
    ref_flat = ref_zm.reshape(-1)

    def cost_one(iv_map):
        iv = iv_map.reshape(-1)  # (HW,)
        q = a + hv[:, None, :] * iv[None, :, None]  # (M, HW, 3)
        z = q[..., 2]
        zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        xn = q[..., 0] / zs
        yn = q[..., 1] / zs
        if dist is not None:
            xy_d = proj.distort_normalized(
                jnp.stack([xn, yn], axis=-1), dist
            )
            xn, yn = xy_d[..., 0], xy_d[..., 1]
        x = xn * fx + cx
        y = yn * fy + cy

        sampler = (
            _nearest_sample if sample_mode == "nearest" else _bilinear_sample
        )

        def samp(img, xm, ym, zm):
            v, inside = sampler(img, xm, ym)
            return v, inside & (zm > 1e-6)

        vals, insides = jax.vmap(samp)(nbrs_zm, x, y, z)  # (M, HW)
        w = insides.astype(dt)
        num = jnp.sum(jnp.abs(vals - ref_flat[None]) * w, axis=0)
        den = jnp.sum(w, axis=0)
        num_f = _box_filter(num.reshape(H, W), cost_radius)
        den_f = _box_filter(den.reshape(H, W), cost_radius)
        cost = jnp.where(
            den_f > 1e-6, num_f / jnp.maximum(den_f, 1e-6), 1.0
        )
        return cost, den.reshape(H, W)

    # Hypothesis stack: D uniform steps around `center`, then any `extra`
    # per-pixel maps (escape hypotheses — e.g. 3x3 min/max-pooled coarse
    # inverse depth, letting a pixel mis-assigned at a depth EDGE jump to
    # the adjacent surface, which local +-2-step refinement cannot reach).
    hyps = center[None] + offsets[:, None, None]  # (D, H, W)
    D = offsets.shape[0]
    if extra:
        hyps = jnp.concatenate([hyps, jnp.stack(list(extra))], axis=0)
    costs, dens = jax.lax.map(cost_one, hyps)  # (D+E, H, W)

    # Parabolic sub-step refinement over the UNIFORM subset.
    best_u = jnp.argmin(costs[:D], axis=0)
    bc_u = jnp.min(costs[:D], axis=0)
    bm1 = jnp.clip(best_u - 1, 0, D - 1)
    bp1 = jnp.clip(best_u + 1, 0, D - 1)
    c0 = jnp.take_along_axis(costs[:D], bm1[None], axis=0)[0]
    c2 = jnp.take_along_axis(costs[:D], bp1[None], axis=0)[0]
    denom = c0 - 2 * bc_u + c2
    shift = jnp.where(jnp.abs(denom) < 1e-9, 0.0, 0.5 * (c0 - c2) / denom)
    shift = jnp.clip(shift, -1.0, 1.0)
    step = offsets[1] - offsets[0] if D > 1 else jnp.zeros((), dt)
    invd_u = center + offsets[best_u] + shift * step

    best_all = jnp.argmin(costs, axis=0)
    best_cost = jnp.min(costs, axis=0)
    invd = jnp.where(
        best_all < D,
        invd_u,
        jnp.take_along_axis(hyps, best_all[None], axis=0)[0],
    )
    mean_cost = jnp.mean(costs[:D], axis=0)
    den_best = jnp.take_along_axis(dens, best_all[None], axis=0)[0]
    return invd, best_cost, mean_cost, den_best


@partial(jax.jit, static_argnames=(
    "num_depths", "cost_radius", "coarse_levels", "refine_hyps",
    "refine_hyps_final", "escape_final",
))
def plane_sweep_depth(
    ref_img: jnp.ndarray,
    nbr_imgs: jnp.ndarray,
    pose_ref: jnp.ndarray,
    nbr_poses: jnp.ndarray,
    K: jnp.ndarray,
    min_depth: jnp.ndarray,
    max_depth: jnp.ndarray,
    num_depths: int = 64,
    cost_radius: int = 2,
    min_confidence: float = 0.15,
    coarse_levels: int = 2,
    refine_hyps: int = 5,
    # Full-resolution hypotheses dominate MVS cost; 3 uniform + the 2
    # escape hypotheses at the finest level measure quality-neutral vs 5
    # uniform (cov 0.828/rms 2.70% vs 0.832/2.68% on the GT harness)
    # while cutting the finest level's gather taps ~30%.
    refine_hyps_final: int = 3,
    escape_final: bool = True,
    dist: jnp.ndarray | None = None,
) -> DepthMap:
    """Coarse-to-fine plane-sweep stereo for one reference frame.

    ref_img: (H, W) grayscale; nbr_imgs: (M, H, W); pose_*: world->cam
    [R|t]; depth range from the sparse map. Returns a DepthMap.

    The full `num_depths` sweep runs at 1/2^coarse_levels resolution
    (4^levels fewer gather taps — gather cost scales with the index
    count); each finer level refines the upsampled
    inverse-depth map with `refine_hyps` per-pixel hypotheses at halved
    step. Total taps ~ HW*M*(D/4^L + refine_hyps*(1/4^(L-1)+...+1)) vs
    the flat sweep's HW*M*D — ~10x fewer at L=2, D=64 — while the final
    inverse-depth step is 4x finer. Confidence is the coarse sweep's
    peakedness (best-vs-mean over the FULL hypothesis range), upsampled.
    """
    M = nbr_imgs.shape[0]
    # Relative pose ref -> neighbor: x_n = R_rel x_r + t_rel.
    R_ref = pose_ref[:, :3]
    t_ref = pose_ref[:, 3]
    R_n = nbr_poses[:, :, :3]
    t_n = nbr_poses[:, :, 3]
    R_rel = jnp.einsum("mij,kj->mik", R_n, R_ref)  # (M, 3, 3)
    t_rel = t_n - jnp.einsum("mij,j->mi", R_rel, t_ref)  # (M, 3)

    # Pyramids, zero-meaned per level in each image's own frame.
    refs = [ref_img]
    nbrs = [nbr_imgs]
    for _ in range(coarse_levels):
        refs.append(_downsample2(refs[-1]))
        nbrs.append(_downsample2(nbrs[-1]))
    refs_zm = [r - _box_filter(r, cost_radius) for r in refs]
    nbrs_zm = [n - _box_filter(n, cost_radius) for n in nbrs]

    inv_lo = 1.0 / max_depth
    inv_hi = 1.0 / min_depth

    # Coarse full sweep (uniform in inverse depth).
    L = coarse_levels
    offsets_c = jnp.linspace(inv_lo, inv_hi, num_depths)
    zeros_c = jnp.zeros_like(refs_zm[L])
    invd, best_c, mean_c, den_b = _sweep_select(
        refs_zm[L], nbrs_zm[L], _scale_K(K, float(2 ** L)),
        R_rel, t_rel, zeros_c, offsets_c, cost_radius, dist=dist,
        # Nearest taps suffice for the coarse argmin (the refine levels
        # re-localize with bilinear); 4x fewer gather-tap costs on the
        # D-deep full sweep, the largest tap population of the pyramid.
        sample_mode="nearest",
    )
    conf = jnp.clip(
        (mean_c - best_c) / jnp.maximum(mean_c, 1e-6), 0.0, 1.0
    )
    step = (inv_hi - inv_lo) / jnp.maximum(num_depths - 1, 1)

    # Refinement levels: upsample, re-search +-(refine_hyps//2) halved
    # steps, PLUS two "escape" hypotheses — the 3x3 min/max pooled coarse
    # inverse depth. Depth-EDGE pixels mis-assigned at coarse resolution
    # (foreground fattening: the cost window smears foreground texture
    # over background pixels) sit many coarse steps from the truth, far
    # outside the local refinement span; the pooled hypotheses offer the
    # adjacent surface's depth directly (measured: bad(>5%)-pixel
    # fraction 11% -> ~3% on the staircase edge bands).
    for lev in range(coarse_levels - 1, -1, -1):
        Hl, Wl = refs_zm[lev].shape
        # Pool BEFORE upsampling: a 3x3 pool at the coarser grid reaches
        # one full coarse pixel (= the fattening-band scale), where the
        # same pool after upsampling would reach only one fine pixel.
        lo = jax.image.resize(_pool3(invd, jax.lax.min), (Hl, Wl), "linear")
        hi = jax.image.resize(_pool3(invd, jax.lax.max), (Hl, Wl), "linear")
        invd = jax.image.resize(invd, (Hl, Wl), "linear")
        conf = jax.image.resize(conf, (Hl, Wl), "linear")
        step = step * 0.5
        # Full-resolution hypotheses are the dominant MVS cost (each is
        # H*W*M bilinear samples — see DESIGN.md 8b): the finest level
        # can run a reduced count via `refine_hyps_final` (0 = same).
        nh = refine_hyps
        escape = (lo, hi)
        if lev == 0 and refine_hyps_final > 0:
            nh = refine_hyps_final
            if escape_final is False:
                escape = ()
        offs = (
            jnp.arange(nh, dtype=invd.dtype) - (nh - 1) / 2.0
        ) * step
        invd, best_c, _, den_b = _sweep_select(
            refs_zm[lev], nbrs_zm[lev], _scale_K(K, float(2 ** lev)),
            R_rel, t_rel, invd, offs, cost_radius, dist=dist,
            extra=escape,
        )

    invd = jnp.clip(invd, inv_lo * 0.5, inv_hi * 2.0)
    depth = 1.0 / jnp.maximum(invd, 1e-6)
    valid = (conf > min_confidence) & (den_b > 0.5)
    return DepthMap(depth=depth, confidence=conf, valid=valid)


def backproject_depth(
    dm: DepthMap,
    pose_ref: jnp.ndarray,
    K: jnp.ndarray,
    color_img: Optional[jnp.ndarray] = None,
    stride: int = 2,
    dist: Optional[jnp.ndarray] = None,
):
    """Depth map -> world points (+BGR colors). Returns (pts (N,3), colors,
    valid) with N = ceil(H/stride)*ceil(W/stride). `dist` = (k1, k2)
    undistorts the pixel rays (depth maps live on the raw image grid)."""
    H, W = dm.depth.shape
    ys, xs = jnp.meshgrid(
        jnp.arange(0, H, stride, dtype=K.dtype),
        jnp.arange(0, W, stride, dtype=K.dtype),
        indexing="ij",
    )
    d = dm.depth[::stride, ::stride]
    v = dm.valid[::stride, ::stride]
    Kinv = jnp.linalg.inv(K)
    pix = jnp.stack([xs, ys, jnp.ones_like(xs)], axis=-1)
    rays = pix @ Kinv.T
    if dist is not None:
        from sfm_mvs_tpu.ops import projection as proj

        xy_u = proj.undistort_normalized(rays[..., :2], dist)
        rays = jnp.concatenate([xy_u, jnp.ones_like(rays[..., 2:])], axis=-1)
    Xc = rays * d[..., None]
    R = pose_ref[:, :3]
    t = pose_ref[:, 3]
    Xw = (Xc - t) @ R  # R^T (Xc - t)
    if color_img is not None:
        if color_img.ndim == 2:
            c = color_img[::stride, ::stride][..., None] * jnp.ones((1, 1, 3))
            c = c * 255.0
        else:
            c = color_img[::stride, ::stride]
    else:
        c = jnp.full(Xw.shape, 200.0)
    return Xw.reshape(-1, 3), c.reshape(-1, 3), v.reshape(-1)


@partial(jax.jit, static_argnames=(
    "fuse_depths", "edge_trim_rel", "edge_trim_radius", "free_space_rel",
    "edge_keep_conf",
))
def geometric_consistency(
    dm_ref: DepthMap,
    pose_ref: jnp.ndarray,
    dm_nbrs_depth: jnp.ndarray,
    nbr_poses: jnp.ndarray,
    K: jnp.ndarray,
    rel_tol: float = 0.03,
    min_consistent: int = 1,
    dist: Optional[jnp.ndarray] = None,
    nbr_valid: Optional[jnp.ndarray] = None,
    fuse_depths: bool = True,
    edge_trim_rel: float = 0.0,
    edge_trim_radius: int = 2,
    free_space_rel: float = 0.05,
    edge_keep_conf: float = 0.75,
    min_conf: float = 0.0,
) -> DepthMap:
    """Cross-view depth-consistency filter (+ multi-view depth fusion).

    min_conf > 0: PHOTOMETRIC CONFIDENCE FLOOR — drops pixels whose
    sweep cost-curve peakedness (DepthMap.confidence) is below the
    floor. Measured on the full-res GT harness (r5 dump analysis): the
    0.5% of pixels at >5% depth error carry ~80% of the squared error
    and sit at median confidence 0.59 vs 0.77 overall; a 0.50 floor
    cuts tail rel-RMS 1.69% -> ~1.42% at ~2.5% coverage cost. The
    canonical full-res bench runs with 0.5 (benchmarks/mvs_full.py).

    Back-projects each reference pixel with its estimated depth, projects
    the 3D point into every neighbor, samples the neighbor's depth map
    there, and keeps the pixel only if >= `min_consistent` neighbors agree
    within `rel_tol` relative depth — the standard MVS fusion check that
    removes photometric-only leaks (textureless/occluded regions).

    fuse_depths: surviving depths are replaced by the MEAN of the ref
    depth and every agreeing neighbor's implied depth (the neighbor's
    surface point at the projection, back-projected into the ref camera)
    — COLMAP-style multi-view fusion that cuts per-pixel noise ~sqrt(#
    agreeing views) at zero extra gathers (reuses the sampled depths).

    edge_trim_rel > 0: additionally invalidates pixels whose local depth
    spread (max-min over a (2*radius+1)^2 window) exceeds
    `edge_trim_rel * depth` — depth-DISCONTINUITY bands, where coarse
    cost-window fattening produces view-CONSISTENT but wrong depths that
    the agreement vote cannot catch (the dominant term of the r4 error
    tail: rel-RMS 3.0% vs median 0.5%).

    free_space_rel > 0: FREE-SPACE VIOLATION veto — if any neighbor's
    depth map at the projection claims the surface lies MORE THAN
    `free_space_rel` (relative) BEHIND our 3D point, that neighbor sees
    through the point's supposed location and the pixel is dropped. This
    is the fusion constraint that kills foreground-fattened plateau
    pixels: they float in front of the true surface near depth edges,
    are locally smooth (edge trim misses the plateau interior) and can
    collect 2 agreeing fattened neighbors — but any non-fattened
    neighbor sees the background straight through them (measured r5:
    0.8% of pixels at >=10% error, median 2 px from a GT depth edge,
    carried ~1.8 points of the 2.8% rel-RMS). A NEARER surface in the
    neighbor (sampled < z) is ordinary occlusion, not a violation.
    """
    H, W = dm_ref.depth.shape
    ys, xs = jnp.meshgrid(
        jnp.arange(H, dtype=K.dtype), jnp.arange(W, dtype=K.dtype), indexing="ij"
    )
    Kinv = jnp.linalg.inv(K)
    pix = jnp.stack([xs, ys, jnp.ones_like(xs)], axis=-1)
    rays = pix @ Kinv.T
    if dist is not None:
        from sfm_mvs_tpu.ops import projection as proj

        xy_u = proj.undistort_normalized(rays[..., :2], dist)
        rays = jnp.concatenate([xy_u, jnp.ones_like(rays[..., 2:])], axis=-1)
    Xc = rays * dm_ref.depth[..., None]
    R = pose_ref[:, :3]
    t = pose_ref[:, 3]
    Xw = (Xc - t) @ R  # world points, (H, W, 3)

    def check_one(nbr_depth, nbr_pose):
        Rn = nbr_pose[:, :3]
        tn = nbr_pose[:, 3]
        Xn = Xw @ Rn.T + tn  # neighbor camera frame
        z = Xn[..., 2]
        zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        xn = Xn[..., 0] / zs
        yn = Xn[..., 1] / zs
        if dist is not None:
            from sfm_mvs_tpu.ops import projection as proj

            xy_d = proj.distort_normalized(
                jnp.stack([xn, yn], axis=-1), dist
            )
            u = xy_d[..., 0] * K[0, 0] + K[0, 2]
            v = xy_d[..., 1] * K[1, 1] + K[1, 2]
        else:
            u = xn * K[0, 0] + K[0, 2]
            v = yn * K[1, 1] + K[1, 2]
        # NEAREST depth lookup: bilinear blends across the neighbor's
        # own depth discontinuities, producing mid-air values that
        # neither agree nor violate cleanly (fails correct edge pixels,
        # misses fattened ones).
        sampled, inside = _nearest_sample(nbr_depth, u.reshape(-1), v.reshape(-1))
        sampled = sampled.reshape(H, W)
        inside = inside.reshape(H, W)
        agree = (
            inside
            & (z > 0)
            & (jnp.abs(sampled - z) < rel_tol * jnp.maximum(z, 1e-6))
        )
        violate = (
            inside
            & (z > 0)
            & (sampled > z * (1.0 + free_space_rel))
        )
        # Implied REF depth from this neighbor: the neighbor's surface
        # point lies along OUR viewing ray (both cameras see the same
        # surface when consistent), so scaling our depth by sampled/z
        # is exactly the depth at which our ray meets the neighbor's
        # surface — no extra gathers, pure elementwise.
        z_implied = dm_ref.depth * (sampled / jnp.maximum(z, 1e-6))
        return agree, violate, z_implied

    agrees, violates, z_imp = jax.vmap(check_one)(
        dm_nbrs_depth, nbr_poses
    )  # (M, H, W)
    if nbr_valid is not None:
        # Padded neighbor slots (batched fusion pads every ref's neighbor
        # list to a fixed M) must not vote.
        agrees = agrees & nbr_valid[:, None, None]
        violates = violates & nbr_valid[:, None, None]
    n_agree = jnp.sum(agrees.astype(jnp.int32), axis=0)
    valid = dm_ref.valid & (n_agree >= min_consistent)
    if free_space_rel > 0.0:
        valid = valid & ~jnp.any(violates, axis=0)
    if min_conf > 0.0:
        valid = valid & (dm_ref.confidence > min_conf)
    depth = dm_ref.depth
    if fuse_depths:
        af = agrees.astype(depth.dtype)
        fused = (depth + jnp.sum(z_imp * af, axis=0)) / (
            1.0 + n_agree.astype(depth.dtype)
        )
        depth = jnp.where(valid, fused, depth)
    if edge_trim_rel > 0.0:
        dmax = depth
        dmin = depth
        for _ in range(edge_trim_radius):
            dmax = _pool3(dmax, jax.lax.max)
            dmin = _pool3(dmin, jax.lax.min)
        jump = (dmax - dmin) > edge_trim_rel * jnp.maximum(depth, 1e-6)
        # ASYMMETRIC: trim only the NEAR-depth plateau beside the jump.
        # Fattening halos sit at the foreground depth over background
        # pixels (measured: 100% of the surviving >=10% errors were
        # est < gt), so the near side carries the halo while the far
        # side is ordinary background — trimming both wastes ~2x the
        # coverage for no tail benefit. CONFIDENCE RESCUE: true
        # foreground pixels near the edge sit on strong texture (median
        # photometric confidence 0.78 vs the halo's 0.60 — halos live on
        # background pixels whose cost window merely brushes the strip),
        # so high-confidence near-side pixels are kept.
        near_side = depth < dmin * (1.0 + edge_trim_rel)
        rescue = dm_ref.confidence > edge_keep_conf
        valid = valid & ~(jump & near_side & ~rescue)
    return DepthMap(depth=depth, confidence=dm_ref.confidence, valid=valid)


# Batched fusion: geometric consistency + back-projection for a chunk of
# reference frames in ONE dispatch. Pass 2 previously ran 3 dispatches +
# 3 device->host transfers PER FRAME; here the chunk's points/colors/valid
# come back in one transfer.
@partial(jax.jit, static_argnames=(
    "stride", "geometric_check", "fuse_depths", "edge_trim_rel",
    "free_space_rel", "edge_trim_radius", "edge_keep_conf", "min_conf",
))
def _fuse_batch(
    depth_b, conf_b, valid_b, pose_b, nbr_depth_b, nbr_pose_b,
    nbr_valid_b, min_cons_b, K, color_b, rel_tol,
    stride: int = 2, geometric_check: bool = True, dist=None,
    fuse_depths: bool = True, edge_trim_rel: float = 0.0,
    free_space_rel: float = 0.05, edge_trim_radius: int = 2,
    edge_keep_conf: float = 0.75, min_conf: float = 0.0,
):
    def one(d, c, v, pose, nd, npo, nv, mc, color):
        dm = DepthMap(depth=d, confidence=c, valid=v)
        if geometric_check:
            dm = geometric_consistency.__wrapped__(
                dm, pose, nd, npo, K,
                rel_tol=rel_tol, min_consistent=mc, dist=dist,
                nbr_valid=nv, fuse_depths=fuse_depths,
                edge_trim_rel=edge_trim_rel, free_space_rel=free_space_rel,
                edge_trim_radius=edge_trim_radius,
                edge_keep_conf=edge_keep_conf, min_conf=min_conf,
            )
        pts, cols, ok = backproject_depth(
            dm, pose, K, color, stride=stride, dist=dist
        )
        # dm.depth is the FUSED (multi-view-averaged) depth when
        # fuse_depths — the depth the emitted cloud is actually built
        # from; return it so callers evaluating the depth maps score the
        # same surface the cloud uses (not the noisier pass-1 depth).
        return pts, cols, ok, dm.valid, dm.depth

    return jax.vmap(one)(
        depth_b, conf_b, valid_b, pose_b, nbr_depth_b, nbr_pose_b,
        nbr_valid_b, min_cons_b, color_b,
    )


# Batched plane sweep: vmap over the reference-frame axis. All per-ref
# work (warps, cost volumes, argmin) is independent, so the batch axis is
# embarrassingly parallel — it shards across a device mesh unchanged.
@partial(jax.jit, static_argnames=("num_depths", "cost_radius"))
def _plane_sweep_batch(
    ref_b, nbr_b, pose_b, nposes_b, K, lo_b, hi_b,
    num_depths: int = 64, cost_radius: int = 2, dist=None,
):
    def one(ref, nbrs, pose, nposes, lo, hi):
        return plane_sweep_depth.__wrapped__(
            ref, nbrs, pose, nposes, K, lo, hi,
            num_depths=num_depths, cost_radius=cost_radius, dist=dist,
        )

    return jax.vmap(one)(ref_b, nbr_b, pose_b, nposes_b, lo_b, hi_b)


@partial(jax.jit, static_argnames=())
def _depth_ranges(state: MapState) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-camera (min_depth, max_depth) from the sparse cloud — one jit
    over the whole map (replaces a per-frame host percentile loop).

    Uses the 2%/98% quantiles of the positive point depths per camera,
    widened by 0.7x/1.4x like the reference-free heuristic.
    """
    R = state.poses[:, :, :3]  # (C, 3, 3)
    t = state.poses[:, :, 3]  # (C, 3)
    z = jnp.einsum("pj,cj->cp", state.points, R[:, 2]) + t[:, 2:3].reshape(-1, 1)
    ok = state.point_valid[None, :] & (z > 0)
    zq = jnp.where(ok, z, jnp.nan)
    lo = jnp.nanquantile(zq, 0.02, axis=1)
    hi = jnp.nanquantile(zq, 0.98, axis=1)
    lo = jnp.where(jnp.isnan(lo), 1.0, lo)
    hi = jnp.where(jnp.isnan(hi), 10.0, hi)
    return lo * 0.7, hi * 1.4


def densify_map(
    images_gray: Sequence[np.ndarray],
    state: MapState,
    num_depths: int = 64,
    num_neighbors: int = 2,
    stride: int = 2,
    images_bgr: Optional[Sequence[np.ndarray]] = None,
    geometric_check: bool = True,
    # 1.5% relative depth agreement, >=2 agreeing neighbors where
    # available (tuned on GT: mc=2/tol=0.02 gives coverage 0.86 @ rms
    # 3.0%; mc=1/tol=0.03 leaked a 1.8% bad-pixel tail into the fused
    # cloud — foreground-fattened edge bands are view-consistent enough
    # to pass a single-neighbor check).
    geo_rel_tol: float = 0.015,
    geo_min_consistent: int = 2,
    # Multi-view depth averaging over the agreeing neighbors (noise
    # ~sqrt(#views) cheaper) and depth-discontinuity trimming: the r4
    # tail (rel-RMS 3.0% vs median 0.5%) was dominated by
    # view-consistent fattening bands at depth edges that the agreement
    # vote cannot reject; trimming pixels whose 5x5 local depth spread
    # exceeds 6% removes them at a few-% coverage cost.
    fuse_depths: bool = True,
    edge_trim_rel: float = 0.06,
    # Asymmetric near-side trim to radius 6: the fattening halo measured
    # 2-8 px wide; radius 6 removes it at ~2% GT-valid coverage cost
    # (full-res GT harness: rel-RMS 1.86% -> 1.30% at coverage 0.81).
    edge_trim_radius: int = 6,
    edge_keep_conf: float = 0.75,
    free_space_rel: float = 0.05,
    # Consistency checks run against a WIDER neighbor window than the
    # photometric sweep: the +-num_neighbors sweep neighbors share the
    # reference's foreground fattening (nearby viewpoints smear the same
    # depth edge the same way), so their depth maps agree with the
    # fattened plateau and the free-space veto never fires; +-4-frame
    # neighbors see the edge from far enough aside to expose it. Their
    # depth maps are ALREADY computed in pass 1, so widening pass 2
    # costs only cheap bilinear samples, not sweeps.
    geo_num_neighbors: int = 4,
    # Photometric confidence floor (see geometric_consistency.min_conf);
    # 0.0 = off. The canonical full-res bench runs 0.5.
    min_conf: float = 0.0,
    batch: int = 4,
    mesh=None,
    return_depth_maps: bool = False,
    dist: Optional[jnp.ndarray] = None,
    max_refs: Optional[int] = None,
):
    """Plane-sweep every frame, cross-check depths, fuse a colored cloud.

    Two passes: (1) plane-sweep depth maps in vmapped BATCHES of reference
    frames (one dispatch per `batch` frames — no per-frame host syncs;
    depth ranges come from one jitted quantile pass over the sparse map);
    (2) cross-view geometric-consistency filtering — a pixel survives only
    if a neighbor's depth map agrees with its 3D position — then
    back-projection. With `mesh`, the batch axis is sharded across the
    mesh's devices (reference frames are data-parallel) and `batch` is
    rounded up to the device count. Returns (points (N,3), colors (N,3))
    ready for io.to_ply (dense.ply — the output slot the reference
    declared but never produced, sfm.py:199/298).
    """
    n_total = int(state.num_cams)
    # max_refs sweeps only the first max_refs reference frames (e.g. a
    # warmup pass that compiles the batched programs without paying for
    # the full sequence). Neighbor SELECTION and the padded neighbor
    # count M come from the FULL camera set, so a warmup call compiles
    # exactly the program shapes the full run uses (advisor r4: the old
    # clamp gave a small-max_refs warmup a smaller M — different
    # programs, defeating the prewarm).
    n_cams = n_total if max_refs is None else min(n_total, max_refs)
    K = state.K
    if mesh is not None:
        n_dev = int(np.prod(mesh.devices.shape))
        batch = max(batch, n_dev)
        batch = ((batch + n_dev - 1) // n_dev) * n_dev

    def neighbors(r, hi=n_total, k=None):
        k = num_neighbors if k is None else k
        return [
            i
            for i in range(max(0, r - k), min(hi, r + k + 1))
            if i != r
        ]

    geo_k = max(num_neighbors, geo_num_neighbors)

    import os as _os
    import time as _time

    profile = _os.environ.get("MVS_PROFILE", "0") == "1"
    t0 = _time.time()
    lo_all, hi_all = _depth_ranges(state)
    # Pass 1 warps neighbor IMAGES (full-set neighbors reach past the
    # swept refs); stage only the frames actually touched.
    n_imgs = min(n_total, n_cams + num_neighbors)
    imgs_dev = [jnp.asarray(g) for g in images_gray[:n_imgs]]
    M = max(len(neighbors(r)) for r in range(n_total))

    # Pass 1: depth maps, one vmapped dispatch per batch of refs.
    depth_maps: dict[int, DepthMap] = {}
    refs = list(range(n_cams))
    for s in range(0, len(refs), batch):
        chunk = refs[s : s + batch]
        pad = batch - len(chunk)
        chunk_p = chunk + [chunk[-1]] * pad
        ref_b = jnp.stack([imgs_dev[r] for r in chunk_p])
        # Pad each ref's neighbor list to M by repeating its first
        # neighbor (a duplicated view only re-votes the same evidence).
        nbr_idx = [
            (neighbors(r) + [neighbors(r)[0]] * M)[:M] for r in chunk_p
        ]
        nbr_b = jnp.stack(
            [jnp.stack([imgs_dev[i] for i in nn]) for nn in nbr_idx]
        )
        pose_b = state.poses[jnp.asarray(chunk_p)]
        nposes_b = state.poses[jnp.asarray(nbr_idx)]
        lo_b = lo_all[jnp.asarray(chunk_p)]
        hi_b = hi_all[jnp.asarray(chunk_p)]
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            ax = mesh.axis_names[0]
            shard = lambda a: jax.device_put(
                a, NamedSharding(mesh, P(*([ax] + [None] * (a.ndim - 1))))
            )
            ref_b, nbr_b = shard(ref_b), shard(nbr_b)
            pose_b, nposes_b = shard(pose_b), shard(nposes_b)
            lo_b, hi_b = shard(lo_b), shard(hi_b)
        dms = _plane_sweep_batch(
            ref_b, nbr_b, pose_b, nposes_b, K, lo_b, hi_b,
            num_depths=num_depths, dist=dist,
        )
        for j, r in enumerate(chunk):
            depth_maps[r] = jax.tree_util.tree_map(lambda a: a[j], dms)

    if profile:
        jax.block_until_ready(depth_maps[refs[-1]].depth)
        print(f"[mvs] pass1 sweeps: {_time.time()-t0:.1f}s", flush=True)
        t0 = _time.time()

    # Pass 2: cross-view consistency + fusion, batched (one dispatch and
    # ONE host transfer per chunk instead of 3 round trips per frame).
    # Two refs per chunk off-mesh; sizing chunks from device memory is an
    # open item (ROADMAP R5).
    M2 = 2 * geo_k
    b2 = batch if mesh is not None else min(batch, 2)
    depth_stack = jnp.stack([depth_maps[r].depth for r in refs])
    conf_stack = jnp.stack([depth_maps[r].confidence for r in refs])
    valid_stack = jnp.stack([depth_maps[r].valid for r in refs])
    colors_dev = [
        jnp.asarray(images_bgr[r]) if images_bgr is not None
        else jnp.asarray(images_gray[r])
        for r in refs
    ]
    all_pts, all_cols = [], []
    filtered: dict[int, DepthMap] = {}
    chunk_results = []
    for s in range(0, len(refs), b2):
        chunk = refs[s : s + b2]
        pad = b2 - len(chunk)
        chunk_p = chunk + [chunk[-1]] * pad
        # Pass 2 samples neighbor DEPTH MAPS, which exist only for swept
        # refs — restrict to those (only reachable when max_refs < the
        # camera count, i.e. warmup; padded slots vote via nbr_valid) —
        # over the WIDER geo window (see geo_num_neighbors).
        nbrs_l = [
            [i for i in neighbors(r, k=geo_k) if i < n_cams]
            for r in chunk_p
        ]
        nbr_idx = [
            ((nn or [r]) + [(nn or [r])[0]] * M2)[:M2]
            for nn, r in zip(nbrs_l, chunk_p)
        ]
        nbr_valid = np.zeros((b2, M2), bool)
        for j, nn in enumerate(nbrs_l):
            nbr_valid[j, : len(nn)] = True
        min_cons = jnp.asarray(
            [min(geo_min_consistent, len(nn)) for nn in nbrs_l], jnp.int32
        )
        idx = jnp.asarray(chunk_p)
        out = _fuse_batch(
            depth_stack[idx], conf_stack[idx], valid_stack[idx],
            state.poses[idx],
            depth_stack[jnp.asarray(nbr_idx)],
            state.poses[jnp.asarray(nbr_idx)],
            jnp.asarray(nbr_valid), min_cons, K,
            jnp.stack([colors_dev[r] for r in chunk_p]),
            jnp.asarray(geo_rel_tol),
            stride=stride, geometric_check=geometric_check, dist=dist,
            fuse_depths=fuse_depths, edge_trim_rel=float(edge_trim_rel),
            free_space_rel=float(free_space_rel),
            edge_trim_radius=int(edge_trim_radius),
            edge_keep_conf=float(edge_keep_conf),
            min_conf=float(min_conf),
        )
        chunk_results.append((chunk, out))
    if profile:
        jax.block_until_ready(chunk_results[-1][1][0])
        print(f"[mvs] pass2 fuse dispatch: {_time.time()-t0:.1f}s", flush=True)
        t0 = _time.time()
    for chunk, (pts_b, cols_b, ok_b, vmap_b, fused_b) in chunk_results:
        pts_h = np.asarray(pts_b)
        cols_h = np.asarray(cols_b)
        ok_h = np.asarray(ok_b)
        vmap_h = np.asarray(vmap_b)
        fused_h = np.asarray(fused_b)
        for j, r in enumerate(chunk):
            all_pts.append(pts_h[j][ok_h[j]])
            all_cols.append(cols_h[j][ok_h[j]])
            filtered[r] = DepthMap(
                depth=jnp.asarray(fused_h[j]),
                confidence=depth_maps[r].confidence,
                valid=jnp.asarray(vmap_h[j]),
            )
    if profile:
        print(f"[mvs] pass2 host gather: {_time.time()-t0:.1f}s", flush=True)
    if not all_pts:
        pts = np.zeros((0, 3), np.float32)
        cols = np.zeros((0, 3), np.float32)
    else:
        pts, cols = np.concatenate(all_pts), np.concatenate(all_cols)
    if return_depth_maps:
        return pts, cols, filtered
    return pts, cols
