"""SIFT-style feature detection and description, in fixed-shape JAX.

Replaces ``cv2.xfeatures2d.SIFT_create().detectAndCompute`` (sfm.py:246-252;
isfm.py:46,60; test.py:196,210) — the reference's hottest native kernel —
with a fully batched JAX implementation:

- Gaussian scale space + DoG as separable XLA convolutions (pyramid.py).
- 3x3x3 extremum detection, quadratic subpixel refinement, contrast and
  edge rejection as dense elementwise math over the whole DoG volume
  (closed-form 3x3 solve via adjugate — no per-pixel linalg calls).
- Fixed-capacity top-K keypoint selection per octave (``lax.top_k``),
  then a global top-K merge — no dynamic shapes anywhere.
- Orientation assignment and the 4x4x8 gradient-histogram descriptor as
  batched bilinear gathers over precomputed per-octave gradient maps,
  with histogram accumulation expressed as one-hot matmuls
  rather than scatters.

The algorithm follows Lowe's SIFT (the published method OpenCV implements);
numeric fidelity to cv2 is validated in tests by matching repeatability
across synthetic warped views rather than bit-exact keypoint equality.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sfm_mvs_tpu.ops import pyramid
from sfm_mvs_tpu.utils.config import FrontendConfig


class Features(NamedTuple):
    """Fixed-capacity keypoints + descriptors for one image."""

    xy: jnp.ndarray  # (K, 2) pixel coords in the *input* image frame
    scale: jnp.ndarray  # (K,) blob sigma in input-image pixels
    angle: jnp.ndarray  # (K,) dominant orientation, radians
    response: jnp.ndarray  # (K,) |DoG contrast|
    desc: jnp.ndarray  # (K, 128) L2-normalized descriptors
    valid: jnp.ndarray  # (K,) bool


# ---------------------------------------------------------------------------
# Extrema detection
# ---------------------------------------------------------------------------


def _neighbor_extrema_mask(dog: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Strict 26-neighbor max/min masks for the middle layers of a DoG stack.

    dog: (L, H, W). Returns (is_max, is_min) of shape (L-2, H, W) for layers
    1..L-2; borders (1px) are excluded by the caller's refinement validity.
    """
    L, H, W = dog.shape
    center = dog[1:-1]
    is_max = jnp.ones_like(center, dtype=bool)
    is_min = jnp.ones_like(center, dtype=bool)
    # Shift the whole volume by (dz, dy, dx) with edge padding; strict
    # comparison against every one of the 26 neighbors.
    padded = jnp.pad(dog, ((0, 0), (1, 1), (1, 1)), mode="edge")
    for dz in (-1, 0, 1):
        z0 = 1 + dz
        sl = padded[z0 : z0 + L - 2]
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dz == 0 and dy == 0 and dx == 0:
                    continue
                nb = sl[:, 1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
                is_max = is_max & (center > nb)
                is_min = is_min & (center < nb)
    return is_max, is_min


def _finite_diffs(dog: jnp.ndarray):
    """Dense first/second derivatives of the DoG volume at middle layers.

    dog: (L, H, W) -> each output (L-2, H, W): g = (gx, gy, gs),
    H = (hxx, hyy, hss, hxy, hxs, hys). Central differences; spatial borders
    use edge padding (those pixels are rejected by the border mask anyway).
    """
    p = jnp.pad(dog, ((0, 0), (1, 1), (1, 1)), mode="edge")
    L, H, W = dog.shape
    c = dog[1:-1]

    def sh(dz, dy, dx):
        return p[1 + dz : 1 + dz + L - 2, 1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]

    gx = 0.5 * (sh(0, 0, 1) - sh(0, 0, -1))
    gy = 0.5 * (sh(0, 1, 0) - sh(0, -1, 0))
    gs = 0.5 * (sh(1, 0, 0) - sh(-1, 0, 0))
    hxx = sh(0, 0, 1) + sh(0, 0, -1) - 2 * c
    hyy = sh(0, 1, 0) + sh(0, -1, 0) - 2 * c
    hss = sh(1, 0, 0) + sh(-1, 0, 0) - 2 * c
    hxy = 0.25 * (sh(0, 1, 1) - sh(0, 1, -1) - sh(0, -1, 1) + sh(0, -1, -1))
    hxs = 0.25 * (sh(1, 0, 1) - sh(1, 0, -1) - sh(-1, 0, 1) + sh(-1, 0, -1))
    hys = 0.25 * (sh(1, 1, 0) - sh(1, -1, 0) - sh(-1, 1, 0) + sh(-1, -1, 0))
    return (gx, gy, gs), (hxx, hyy, hss, hxy, hxs, hys)


def _solve3_adjugate(hxx, hyy, hss, hxy, hxs, hys, gx, gy, gs):
    """Solve H d = -g for the symmetric 3x3 Hessian, densely per pixel."""
    # Cofactors of [[hxx,hxy,hxs],[hxy,hyy,hys],[hxs,hys,hss]].
    c00 = hyy * hss - hys * hys
    c01 = hxs * hys - hxy * hss
    c02 = hxy * hys - hxs * hyy
    c11 = hxx * hss - hxs * hxs
    c12 = hxy * hxs - hxx * hys
    c22 = hxx * hyy - hxy * hxy
    det = hxx * c00 + hxy * c01 + hxs * c02
    inv_det = jnp.where(jnp.abs(det) < 1e-12, 0.0, 1.0 / det)
    dx = -(c00 * gx + c01 * gy + c02 * gs) * inv_det
    dy = -(c01 * gx + c11 * gy + c12 * gs) * inv_det
    ds = -(c02 * gx + c12 * gy + c22 * gs) * inv_det
    return dx, dy, ds, det


def _octave_candidates(dog: jnp.ndarray, cfg: FrontendConfig):
    """Dense candidate maps for one octave.

    dog: (S+2, H, W). Returns (response (S, H, W) — 0 where invalid,
    offsets (dx, dy, ds) each (S, H, W)).
    """
    S = cfg.scales_per_octave
    H, W = dog.shape[1], dog.shape[2]
    center = dog[1:-1]

    is_max, is_min = _neighbor_extrema_mask(dog)
    is_ext = is_max | is_min
    prefilter = jnp.abs(center) > 0.5 * cfg.contrast_threshold / S

    (gx, gy, gs), (hxx, hyy, hss, hxy, hxs, hys) = _finite_diffs(dog)
    dx, dy, ds, _ = _solve3_adjugate(hxx, hyy, hss, hxy, hxs, hys, gx, gy, gs)
    # Reject runaway offsets (would belong to a neighboring cell).
    off_ok = (jnp.abs(dx) < 1.5) & (jnp.abs(dy) < 1.5) & (jnp.abs(ds) < 1.5)
    contrast = center + 0.5 * (gx * dx + gy * dy + gs * ds)
    contrast_ok = jnp.abs(contrast) > cfg.contrast_threshold / S
    # Edge response: 2x2 spatial Hessian ratio test.
    tr = hxx + hyy
    det2 = hxx * hyy - hxy * hxy
    r = cfg.edge_threshold
    edge_ok = (det2 > 0) & (tr * tr * r < (r + 1.0) * (r + 1.0) * det2)
    # Exclude a 1px image border (finite diffs there used edge padding).
    ys = jax.lax.broadcasted_iota(jnp.int32, (S, H, W), 1)
    xs = jax.lax.broadcasted_iota(jnp.int32, (S, H, W), 2)
    border_ok = (xs > 0) & (xs < W - 1) & (ys > 0) & (ys < H - 1)

    valid = is_ext & prefilter & off_ok & contrast_ok & edge_ok & border_ok
    response = jnp.where(valid, jnp.abs(contrast), 0.0)
    return response, (dx, dy, ds)


# ---------------------------------------------------------------------------
# Sampling helpers
# ---------------------------------------------------------------------------


def _bilinear_gather(maps: jnp.ndarray, layer: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray):
    """Sample maps (C, L, H, W) at (layer, y, x) bilinearly in (y, x).

    layer: (..., ) int32; x, y: (...,) float. Out-of-range coords clamp.
    Returns (C, ...) samples.

    Per-corner flat element gathers. (A single blocked lax.gather pulling
    the (2,2,C) corner/channel slice per sample was slower on an earlier
    target; not measured on the GPU.)
    """
    C, L, H, W = maps.shape
    x = jnp.clip(x, 0.0, W - 1.001)
    y = jnp.clip(y, 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    flat = maps.reshape(C, L * H * W)

    def at(yy, xx):
        idx = (layer * H + yy) * W + xx
        return flat[:, idx.reshape(-1)].reshape((C,) + idx.shape)

    v00 = at(y0, x0)
    v01 = at(y0, x0 + 1)
    v10 = at(y0 + 1, x0)
    v11 = at(y0 + 1, x0 + 1)
    return (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )


# ---------------------------------------------------------------------------
# Orientation + descriptor
# ---------------------------------------------------------------------------

_ORI_GRID = 16  # orientation window sample grid (16x16)
_ORI_BINS = 36
_DESC_GRID = 16  # descriptor sample grid (16x16 samples over 4x4 bins)


def _pack_polar(grads: jnp.ndarray) -> jnp.ndarray:
    """(2, L, H, W) (dx, dy) maps -> (L, H, W) uint32 of (bf16 mag | bf16 ang).

    One dense elementwise pass (bandwidth-bound, ~free next to the gather
    cost it eliminates). bf16 angle resolution is ~1.4 degrees at 2pi —
    far inside the 10-degree orientation bins and 45-degree descriptor
    bins it feeds.
    """
    dx, dy = grads[0], grads[1]
    mag = jnp.sqrt(dx * dx + dy * dy).astype(jnp.bfloat16)
    ang = (jnp.arctan2(dy, dx) % (2.0 * jnp.pi)).astype(jnp.bfloat16)
    hi = jax.lax.bitcast_convert_type(mag, jnp.uint16).astype(jnp.uint32)
    lo = jax.lax.bitcast_convert_type(ang, jnp.uint16).astype(jnp.uint32)
    return (hi << 16) | lo


def _unpack_polar(v: jnp.ndarray):
    """uint32 (bf16 mag | bf16 ang) -> (mag, ang) float32."""
    mag = jax.lax.bitcast_convert_type(
        (v >> 16).astype(jnp.uint16), jnp.bfloat16
    ).astype(jnp.float32)
    ang = jax.lax.bitcast_convert_type(
        (v & 0xFFFF).astype(jnp.uint16), jnp.bfloat16
    ).astype(jnp.float32)
    return mag, ang


def _polar_sampler(packed: jnp.ndarray):
    """sample(layer, sx, sy) over one octave's packed (L, H, W) polar map."""
    L, H, W = packed.shape
    flat = packed.reshape(-1)

    def sample(lay, sx, sy):
        ix = jnp.clip(jnp.round(sx).astype(jnp.int32), 0, W - 1)
        iy = jnp.clip(jnp.round(sy).astype(jnp.int32), 0, H - 1)
        idx = (lay * H + iy) * W + ix
        v = flat[idx.reshape(-1)].reshape(idx.shape)
        return _unpack_polar(v)

    return sample


def make_grad_sampler(grads: jnp.ndarray, mode: str):
    """Returns sample(layer, sx, sy) -> (mag, ang) for window sampling.

    mode "nearest_polar": one element gather per sample from the packed
    polar map — a quarter of the gathers of "bilinear", and also
    *closer to OpenCV SIFT*, which reads per-pixel
    gradients without interpolation. mode "bilinear": 4-corner
    interpolation of (dx, dy), kept for comparison/validation.
    """
    if mode == "nearest_polar":
        return _polar_sampler(_pack_polar(grads))

    def sample(lay, sx, sy):
        dxy = _bilinear_gather(grads, lay, sx, sy)
        dx, dy = dxy[0], dxy[1]
        mag = jnp.sqrt(dx * dx + dy * dy)
        ang = jnp.arctan2(dy, dx) % (2.0 * jnp.pi)
        return mag, ang

    return sample


def _orientation(sample, layer, x, y, sigma_oct):
    """Dominant gradient orientation per keypoint.

    sample: gradient sampler from make_grad_sampler.
    layer/x/y/sigma_oct: (K,) keypoint attrs in octave coords.
    Returns angle (K,) radians in [0, 2pi).
    """
    K = x.shape[0]
    radius_scale = 4.5  # window radius = 4.5 * sigma (3 * 1.5sigma, Lowe)
    g = _ORI_GRID
    lin = (jnp.arange(g, dtype=jnp.float32) - (g - 1) / 2.0) / ((g - 1) / 2.0)
    gy_off, gx_off = jnp.meshgrid(lin, lin, indexing="ij")  # in [-1, 1]
    # Per-keypoint sample positions (K, g*g).
    rad = radius_scale * sigma_oct  # (K,)
    sx = x[:, None] + rad[:, None] * gx_off.reshape(-1)[None, :]
    sy = y[:, None] + rad[:, None] * gy_off.reshape(-1)[None, :]
    lay = jnp.broadcast_to(layer[:, None], sx.shape)
    mag, ang = sample(lay, sx, sy)
    # Gaussian weight, sigma_w = 1.5 * sigma (in normalized window units:
    # offsets are rad * [-1,1], so weight uses (offset/sigma)...).
    r2 = (gx_off.reshape(-1)[None, :] * rad[:, None]) ** 2 + (
        gy_off.reshape(-1)[None, :] * rad[:, None]
    ) ** 2
    w = jnp.exp(-r2 / (2.0 * (1.5 * sigma_oct[:, None]) ** 2)) * mag
    # 36-bin histogram with linear two-tap binning. Computed as an unrolled
    # loop over bins (36 masked (K, S) reductions) — pure elementwise +
    # reduce, no scatters and no (K, S, 36) one-hot materialization.
    bin_f = ang * (_ORI_BINS / (2.0 * jnp.pi))
    b0 = jnp.floor(bin_f).astype(jnp.int32) % _ORI_BINS
    frac = bin_f - jnp.floor(bin_f)
    b1 = (b0 + 1) % _ORI_BINS
    cols = []
    for b in range(_ORI_BINS):
        wb = jnp.where(b0 == b, w * (1.0 - frac), 0.0) + jnp.where(
            b1 == b, w * frac, 0.0
        )
        cols.append(jnp.sum(wb, axis=1))
    hist = jnp.stack(cols, axis=1)  # (K, 36)
    # Circular smoothing ([1,4,6,4,1]/16, applied twice like OpenCV).
    for _ in range(2):
        hist = (
            6.0 * hist
            + 4.0 * (jnp.roll(hist, 1, axis=1) + jnp.roll(hist, -1, axis=1))
            + (jnp.roll(hist, 2, axis=1) + jnp.roll(hist, -2, axis=1))
        ) / 16.0
    def refine_peak(peak):
        # Parabolic sub-bin interpolation around a histogram peak.
        hp = jnp.take_along_axis(hist, peak[:, None], axis=1)[:, 0]
        hl = jnp.take_along_axis(hist, ((peak - 1) % _ORI_BINS)[:, None], axis=1)[:, 0]
        hr = jnp.take_along_axis(hist, ((peak + 1) % _ORI_BINS)[:, None], axis=1)[:, 0]
        denom = hl - 2.0 * hp + hr
        shift = jnp.where(jnp.abs(denom) < 1e-12, 0.0, 0.5 * (hl - hr) / denom)
        ang = (peak.astype(jnp.float32) + shift + 0.5) * (2.0 * jnp.pi / _ORI_BINS)
        return ang % (2.0 * jnp.pi), hp

    peak = jnp.argmax(hist, axis=1)
    ang1, h_main = refine_peak(peak)

    # Secondary orientation: the strongest *local maximum* other than the
    # main peak; kept when >= 0.8x the main peak (OpenCV duplicates the
    # keypoint for it — so do we, in detect_and_compute).
    is_local_max = (hist >= jnp.roll(hist, 1, axis=1)) & (
        hist > jnp.roll(hist, -1, axis=1)
    )
    bins = jax.lax.broadcasted_iota(jnp.int32, hist.shape, 1)
    not_main = bins != peak[:, None]
    cand = jnp.where(is_local_max & not_main, hist, -1.0)
    peak2 = jnp.argmax(cand, axis=1)
    ang2, h_sec = refine_peak(peak2)
    has2 = (jnp.max(cand, axis=1) >= 0.8 * h_main) & (h_main > 0)
    return ang1, ang2, has2


def _descriptor(sample, layer, x, y, sigma_oct, angle, cfg: FrontendConfig):
    """4x4 spatial x 8 orientation gradient histogram descriptor.

    Samples a rotated 16x16 grid (spacing 0.75*sigma) of gradients per
    keypoint (sample: from make_grad_sampler), soft-assigns into (4, 4, 8)
    bins with trilinear weights via one-hot matmuls, Gaussian-weighted;
    L2 normalize -> clip 0.2 -> renorm. Returns (K, 128).
    """
    d = cfg.descriptor_width  # 4
    nb = cfg.descriptor_bins  # 8
    g = _DESC_GRID
    K = x.shape[0]
    hist_width = 3.0 * sigma_oct  # (K,) bin width in octave pixels
    # Sample grid in bin units: positions in [-d/2, d/2] (16 samples).
    # Host-side constant — also reused below to build the static spatial
    # binning matrix.
    lin = ((np.arange(g, dtype=np.float32) + 0.5) / g * d - d / 2.0)  # (g,)
    by_np, bx_np = np.meshgrid(lin, lin, indexing="ij")
    bx = jnp.asarray(bx_np.reshape(-1))[None, :]  # (1, g*g) in bin units
    by = jnp.asarray(by_np.reshape(-1))[None, :]
    ca, sa = jnp.cos(angle)[:, None], jnp.sin(angle)[:, None]
    # Rotate bin-frame offsets into image frame; scale to pixels.
    px = (ca * bx - sa * by) * hist_width[:, None] + x[:, None]
    py = (sa * bx + ca * by) * hist_width[:, None] + y[:, None]
    lay = jnp.broadcast_to(layer[:, None], px.shape)
    mag, ang_s = sample(lay, px, py)  # (K, g*g) each
    theta = (ang_s - angle[:, None]) % (2.0 * jnp.pi)
    # Gaussian weight over the window (sigma = d/2 bin units).
    r2 = bx * bx + by * by
    w = jnp.exp(-r2 / (0.5 * d * d)) * mag  # (K, g*g)

    # Trilinear soft-assign. Key structural fact: the sample grid is STATIC
    # in bin units (same for every keypoint), so the spatial (4x4) binning
    # is a fixed (S, 16) matrix — a host-side numpy constant — and the
    # whole spatial accumulation becomes one matmul. Only the
    # orientation axis (8 bins) is data-dependent; it is expanded as a
    # small (K, S, 8) two-tap weight tensor (33MB at full capacity).
    cbx = bx_np.reshape(-1) + d / 2.0 - 0.5  # (S,) host-side
    cby = by_np.reshape(-1) + d / 2.0 - 0.5
    spatial = np.zeros((g * g, d * d), dtype=np.float32)
    for s in range(g * g):
        ix0 = int(np.floor(cbx[s]))
        iy0 = int(np.floor(cby[s]))
        fx_ = cbx[s] - ix0
        fy_ = cby[s] - iy0
        for (ix_, wx_) in ((ix0, 1.0 - fx_), (ix0 + 1, fx_)):
            if not (0 <= ix_ < d):
                continue
            for (iy_, wy_) in ((iy0, 1.0 - fy_), (iy0 + 1, fy_)):
                if not (0 <= iy_ < d):
                    continue
                spatial[s, iy_ * d + ix_] += wx_ * wy_
    spatial = jnp.asarray(spatial)  # (S, 16)

    obin = theta * (nb / (2.0 * jnp.pi))
    i0o = jnp.floor(obin).astype(jnp.int32)
    fo = obin - i0o
    b1o = (i0o + 1) % nb
    i0o = i0o % nb
    otaps = []
    for o in range(nb):
        otaps.append(
            jnp.where(i0o == o, w * (1.0 - fo), 0.0) + jnp.where(b1o == o, w * fo, 0.0)
        )
    V = jnp.stack(otaps, axis=-1)  # (K, S, nb) orientation-binned weights
    # Spatial contraction as a matmul: (K, S, nb) x (S, 16) -> (K, 16, nb).
    acc = jnp.einsum("kso,sp->kpo", V, spatial)
    desc = acc.reshape(w.shape[0], d * d * nb)
    # Normalize -> clip 0.2 -> renormalize (Lowe's illumination robustness).
    norm = jnp.linalg.norm(desc, axis=1, keepdims=True)
    desc = desc / jnp.maximum(norm, 1e-6)
    desc = jnp.minimum(desc, 0.2)
    norm = jnp.linalg.norm(desc, axis=1, keepdims=True)
    return desc / jnp.maximum(norm, 1e-6)


# ---------------------------------------------------------------------------
# Full detector
# ---------------------------------------------------------------------------


def _octave_budgets(cfg: FrontendConfig) -> list[int]:
    """Per-octave candidate capacity; pixel count drops 4x per octave."""
    return [max(64, cfg.max_features >> (2 * o)) for o in range(cfg.num_octaves)]


@partial(jax.jit, static_argnames=("cfg",))
def detect_and_compute(image: jnp.ndarray, cfg: FrontendConfig) -> Features:
    """Full SIFT: scale space -> keypoints -> orientation -> descriptors.

    image: (H, W) float32 grayscale in [0, 1]. Returns fixed-capacity
    Features (cfg.max_features slots) in input-image pixel coordinates.

    On the "nearest_polar" sampling path, BOTH orientation and descriptor
    window sampling are DEFERRED until after global top-K selection:
    per-octave candidates (sum of octave budgets, ~1.3x max_features) are
    ranked by response alone, the K winners compute orientations from one
    concatenated flat polar-gradient buffer spanning all octaves
    (per-keypoint base/stride arithmetic), secondary-orientation
    duplicates re-merge through a second top-K, and descriptors sample
    once for the final K. Gather cost scales with the index count, so
    candidates that would lose the top-K never pay for window sampling.
    The two-stage merge selects the same set as ranking all (primary,
    secondary) entries jointly: a keypoint whose primary misses stage 1
    is outranked by Kf primaries, so none of its entries can reach the
    final top-K.
    """
    S = cfg.scales_per_octave
    base = pyramid.upsample2(image) if cfg.upsample_input else image
    first_scale = 0.5 if cfg.upsample_input else 1.0  # input px per base px
    assumed = 1.0 if cfg.upsample_input else 0.5  # doubled image doubles blur
    deferred = cfg.grad_sampling == "nearest_polar"

    budgets = _octave_budgets(cfg)
    per_octave = []
    metas = []  # deferred path: per-candidate metadata, descriptors later
    flat_parts = []  # deferred path: flattened per-octave polar maps
    geoms = []  # deferred path: (h, w) per octave (static)
    cur = base
    for o in range(cfg.num_octaves):
        # Octave 0 starts from the (possibly doubled) input with its camera
        # blur; later octaves start from the subsampled sigma0*2 level,
        # whose blur at the new resolution is exactly sigma0.
        blur_in = assumed if o == 0 else cfg.sigma0
        gauss = pyramid.gaussian_scale_space(
            cur, sigma0=cfg.sigma0, scales_per_octave=S, assumed_blur=blur_in
        )  # (S+3, h, w)
        dog = gauss[1:] - gauss[:-1]  # (S+2, h, w)
        response, (dx, dy, ds) = _octave_candidates(dog, cfg)
        h, w = cur.shape

        # Gradient maps for layers 1..S of the Gaussian stack.
        gsl = gauss[1 : S + 1]  # (S, h, w)
        pad = jnp.pad(gsl, ((0, 0), (1, 1), (1, 1)), mode="edge")
        gdx = 0.5 * (pad[:, 1:-1, 2:] - pad[:, 1:-1, :-2])
        gdy = 0.5 * (pad[:, 2:, 1:-1] - pad[:, :-2, 1:-1])
        grads = jnp.stack([gdx, gdy])  # (2, S, h, w)
        if deferred:
            packed = _pack_polar(grads)  # (S, h, w) uint32
            flat_parts.append(packed.reshape(-1))
            geoms.append((h, w))
            sampler = None  # orientation+descriptor both deferred
        else:
            sampler = make_grad_sampler(grads, cfg.grad_sampling)

        # Top-K candidates in this octave.
        Ko = budgets[o]
        top_resp, top_idx = jax.lax.top_k(response.reshape(-1), Ko)
        lay = top_idx // (h * w)
        rem = top_idx % (h * w)
        iy = rem // w
        ix = rem % w
        off_x = dx.reshape(-1)[top_idx]
        off_y = dy.reshape(-1)[top_idx]
        off_s = ds.reshape(-1)[top_idx]
        valid = top_resp > 0.0

        fx = ix.astype(jnp.float32) + off_x
        fy = iy.astype(jnp.float32) + off_y
        fs = lay.astype(jnp.float32) + off_s  # refined layer (0-based middle)
        sigma_oct = cfg.sigma0 * jnp.exp2((fs + 1.0) / S)  # octave-frame sigma

        # Reject keypoints whose descriptor window leaves the octave image.
        desc_rad = 3.0 * sigma_oct * (cfg.descriptor_width / 2.0) * jnp.sqrt(2.0)
        inside = (
            (fx > desc_rad)
            & (fx < w - 1 - desc_rad)
            & (fy > desc_rad)
            & (fy < h - 1 - desc_rad)
        )
        valid = valid & inside

        if deferred:
            # Orientation is ALSO deferred to the global top-K winners
            # (like descriptors): candidates beyond the final budget never
            # pay for window sampling. Equivalent selection: a keypoint's
            # secondary entry carries ~the primary's response, so the
            # final top-K can only contain entries of keypoints whose
            # primary survives a top-K over primaries (see the two-stage
            # merge below).
            oct_ids = jnp.full(lay.shape, o, jnp.int32)
            metas.append(dict(
                oct=oct_ids, lay=lay, fx=fx, fy=fy, sigma=sigma_oct,
                valid=valid, response=jnp.where(valid, top_resp, 0.0),
            ))
        else:
            ang1, ang2, has2 = _orientation(sampler, lay, fx, fy, sigma_oct)
            valid2 = valid & has2  # secondary-orientation duplicates
            # (OpenCV keeps peaks >=0.8x main as extra keypoints — so do
            # we; response infinitesimally down-weighted so primaries win
            # top-K ties)
            desc1 = _descriptor(sampler, lay, fx, fy, sigma_oct, ang1, cfg)
            desc2 = _descriptor(sampler, lay, fx, fy, sigma_oct, ang2, cfg)
            scale_to_input = first_scale * (2.0**o)
            xy = jnp.stack([fx, fy], axis=-1) * scale_to_input
            sc = sigma_oct * scale_to_input
            per_octave.append(
                Features(
                    xy=xy, scale=sc, angle=ang1,
                    response=jnp.where(valid, top_resp, 0.0),
                    desc=desc1, valid=valid,
                )
            )
            per_octave.append(
                Features(
                    xy=xy, scale=sc, angle=ang2,
                    response=jnp.where(valid2, top_resp * 0.999999, 0.0),
                    desc=desc2, valid=valid2,
                )
            )
        cur = pyramid.subsample2(gauss[S])  # sigma0*2 image -> next octave

    Kf = cfg.max_features
    if not deferred:
        # Global top-K merge across octaves.
        all_feats = jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs, axis=0), *per_octave
        )
        top_resp, order = jax.lax.top_k(all_feats.response, Kf)
        return Features(
            xy=all_feats.xy[order],
            scale=all_feats.scale[order],
            angle=all_feats.angle[order],
            response=top_resp,
            desc=all_feats.desc[order],
            valid=all_feats.valid[order] & (top_resp > 0.0),
        )

    # Deferred path: select winners first, then compute orientations and
    # descriptors once, sampling from one flat buffer spanning all octaves.
    cat = lambda k: jnp.concatenate([m[k] for m in metas], axis=0)
    # Stage 1: top-K unique candidates by response.
    top_resp, order = jax.lax.top_k(cat("response"), Kf)
    oct_s = cat("oct")[order]
    lay_s = cat("lay")[order]
    fx_s = cat("fx")[order]
    fy_s = cat("fy")[order]
    sig_s = cat("sigma")[order]
    val_s = cat("valid")[order] & (top_resp > 0.0)

    # Static per-octave geometry -> per-keypoint base/stride arithmetic.
    sizes = [S * hh * ww for hh, ww in geoms]
    bases = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    big = jnp.concatenate(flat_parts)
    hs_np = jnp.asarray(np.array([g[0] for g in geoms], np.int32))
    ws_np = jnp.asarray(np.array([g[1] for g in geoms], np.int32))

    def make_sample(oct_idx, lay_idx):
        hk = hs_np[oct_idx]
        wk = ws_np[oct_idx]
        plane = jnp.asarray(bases)[oct_idx] + lay_idx * hk * wk  # (K,)

        def sample(_lay, sx, sy):
            # sx, sy: (K, S_win) octave-frame coords; per-keypoint bounds.
            ix = jnp.clip(jnp.round(sx).astype(jnp.int32), 0, (wk - 1)[:, None])
            iy = jnp.clip(jnp.round(sy).astype(jnp.int32), 0, (hk - 1)[:, None])
            idx = plane[:, None] + iy * wk[:, None] + ix
            v = big[idx.reshape(-1)].reshape(idx.shape)
            return _unpack_polar(v)

        return sample, plane

    sample1, plane1 = make_sample(oct_s, lay_s)
    ang1, ang2, has2 = _orientation(sample1, plane1, fx_s, fy_s, sig_s)

    # Stage 2: merge primary + secondary-orientation entries, re-top-K.
    # A keypoint absent from the stage-1 winners cannot reach the final
    # top-K: its response is below Kf other candidates, each of which
    # contributes at least its own primary entry above it.
    resp_all = jnp.concatenate(
        [jnp.where(val_s, top_resp, 0.0),
         jnp.where(val_s & has2, top_resp * 0.999999, 0.0)]
    )
    ang_all = jnp.concatenate([ang1, ang2])
    val_all = jnp.concatenate([val_s, val_s & has2])
    base_idx = jnp.concatenate([jnp.arange(Kf)] * 2)
    top_resp2, order2 = jax.lax.top_k(resp_all, Kf)
    sel = base_idx[order2]
    oct_f = oct_s[sel]
    lay_f = lay_s[sel]
    fx_f = fx_s[sel]
    fy_f = fy_s[sel]
    sig_f = sig_s[sel]
    ang_f = ang_all[order2]
    val_f = val_all[order2] & (top_resp2 > 0.0)

    sample2, plane2 = make_sample(oct_f, lay_f)
    desc = _descriptor(sample2, plane2, fx_f, fy_f, sig_f, ang_f, cfg)
    stoi = (first_scale * jnp.exp2(oct_f.astype(jnp.float32)))
    return Features(
        xy=jnp.stack([fx_f, fy_f], axis=-1) * stoi[:, None],
        scale=sig_f * stoi,
        angle=ang_f,
        response=top_resp2,
        desc=desc,
        valid=val_f,
    )


def rgb_to_gray(img: jnp.ndarray) -> jnp.ndarray:
    """BGR/RGB (H, W, 3) uint8-or-float -> grayscale float32 [0, 1].

    Uses the ITU-R BT.601 weights (what cv2.cvtColor BGR2GRAY uses,
    sfm.py:243-244). Channel order: pass BGR to mirror the reference.
    """
    was_uint8 = img.dtype == jnp.uint8
    img = img.astype(jnp.float32)
    if img.ndim == 2:
        gray = img
    else:
        b, g, r = img[..., 0], img[..., 1], img[..., 2]
        gray = 0.114 * b + 0.587 * g + 0.299 * r
    return gray / 255.0 if was_uint8 else gray
