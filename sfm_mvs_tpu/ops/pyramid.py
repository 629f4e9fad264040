"""Image pyramids: Gaussian blur, pyrDown, 2x upsample — as XLA convolutions.

JAX replacement for ``cv2.pyrDown`` (sfm.py:40) and the Gaussian
scale-space construction inside OpenCV's SIFT (sfm.py:247). All blurs are
separable 1D convolutions so XLA maps them onto the conv/matmul units
instead of a C++ scalar loop.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def gaussian_kernel_1d(sigma: float, radius: int | None = None) -> np.ndarray:
    """Normalized 1D Gaussian taps. Static (host-side) — sigma is a Python float."""
    if radius is None:
        radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _conv1d(img: jnp.ndarray, taps: np.ndarray, axis: int) -> jnp.ndarray:
    """Separable conv along one spatial axis with edge (replicate) padding.

    img: (H, W). Implemented as a tap-unrolled shift-and-accumulate over a
    padded copy — pure streaming elementwise math, bandwidth-bound. (Chosen
    over XLA's single-channel conv op on an earlier target; not measured
    on the GPU.)
    """
    radius = len(taps) // 2
    pad = [(0, 0), (0, 0)]
    pad[axis] = (radius, radius)
    padded = jnp.pad(img, pad, mode="edge")
    H, W = img.shape
    acc = None
    for t, k in enumerate(np.asarray(taps, dtype=np.float32)):
        if axis == 0:
            sl = padded[t : t + H, :]
        else:
            sl = padded[:, t : t + W]
        acc = sl * k if acc is None else acc + sl * k
    return acc


def gaussian_blur(img: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Separable Gaussian blur. img: (H, W); sigma: static Python float."""
    if sigma <= 0:
        return img
    taps = gaussian_kernel_1d(sigma)
    return _conv1d(_conv1d(img, taps, 0), taps, 1)


_PYR_TAPS = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0


@jax.jit
def pyr_down(img: jnp.ndarray) -> jnp.ndarray:
    """Gaussian-pyramid downscale: 5x5 binomial blur + 2x decimation.

    Matches cv2.pyrDown semantics (the reference's img_downscale,
    sfm.py:36-42): output size is ceil(n/2) per axis.
    """
    blurred = _conv1d(_conv1d(img, _PYR_TAPS, 0), _PYR_TAPS, 1)
    return blurred[::2, ::2]


def img_downscale(img: jnp.ndarray, downscale: int) -> jnp.ndarray:
    """Repeated pyr_down halvings: downscale in {1, 2, 4, 8, ...}.

    Reference parity: img_downscale (sfm.py:36-42) applies pyrDown
    int(downscale/2) times — i.e. downscale=2 -> once, 4 -> twice.
    """
    times = int(round(math.log2(int(downscale)))) if downscale > 1 else 0
    for _ in range(times):
        img = pyr_down(img)
    return img


@jax.jit
def upsample2(img: jnp.ndarray) -> jnp.ndarray:
    """Bilinear 2x upsample (OpenCV SIFT's initial image doubling).

    Explicit interleave of (x[i], (x[i]+x[i+1])/2) per axis — slicing +
    elementwise only, where jax.image.resize lowers to gathers.
    Sample positions follow align_corners=False halves, matching the
    resize output to ~1px at the far border.
    """
    H, W = img.shape

    def up_axis0(x):
        mid = 0.5 * (x[:-1, :] + x[1:, :])
        mid = jnp.concatenate([mid, x[-1:, :]], axis=0)  # replicate last
        out = jnp.stack([x, mid], axis=1)  # (H, 2, W)
        return out.reshape(2 * x.shape[0], x.shape[1])

    up = up_axis0(img)
    up = up_axis0(up.T).T
    return up


def subsample2(img: jnp.ndarray) -> jnp.ndarray:
    """Take every other pixel (used between SIFT octaves — blur already applied)."""
    return img[::2, ::2]


@partial(jax.jit, static_argnames=("sigma0", "scales_per_octave", "assumed_blur"))
def gaussian_scale_space(
    img: jnp.ndarray,
    sigma0: float = 1.6,
    scales_per_octave: int = 3,
    assumed_blur: float = 0.5,
):
    """One octave's Gaussian stack: scales_per_octave + 3 images.

    img is assumed to carry `assumed_blur`; the first level is brought to
    sigma0 and each next level to sigma0 * 2^(i/scales_per_octave) via
    incremental blurs (cheaper, numerically identical to blurring from base).
    Returns (scales_per_octave + 3, H, W).
    """
    S = scales_per_octave
    k = 2.0 ** (1.0 / S)
    sig_prev = assumed_blur
    levels = []
    cur = img
    for i in range(S + 3):
        sig_total = sigma0 * (k**i)
        sig_diff = math.sqrt(max(sig_total**2 - sig_prev**2, 1e-8))
        cur = gaussian_blur(cur, sig_diff)
        levels.append(cur)
        sig_prev = sig_total
    return jnp.stack(levels)
