"""Brute-force KNN descriptor matching with fused Lowe-ratio test.

JAX replacement for ``cv2.BFMatcher.knnMatch(des0, des1, k=2)`` +
the Python ratio-filter loop (sfm.py:259-268). The all-pairs L2 distance
matrix is computed as a single (N0, D) x (D, N1) matmul
(`dist^2 = |a|^2 + |b|^2 - 2 a.b`), and the top-2 neighbor reduction +
ratio test are fused elementwise ops and reductions. Output is a
fixed-capacity match list (query_idx, train_idx, valid) — no dynamic
shapes.

The ratio test matches the reference semantics exactly: keep a match when
d1 < ratio * d2 on L2 distances, i.e. d1^2 < ratio^2 * d2^2 (sfm.py:264,
ratio=0.70).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

_BIG = jnp.float32(3.0e38)


class Matches(NamedTuple):
    idx0: jnp.ndarray  # (M,) feature index in image 0
    idx1: jnp.ndarray  # (M,) feature index in image 1
    valid: jnp.ndarray  # (M,) bool


def distance_matrix(
    desc0: jnp.ndarray, desc1: jnp.ndarray, valid1: jnp.ndarray
) -> jnp.ndarray:
    """Squared L2 distances (N0, N1); invalid train columns get +inf.

    The matmul runs in float32 (`preferred_element_type`, at the
    package's "highest" default precision — no TF32);
    SIFT descriptors are small-magnitude so f32 is exact enough for the
    ratio test.
    """
    sq0 = jnp.sum(desc0 * desc0, axis=-1, keepdims=True)  # (N0, 1)
    sq1 = jnp.sum(desc1 * desc1, axis=-1, keepdims=True).T  # (1, N1)
    cross = jax.lax.dot_general(
        desc0,
        desc1,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    d2 = jnp.maximum(sq0 + sq1 - 2.0 * cross, 0.0)
    return jnp.where(valid1[None, :], d2, _BIG)


def top2(d2: jnp.ndarray):
    """Per-row two smallest distances + argmin. d2: (N0, N1).

    Returns (d1, j1, d2nd): best distance, its column, second-best distance.
    """
    j1 = jnp.argmin(d2, axis=1)
    d1 = jnp.take_along_axis(d2, j1[:, None], axis=1)[:, 0]
    cols = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1)
    masked = jnp.where(cols == j1[:, None], _BIG, d2)
    d2nd = jnp.min(masked, axis=1)
    return d1, j1, d2nd


@partial(jax.jit, static_argnames=("mutual",))
def knn_match(
    desc0: jnp.ndarray,
    desc1: jnp.ndarray,
    valid0: jnp.ndarray,
    valid1: jnp.ndarray,
    ratio: float = 0.70,
    mutual: bool = False,
) -> Matches:
    """k=2 brute-force match with Lowe ratio filter.

    desc0: (N0, D); desc1: (N1, D); valid*: (N*,) feature-slot validity.
    Returns fixed-capacity Matches of length N0: slot i holds the best
    train index for query i; `valid` marks matches that survive the ratio
    test (and, optionally, a mutual-nearest check — the reference matcher
    is one-directional, so mutual=False reproduces its behavior).
    """
    d2 = distance_matrix(desc0, desc1, valid1)
    d1, j1, d2nd = top2(d2)
    ok = valid0 & (d1 < (ratio * ratio) * d2nd) & (d1 < _BIG)
    if mutual:
        d2_t = jnp.where(valid0[None, :], d2.T, _BIG)
        back = jnp.argmin(d2_t, axis=1)  # (N1,) best query for each train
        ok = ok & (back[j1] == jnp.arange(desc0.shape[0]))
    idx0 = jnp.arange(desc0.shape[0], dtype=jnp.int32)
    return Matches(idx0=idx0, idx1=j1.astype(jnp.int32), valid=ok)


def match_with_config(desc0, desc1, valid0, valid1, cfg) -> "Matches":
    """knn_match with a FrontendConfig's ratio and mutual check."""
    return knn_match(
        desc0, desc1, valid0, valid1, ratio=cfg.lowe_ratio, mutual=cfg.mutual_check
    )


def gather_match_points(kp0: jnp.ndarray, kp1: jnp.ndarray, matches: Matches):
    """Matched pixel-coordinate arrays (the reference's pts0/pts1 output).

    kp0, kp1: (N, 2) keypoint positions. Returns (pts0 (M,2), pts1 (M,2),
    valid (M,)) with invalid rows zeroed.
    """
    pts0 = kp0[matches.idx0]
    pts1 = kp1[matches.idx1]
    v = matches.valid[:, None]
    return jnp.where(v, pts0, 0.0), jnp.where(v, pts1, 0.0), matches.valid
