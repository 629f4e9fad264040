"""Nister 5-point minimal solver (ops/five_point.py).

Validates the JAX reimplementation of the solver inside the
reference's ``cv2.findEssentialMat`` (sfm.py:307): algebraic exactness on
minimal samples, identifiability against extra correspondences, planar
non-degeneracy (where 8-point fails structurally), RANSAC integration,
and a cv2 oracle cross-check on the recovered pose.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.slow

import jax
import jax.numpy as jnp

from sfm_mvs_tpu.ops import lie, projection, ransac
from sfm_mvs_tpu.ops.epipolar import recover_pose
from sfm_mvs_tpu.ops.five_point import essential_five_point, real_roots_deg10
from sfm_mvs_tpu.utils.synthetic import make_scene


def _synth_pair(seed, planar=False, n=20):
    rng = np.random.default_rng(seed)
    aa = rng.normal(size=3) * 0.3
    R = np.asarray(lie.so3_exp(jnp.asarray(aa, jnp.float32)))
    t = rng.normal(size=3).astype(np.float32)
    t /= np.linalg.norm(t)
    X = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(3, 6, size=n)
    if planar:
        X[:, 2] = 4.0 + 0.3 * X[:, 0] + 0.2 * X[:, 1]
    X2 = X @ R.T + t
    assert (X2[:, 2] > 0.1).all()
    x1 = X[:, :2] / X[:, 2:3]
    x2 = X2[:, :2] / X2[:, 2:3]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = tx @ R
    return x1, x2, E / np.linalg.norm(E), R, t


def test_real_roots_deg10():
    """Roots of a polynomial with known real roots, inside and outside |z|<1."""
    true = np.array([-7.5, -2.0, -0.3, 0.6, 1.0, 4.0], dtype=np.float64)
    # degree 10 = 6 real roots x (z^2+1)(z^2+4) complex quartic
    c = np.poly(np.concatenate([true, [1j, -1j, 2j, -2j]])).real
    roots, valid = jax.jit(real_roots_deg10)(jnp.asarray(c, jnp.float32))
    found = np.sort(np.asarray(roots)[np.asarray(valid)])
    assert valid.sum() == 6
    np.testing.assert_allclose(found, true, atol=2e-4)


@pytest.mark.parametrize("planar", [False, True])
def test_five_point_exactness_and_identifiability(planar):
    """Some returned E satisfies ALL 20 correspondences, not just the 5."""
    for seed in range(6):
        x1, x2, E_true, _, _ = _synth_pair(seed, planar=planar)
        Es, valid = jax.jit(essential_five_point)(
            jnp.asarray(x1[:5]), jnp.asarray(x2[:5])
        )
        Es, valid = np.asarray(Es), np.asarray(valid)
        assert valid.sum() >= 1
        h1 = np.concatenate([x1, np.ones((20, 1))], 1)
        h2 = np.concatenate([x2, np.ones((20, 1))], 1)
        best = np.inf
        for k in range(Es.shape[0]):
            if not valid[k]:
                continue
            E = Es[k] / np.linalg.norm(Es[k])
            best = min(best, np.abs(np.sum(h2 * (h1 @ E.T), 1)).max())
        assert best < 2e-3, f"seed={seed} planar={planar}: residual {best}"


def test_five_point_recovers_true_essential_nonplanar():
    """Non-planar scenes: the true E itself is among the solutions."""
    hits = 0
    for seed in range(6):
        x1, x2, E_true, _, _ = _synth_pair(seed, planar=False)
        Es, valid = jax.jit(essential_five_point)(
            jnp.asarray(x1[:5]), jnp.asarray(x2[:5])
        )
        Es, valid = np.asarray(Es), np.asarray(valid)
        d = min(
            min(np.abs(Es[k] / np.linalg.norm(Es[k]) - s * E_true).max()
                for s in (1, -1))
            for k in range(Es.shape[0]) if valid[k]
        )
        hits += d < 5e-3
    assert hits >= 5  # allow one f32-precision miss


def test_ransac_essential_5pt_with_outliers(rng):
    scene = make_scene(num_points=512, num_cameras=2)
    uv0, _ = scene.project(0)
    uv1, _ = scene.project(1)
    n_out = int(512 * 0.35)
    out_idx = rng.choice(512, size=n_out, replace=False)
    uv1 = uv1.copy()
    uv1[out_idx] = rng.uniform(0, 600, size=(n_out, 2))
    K = jnp.asarray(scene.K)
    n0 = projection.normalize_points(jnp.asarray(uv0.astype(np.float32)), K)
    n1 = projection.normalize_points(jnp.asarray(uv1.astype(np.float32)), K)
    res = ransac.ransac_essential(
        jax.random.PRNGKey(0), n0, n1, jnp.ones(512, dtype=bool), K[0, 0],
        threshold_px=1.0, iters=64, solver="5pt",
    )
    inl = np.asarray(res.inliers)
    assert not inl[out_idx].any()
    assert inl.sum() > 0.6 * (512 - n_out)
    R0, t0 = scene.Rt[0, :, :3], scene.Rt[0, :, 3]
    R1, t1 = scene.Rt[1, :, :3], scene.Rt[1, :, 3]
    R_rel = R1 @ R0.T
    t_rel = t1 - R_rel @ t0
    t_rel /= np.linalg.norm(t_rel)
    R, t, _ = recover_pose(res.model, n0, n1, res.inliers)
    assert np.abs(np.asarray(R) - R_rel).max() < 5e-3
    assert np.abs(np.asarray(t) - t_rel).max() < 5e-3


def test_ransac_5pt_planar_scene():
    """Planar scene: 8-point is structurally degenerate, 5-point is not.

    The pose recovered through the 5pt path must match ground truth (up to
    the planar twofold ambiguity, resolved by cheirality here).
    """
    x1, x2, E_true, R_true, t_true = _synth_pair(11, planar=True, n=256)
    n0, n1 = jnp.asarray(x1), jnp.asarray(x2)
    res = ransac.ransac_essential(
        jax.random.PRNGKey(1), n0, n1, jnp.ones(256, dtype=bool),
        jnp.asarray(1200.0), threshold_px=1.0, iters=64, solver="5pt",
    )
    assert int(res.num_inliers) > 200
    R, t, _ = recover_pose(res.model, n0, n1, res.inliers)
    # The model must explain essentially all correspondences geometrically.
    from sfm_mvs_tpu.ops.epipolar import (
        decompose_homography, epipolar_residual_pixels,
    )
    res_px = np.asarray(
        epipolar_residual_pixels(res.model, n0, n1, jnp.asarray(1200.0)))
    assert np.median(res_px) < 0.1
    # A strictly planar scene has a twofold (R, t) ambiguity that no
    # two-view method can resolve (both poses have full cheirality).
    # Assert the recovered pose lies in the legitimate ambiguity set: the
    # Faugeras decompositions of the scene's true homography
    # H = R + t n^T / d.
    nvec = np.array([-0.3, -0.2, 1.0])
    d = 4.0  # plane: z - 0.3x - 0.2y = 4 -> n.X = d with this (n, d)
    H_true = R_true + np.outer(t_true, nvec / d)
    Rs, ts, _ = decompose_homography(jnp.asarray(H_true, jnp.float32))
    rot_errs = [
        np.degrees(np.arccos(np.clip(
            (np.trace(np.asarray(R).T @ np.asarray(Rc)) - 1) / 2, -1, 1)))
        for Rc in Rs
    ]
    assert min(rot_errs) < 0.5, f"rotation errors vs ambiguity set: {rot_errs}"
    k = int(np.argmin(rot_errs))
    tc = np.asarray(ts[k])
    tc = tc / np.linalg.norm(tc)
    assert min(np.abs(np.asarray(t) - tc).max(),
               np.abs(np.asarray(t) + tc).max()) < 0.02


def test_five_point_matches_cv2_oracle():
    """Cross-check recovered pose against cv2.findEssentialMat (5-point)."""
    cv2 = pytest.importorskip("cv2")
    x1, x2, _, R_true, t_true = _synth_pair(3, planar=False, n=128)
    noise = np.random.default_rng(0).normal(size=x1.shape).astype(np.float32)
    x1n = x1 + 3e-4 * noise  # ~0.36px at f=1200
    E_cv, _ = cv2.findEssentialMat(
        x1n, x2, np.eye(3), method=cv2.RANSAC, prob=0.999, threshold=1.0 / 1200
    )
    _, R_cv, t_cv, _ = cv2.recoverPose(E_cv, x1n, x2, np.eye(3))
    res = ransac.ransac_essential(
        jax.random.PRNGKey(2), jnp.asarray(x1n), jnp.asarray(x2),
        jnp.ones(128, dtype=bool), jnp.asarray(1200.0),
        threshold_px=1.0, iters=64, solver="5pt",
    )
    R, t, _ = recover_pose(
        res.model, jnp.asarray(x1n), jnp.asarray(x2), res.inliers
    )
    # both should be near truth; compare each to ground truth
    for Rx, tx in ((np.asarray(R), np.asarray(t)), (R_cv, t_cv.ravel())):
        rot_err = np.degrees(np.arccos(
            np.clip((np.trace(Rx.T @ R_true) - 1) / 2, -1, 1)))
        assert rot_err < 0.3
        assert min(np.abs(tx - t_true).max(), np.abs(tx + t_true).max()) < 0.02
