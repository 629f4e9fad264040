"""Trajectory-replay harness pieces.

The reference ships pose.csv but not the Gustav images; the replay
renders a solid-textured 3D object from those exact 57 poses and the
pipeline must re-recover the trajectory (benchmarks/replay_reference.py
runs the full thing). These tests cover the harness itself on CPU.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from sfm_mvs_tpu.utils.synthetic import (
    estimate_lookat_target,
    load_reference_trajectory,
    render_object_from_poses,
)

POSE_CSV = "/root/reference/pose.csv"

pytestmark = pytest.mark.skipif(
    not os.path.exists(POSE_CSV), reason="reference pose.csv not present"
)


def test_load_reference_trajectory():
    K, Rt = load_reference_trajectory(POSE_CSV)
    assert Rt.shape == (57, 3, 4)
    # BASELINE.md intrinsics (post-downscale Gustav K, sfm.py:16-23).
    assert abs(K[0, 0] - 1196.98) < 0.1
    assert abs(K[1, 1] - 1199.06) < 0.1
    # Rotations orthonormalized to machine precision.
    for i in (0, 28, 56):
        R = Rt[i, :, :3]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
        assert np.linalg.det(R) > 0.99
    # The trajectory is the full statue orbit: camera centers stay ~9
    # units from the look-at target all the way around.
    target = estimate_lookat_target(Rt)
    C = np.stack([-Rt[i, :, :3].T @ Rt[i, :, 3] for i in range(57)])
    d = np.linalg.norm(C - target, axis=1)
    assert 8.0 < np.median(d) < 10.0
    assert d.max() - d.min() < 2.0


def test_render_object_matchable_and_geometrically_consistent():
    """The raytraced statue yields matchable features whose two-view
    geometry reproduces the ground-truth relative pose."""
    import jax

    from sfm_mvs_tpu.models.two_view import bootstrap
    from sfm_mvs_tpu.ops import sift
    from sfm_mvs_tpu.utils import evaluate
    from sfm_mvs_tpu.utils.config import (
        FrontendConfig, MapConfig, SfmConfig,
    )

    K, Rt = load_reference_trajectory(POSE_CSV)
    # Half resolution for CPU speed; scale K accordingly.
    Kh = K.copy()
    Kh[:2] *= 0.5
    idx = [20, 21]  # mid-orbit adjacent pair (high elevation)
    imgs, _ = render_object_from_poses(Rt[idx], Kh, image_size=(484, 324))
    cfg = SfmConfig(
        fx=float(Kh[0, 0]), fy=float(Kh[1, 1]),
        cx=float(Kh[0, 2]), cy=float(Kh[1, 2]), downscale=1,
        frontend=FrontendConfig(
            max_features=2048, num_octaves=4, upsample_input=True,
            contrast_threshold=0.006, lowe_ratio=0.75,
        ),
        map=MapConfig(max_cameras=4, max_points=8192),
    )
    feats = [
        sift.detect_and_compute(jnp.asarray(im), cfg.frontend) for im in imgs
    ]
    n0, n1 = int(feats[0].valid.sum()), int(feats[1].valid.sum())
    assert min(n0, n1) > 150
    tv = bootstrap(
        jax.random.PRNGKey(0), feats[0], feats[1],
        jnp.asarray(cfg.intrinsic_matrix()), cfg,
    )
    assert int(tv.num_inliers) > 60
    # Relative rotation must match ground truth within the quality bound.
    R_rel_est = np.asarray(tv.pose1[:, :3]) @ np.asarray(tv.pose0[:, :3]).T
    R_rel_gt = Rt[idx[1], :, :3] @ Rt[idx[0], :, :3].T
    dR = R_rel_est @ R_rel_gt.T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    assert ang < 0.5
    # Translation direction (scale-free) within a couple of degrees.
    t_est = np.asarray(tv.pose1[:, 3])
    C0 = -Rt[idx[0], :, :3].T @ Rt[idx[0], :, 3]
    C1 = -Rt[idx[1], :, :3].T @ Rt[idx[1], :, 3]
    t_gt = -(Rt[idx[1], :, :3] @ (C1 - C0))
    cos = abs(
        float(t_est @ t_gt) / (np.linalg.norm(t_est) * np.linalg.norm(t_gt))
    )
    assert cos > 0.999
