"""End-to-end demo: reconstruct a rendered sequence and export everything.

Produces the same artifact set as the reference's Gustav run (sparse.ply,
pose.csv) plus the outputs the reference never shipped: camera frusta,
per-frame metrics, a dense MVS cloud, and a reprojection-error plot.

    python examples/run_synthetic.py [out_dir]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(out_dir: str = "/tmp/sfm_demo"):
    from sfm_mvs_tpu.models import mvs
    from sfm_mvs_tpu.models.incremental import IncrementalSfM
    from sfm_mvs_tpu.utils import cache, evaluate, io, metrics, viz
    from sfm_mvs_tpu.utils.config import (
        BaConfig, FrontendConfig, MapConfig, SfmConfig,
    )
    from sfm_mvs_tpu.utils.synthetic import render_staircase_sequence

    cache.enable()
    imgs, Rt_gt, K = render_staircase_sequence(
        num_cameras=10, arc_degrees=35, image_size=(480, 360), focal=600.0
    )
    cfg = SfmConfig(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]), cy=float(K[1, 2]),
        downscale=1,
        frontend=FrontendConfig(
            max_features=2048, num_octaves=3, upsample_input=True,
            contrast_threshold=0.012, lowe_ratio=0.75,
        ),
        ba=BaConfig(enabled=True, cadence=2, max_iterations=8),
        map=MapConfig(max_cameras=16, max_points=32768),
    )
    os.makedirs(out_dir, exist_ok=True)
    logger = metrics.MetricsLogger(os.path.join(out_dir, "metrics.jsonl"))
    sfm = IncrementalSfM(cfg, metrics=logger)
    state = sfm.run(imgs)

    n = io.map_to_ply(os.path.join(out_dir, "sparse.ply"), state)
    io.map_pose_csv(os.path.join(out_dir, "pose.csv"), state)
    poses = np.asarray(state.poses)[np.asarray(state.cam_valid)]
    viz.save_camera_frusta_ply(os.path.join(out_dir, "cameras.ply"), poses)
    viz.save_error_plot(
        os.path.join(out_dir, "reproj_error.png"),
        [s["reproj_error"] for s in sfm.stats],
    )
    dpts, dcols = mvs.densify_map(imgs, state, num_depths=64, stride=2)
    nd = io.to_ply(os.path.join(out_dir, "dense.ply"), dpts, dcols)

    ate = evaluate.ate_rmse(poses, Rt_gt[: len(poses)])
    print(f"cameras: {len(poses)}/10, sparse: {n} pts, dense: {nd} pts")
    print(f"ATE RMSE: {ate:.5f} (scene scale ~8)")
    print(f"summary: {logger.summary()}")
    print(f"artifacts -> {out_dir}/")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "/tmp/sfm_demo")
