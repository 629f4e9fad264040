"""Reconstruction-quality matrix: accuracy across scene difficulty.

Runs the incremental pipeline over a grid of scene configurations (arc
length, depth relief, resolution) and reports ATE / rotation error / mean
reprojection error for each — the regression surface that catches quality
drift that single-scenario tests miss. Prints one JSON line.

    python benchmarks/quality.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json

import numpy as np

SCENARIOS = [
    {"name": "easy_wide", "arc": 24, "spread": 2.0, "size": (320, 240), "frames": 5},
    {"name": "small_baseline", "arc": 8, "spread": 2.0, "size": (320, 240), "frames": 5},
    {"name": "shallow_relief", "arc": 20, "spread": 0.8, "size": (320, 240), "frames": 5},
    {"name": "high_res", "arc": 24, "spread": 2.0, "size": (640, 480), "frames": 5},
    {"name": "long_arc", "arc": 60, "spread": 2.0, "size": (320, 240), "frames": 8},
    # Radial distortion scenario (round 4): frames rendered with
    # (k1, k2) = (-0.18, 0.03); cfg carries the SAME coefficients, so the
    # front-door undistortion must hold the clean-scenario bounds.
    {"name": "distorted_k1k2", "arc": 24, "spread": 2.0, "size": (320, 240),
     "frames": 5, "dist": (-0.18, 0.03)},
]


def main():
    from sfm_mvs_tpu.utils import cache

    cache.enable()
    solver = os.environ.get("QUALITY_SOLVER", "8pt")
    from sfm_mvs_tpu.models.incremental import IncrementalSfM
    from sfm_mvs_tpu.models.refine import finalize_map
    from sfm_mvs_tpu.utils import evaluate
    from sfm_mvs_tpu.utils.config import FrontendConfig, MapConfig, SfmConfig
    from sfm_mvs_tpu.utils.synthetic import render_staircase_sequence

    rows = []
    for sc in SCENARIOS:
        W, H = sc["size"]
        focal = 400.0 * W / 320.0
        dist = sc.get("dist", (0.0, 0.0))
        imgs, Rt_gt, K = render_staircase_sequence(
            num_cameras=sc["frames"], arc_degrees=sc["arc"],
            depth_spread=sc["spread"], image_size=sc["size"], focal=focal,
            dist=dist,
        )
        from sfm_mvs_tpu.utils.config import RansacConfig

        cfg = SfmConfig(
            fx=focal, fy=focal, cx=W / 2, cy=H / 2, downscale=1,
            k1=dist[0], k2=dist[1],
            frontend=FrontendConfig(
                max_features=1024, num_octaves=3, upsample_input=True,
                contrast_threshold=0.015, lowe_ratio=0.75,
            ),
            ransac=RansacConfig(essential_solver=solver),
            map=MapConfig(max_cameras=16, max_points=16384),
        )
        sfm = IncrementalSfM(cfg)
        try:
            state = sfm.run(imgs)
            state, _ = finalize_map(state, max_iterations=10)
            pv = np.asarray(state.cam_valid)
            poses = np.asarray(state.poses)[pv]
            registered = int(pv.sum())
            scene_scale = float(
                np.linalg.norm(evaluate.camera_centers(Rt_gt), axis=1).mean()
            )
            row = {
                "scenario": sc["name"],
                "registered": f"{registered}/{sc['frames']}",
                "points": int(state.num_points),
            }
            if registered == sc["frames"]:
                ate = evaluate.ate_rmse(poses, Rt_gt)
                rot = evaluate.rotation_errors_deg(poses, Rt_gt)
                row["ate"] = round(float(ate), 5)
                row["ate_rel"] = round(float(ate) / scene_scale, 5)
                row["rot_max_deg"] = round(float(rot.max()), 3)
            row["reproj_max"] = round(
                max(s["reproj_error"] for s in sfm.stats), 4
            )
            rows.append(row)
        except Exception as e:  # keep the matrix running
            rows.append({"scenario": sc["name"], "error": str(e)[:120]})
        print(json.dumps(rows[-1]), file=sys.stderr)
    print(json.dumps({"quality_matrix": rows}))


if __name__ == "__main__":
    main()
