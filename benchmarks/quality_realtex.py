"""Real-texture validation: the quality matrix on real image statistics.

Every other end-to-end number in this repo comes from synthetic value-noise
textures. The reference's only validation is real photographs (README.md:14,
30 — the 57-image Gustav II Adolf sequence, which is not shipped). This
benchmark narrows that gap: the staircase renderer is textured with the
PIXELS of the reference's one shipped photograph (`/root/reference/
image.jpg`, 1936x1296), so the detector/matcher run on real contrast and
gradient statistics while the geometry stays exactly known.

Three parts:
1. the 5-scenario quality matrix re-run on the real texture (ATE /
   rotation bounds),
2. a 20-frame end-to-end with per-frame BA + finalize,
3. detector/matcher statistics vs cv2 (test oracle) on the same frames:
   SIFT keypoint counts, ratio-surviving match yield, and two-view E
   inlier rates.

    python benchmarks/quality_realtex.py

Writes artifacts/QUALITY_realtex.json and prints it as one JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "artifacts")
REF_IMAGE = "/root/reference/image.jpg"

SCENARIOS = [
    {"name": "easy_wide", "arc": 24, "spread": 2.0, "size": (320, 240), "frames": 5},
    {"name": "small_baseline", "arc": 8, "spread": 2.0, "size": (320, 240), "frames": 5},
    {"name": "shallow_relief", "arc": 20, "spread": 0.8, "size": (320, 240), "frames": 5},
    {"name": "high_res", "arc": 24, "spread": 2.0, "size": (640, 480), "frames": 5},
    {"name": "long_arc", "arc": 60, "spread": 2.0, "size": (320, 240), "frames": 8},
]

# Photometric nuisance grid (round 4): real photographs differ from clean
# renders not just in texture statistics but in exposure drift between
# frames, sensor noise, and focus/motion blur. Each nuisance is applied to
# the RENDERED frames (geometry stays exact), so the quality bounds below
# measure the front end's photometric robustness, not geometric luck.
NUISANCES = [
    {"name": "clean"},
    # Exposure ramps 0.7x -> 1.3x across the sequence (auto-exposure walking
    # during capture); also exercises the descriptor normalization chain.
    {"name": "exposure_ramp", "gain_lo": 0.7, "gain_hi": 1.3},
    # Sensor noise at sigma = 2% full scale (~5 DN on 8-bit).
    {"name": "sensor_noise", "sigma": 0.02},
    # Mild defocus/motion blur: 1.0 px Gaussian.
    {"name": "blur", "sigma_px": 1.0},
    # Everything at once.
    {"name": "combined", "gain_lo": 0.75, "gain_hi": 1.25,
     "sigma": 0.015, "sigma_px": 0.8},
]


def apply_nuisance(imgs, spec, seed=0):
    """Apply a photometric nuisance spec to a list of float [0,1] frames."""
    rng = np.random.default_rng(seed)
    out = []
    n = len(imgs)
    for f, img in enumerate(imgs):
        x = np.asarray(img, np.float32)
        if "sigma_px" in spec and spec["sigma_px"] > 0:
            s = spec["sigma_px"]
            r = max(1, int(3 * s))
            k = np.exp(-0.5 * (np.arange(-r, r + 1) / s) ** 2)
            k /= k.sum()
            x = np.apply_along_axis(
                lambda row: np.convolve(row, k, mode="same"), 1, x
            )
            x = np.apply_along_axis(
                lambda col: np.convolve(col, k, mode="same"), 0, x
            )
        if "gain_lo" in spec:
            g = spec["gain_lo"] + (spec["gain_hi"] - spec["gain_lo"]) * (
                f / max(n - 1, 1)
            )
            x = x * g
        if "sigma" in spec and spec["sigma"] > 0:
            x = x + rng.normal(0.0, spec["sigma"], x.shape).astype(np.float32)
        out.append(np.clip(x, 0.0, 1.0).astype(np.float32))
    return out


def cv2_frontend_stats(imgs, lowe=0.75):
    """cv2-oracle statistics on the same frames: keypoints + match yield."""
    try:
        import cv2
    except Exception:
        return None
    sift = cv2.SIFT_create()
    kps, descs = [], []
    for g in imgs:
        k, d = sift.detectAndCompute((g * 255).astype(np.uint8), None)
        kps.append(k)
        descs.append(d)
    bf = cv2.BFMatcher()
    yields = []
    for i in range(len(imgs) - 1):
        if descs[i] is None or descs[i + 1] is None:
            yields.append(0)
            continue
        mm = bf.knnMatch(descs[i], descs[i + 1], k=2)
        good = [m for m, n in mm if m.distance < lowe * n.distance]
        yields.append(len(good))
    return {
        "kp_per_frame": round(float(np.mean([len(k) for k in kps])), 1),
        "matches_per_pair": round(float(np.mean(yields)), 1),
    }


def our_frontend_stats(imgs, cfg):
    import jax.numpy as jnp

    from sfm_mvs_tpu.ops import matching, sift

    feats = [sift.detect_and_compute(jnp.asarray(g), cfg.frontend) for g in imgs]
    counts = [int(np.asarray(f.valid).sum()) for f in feats]
    yields = []
    for i in range(len(imgs) - 1):
        m = matching.match_with_config(
            feats[i].desc, feats[i + 1].desc,
            feats[i].valid, feats[i + 1].valid, cfg.frontend,
        )
        yields.append(int(np.asarray(m.valid).sum()))
    return {
        "kp_per_frame": round(float(np.mean(counts)), 1),
        "matches_per_pair": round(float(np.mean(yields)), 1),
    }


def main():
    from sfm_mvs_tpu.utils import cache

    cache.enable()
    from sfm_mvs_tpu.models.incremental import IncrementalSfM
    from sfm_mvs_tpu.models.refine import finalize_map
    from sfm_mvs_tpu.utils import evaluate
    from sfm_mvs_tpu.utils.config import (
        FrontendConfig, MapConfig, RansacConfig, SfmConfig,
    )
    from sfm_mvs_tpu.utils.synthetic import load_image_texture, render_staircase_sequence

    tex = load_image_texture(REF_IMAGE, 1024)
    out = {"texture": REF_IMAGE, "texture_std": round(float(tex.std()), 4)}

    # --- 1. quality matrix on the real texture ---
    rows = []
    for sc in SCENARIOS:
        W, H = sc["size"]
        focal = 400.0 * W / 320.0
        imgs, Rt_gt, K = render_staircase_sequence(
            num_cameras=sc["frames"], arc_degrees=sc["arc"],
            depth_spread=sc["spread"], image_size=sc["size"], focal=focal,
            texture=tex,
        )
        cfg = SfmConfig(
            fx=focal, fy=focal, cx=W / 2, cy=H / 2, downscale=1,
            frontend=FrontendConfig(
                max_features=1024, num_octaves=3, upsample_input=True,
                contrast_threshold=0.015, lowe_ratio=0.75,
            ),
            ransac=RansacConfig(),
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
                row["ate_rel"] = round(float(ate) / scene_scale, 5)
                row["rot_max_deg"] = round(float(rot.max()), 3)
            rows.append(row)
        except Exception as e:
            rows.append({"scenario": sc["name"], "error": str(e)[:120]})
        print(json.dumps(rows[-1]), file=sys.stderr)
    out["matrix"] = rows

    # --- 1b. photometric nuisance grid on the real texture (round 4) ---
    # One mid-difficulty scenario (easy_wide geometry) per nuisance; the
    # bounds assert that exposure drift / sensor noise / blur do not break
    # registration or degrade the trajectory beyond 2x the clean bound.
    W, H = 320, 240
    focal = 400.0
    base_imgs, Rt_nu, K_nu = render_staircase_sequence(
        num_cameras=5, arc_degrees=24, depth_spread=2.0,
        image_size=(W, H), focal=focal, texture=tex,
    )
    nui_rows = []
    for spec in NUISANCES:
        imgs_n = apply_nuisance(base_imgs, spec)
        cfg = SfmConfig(
            fx=focal, fy=focal, cx=W / 2, cy=H / 2, downscale=1,
            frontend=FrontendConfig(
                max_features=1024, num_octaves=3, upsample_input=True,
                contrast_threshold=0.015, lowe_ratio=0.75,
            ),
            ransac=RansacConfig(),
            map=MapConfig(max_cameras=16, max_points=16384),
        )
        row = {"nuisance": spec["name"]}
        try:
            sfm = IncrementalSfM(cfg)
            state = sfm.run(imgs_n)
            state, _ = finalize_map(state, max_iterations=10)
            pv = np.asarray(state.cam_valid)
            registered = int(pv.sum())
            row["registered"] = f"{registered}/5"
            row["matches_per_pair"] = round(
                float(np.mean([s["matches"] for s in sfm.stats])), 1
            )
            if registered == 5:
                poses = np.asarray(state.poses)[pv]
                scene_scale = float(
                    np.linalg.norm(
                        evaluate.camera_centers(Rt_nu), axis=1
                    ).mean()
                )
                row["ate_rel"] = round(
                    float(evaluate.ate_rmse(poses, Rt_nu)) / scene_scale, 5
                )
                row["rot_max_deg"] = round(
                    float(evaluate.rotation_errors_deg(poses, Rt_nu).max()), 3
                )
        except Exception as e:
            row["error"] = str(e)[:120]
        nui_rows.append(row)
        print(json.dumps(row), file=sys.stderr)
    out["nuisance_grid"] = nui_rows

    # --- 1c. second texture (the reference's shipped result render) ---
    tex2_path = "/root/reference/Result/result.png"
    if os.path.exists(tex2_path):
        tex2 = load_image_texture(tex2_path, 1024)
        imgs2, Rt2, _ = render_staircase_sequence(
            num_cameras=5, arc_degrees=24, depth_spread=2.0,
            image_size=(W, H), focal=focal, texture=tex2,
        )
        cfg = SfmConfig(
            fx=focal, fy=focal, cx=W / 2, cy=H / 2, downscale=1,
            frontend=FrontendConfig(
                max_features=1024, num_octaves=3, upsample_input=True,
                contrast_threshold=0.015, lowe_ratio=0.75,
            ),
            ransac=RansacConfig(),
            map=MapConfig(max_cameras=16, max_points=16384),
        )
        row = {"texture2": tex2_path}
        try:
            sfm = IncrementalSfM(cfg)
            state = sfm.run(imgs2)
            state, _ = finalize_map(state, max_iterations=10)
            pv = np.asarray(state.cam_valid)
            registered = int(pv.sum())
            row["registered"] = f"{registered}/5"
            if registered == 5:
                poses = np.asarray(state.poses)[pv]
                ss = float(
                    np.linalg.norm(evaluate.camera_centers(Rt2), axis=1).mean()
                )
                row["ate_rel"] = round(
                    float(evaluate.ate_rmse(poses, Rt2)) / ss, 5
                )
        except Exception as e:
            row["error"] = str(e)[:120]
        out["texture2_run"] = row
        print(json.dumps(row), file=sys.stderr)

    # --- 2. 20-frame end-to-end with per-frame BA + finalize ---
    W, H = 480, 360
    focal = 600.0
    imgs, Rt_gt, K = render_staircase_sequence(
        num_cameras=20, image_size=(W, H), focal=focal,
        radius=9.0, arc_degrees=24.0, num_strips=12, depth_spread=2.0,
        texture=tex,
    )
    from sfm_mvs_tpu.utils.config import BaConfig

    cfg = SfmConfig(
        fx=focal, fy=focal, cx=W / 2, cy=H / 2, downscale=1,
        frontend=FrontendConfig(
            max_features=2048, num_octaves=4, upsample_input=True,
            contrast_threshold=0.012, lowe_ratio=0.75,
        ),
        ransac=RansacConfig(essential_iters=1024, pnp_iters=1024),
        ba=BaConfig(enabled=True, max_iterations=8),
        map=MapConfig(max_cameras=32, max_points=32768),
    )
    t0 = time.time()
    sfm = IncrementalSfM(cfg)
    state = sfm.run(imgs)
    state, _ = finalize_map(state, max_iterations=15)
    wall = time.time() - t0
    pv = np.asarray(state.cam_valid)
    poses = np.asarray(state.poses)[pv]
    registered = int(pv.sum())
    e2e = {"registered": f"{registered}/20", "wall_s": round(wall, 1)}
    if registered == 20:
        scene_scale = float(
            np.linalg.norm(evaluate.camera_centers(Rt_gt), axis=1).mean()
        )
        ate = evaluate.ate_rmse(poses, Rt_gt)
        rot = evaluate.rotation_errors_deg(poses, Rt_gt)
        e2e["ate_rel"] = round(float(ate) / scene_scale, 5)
        e2e["rot_max_deg"] = round(float(rot.max()), 3)
        e2e["reproj_max"] = round(max(s["reproj_error"] for s in sfm.stats), 4)
    out["e2e_20frame"] = e2e
    print(json.dumps(e2e), file=sys.stderr)

    # --- 3. detector/matcher statistics vs cv2 on the same frames ---
    sample = imgs[:6]
    ours = our_frontend_stats(sample, cfg)
    theirs = cv2_frontend_stats(sample, lowe=cfg.frontend.lowe_ratio)
    out["frontend_ours"] = ours
    out["frontend_cv2"] = theirs
    if theirs and theirs["matches_per_pair"] > 0:
        out["match_yield_vs_cv2"] = round(
            ours["matches_per_pair"] / theirs["matches_per_pair"], 3
        )
    print(json.dumps({"ours": ours, "cv2": theirs}), file=sys.stderr)

    os.makedirs(ART, exist_ok=True)
    with open(os.path.join(ART, "QUALITY_realtex.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
