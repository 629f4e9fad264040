"""Benchmark: full incremental SfM with per-frame bundle adjustment.

Reconstructs a Gustav-scale synthetic sequence — 57 frames at 968x648, the
reference's post-downscale resolution (BASELINE.md) — running the complete
per-frame pipeline: SIFT detection, KNN matching, PnP-RANSAC registration,
triangulation, AND a global sparse-Schur LM bundle adjustment every frame
(strictly more optimization work than the reference's per-frame local BA).

Engineering notes: each frame runs three separately-jitted programs
(detect / register / BA — measured faster than one fused program, see
docs/DESIGN.md §5); frames are pre-staged to device memory as uint8 and
no host syncs happen inside the timed loop, so dispatches pipeline.

Baseline: the reference's only published wall-clock number — bundle-
adjusted frames take "close to half a minute per frame" (sfm.py:378),
i.e. ~0.033 frames/s. vs_baseline is the speedup over that.

Prints ONE JSON line to stdout. Extra diagnostics go to stderr.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

N_FRAMES = int(os.environ.get("BENCH_FRAMES", "57"))
# The timed loop reruns BENCH_REPS times with warm compiles; the canonical
# value is the MEDIAN of the warm reps (rep 0 is the dispatch-warmup pass).
# Each rep times BENCH_PASSES consecutive replays of the sequence, every
# pass value-distinct and data-chained through the previous pass's BA
# output.
N_REPS = int(os.environ.get("BENCH_REPS", "7"))
N_PASSES = int(os.environ.get("BENCH_PASSES", "6"))
IMAGE_SIZE = (
    (968, 648)
    if os.environ.get("BENCH_SMALL", "0") != "1"
    else (320, 240)
)
REFERENCE_BA_FPS = 1.0 / 30.0  # sfm.py:378: ~30 s/frame with BA


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp
    from functools import partial

    from sfm_mvs_tpu.models import ba, map_store
    from sfm_mvs_tpu.models.incremental import init_from_bootstrap, register_frame
    from sfm_mvs_tpu.ops import sift
    from sfm_mvs_tpu.utils import cache, evaluate
    from sfm_mvs_tpu.utils.config import (
        FrontendConfig, MapConfig, RansacConfig, SfmConfig,
    )
    from sfm_mvs_tpu.utils.synthetic import render_staircase_sequence

    log(f"compile cache: {cache.enable()}")
    log(f"devices: {jax.devices()}")
    W, H = IMAGE_SIZE
    focal = 1200.0 * W / 968.0

    t0 = time.time()
    imgs, Rt_gt, K = render_staircase_sequence(
        num_cameras=N_FRAMES,
        image_size=IMAGE_SIZE,
        focal=focal,
        radius=9.0,
        arc_degrees=50.0,
        num_strips=10,
        depth_spread=2.0,
    )
    log(f"rendered {N_FRAMES} frames {W}x{H} in {time.time()-t0:.1f}s")

    cfg = SfmConfig(
        fx=focal, fy=focal, cx=W / 2.0, cy=H / 2.0, downscale=1,
        frontend=FrontendConfig(
            max_features=4096, num_octaves=4, upsample_input=True,
            contrast_threshold=0.012, lowe_ratio=0.75,
        ),
        ransac=RansacConfig(essential_iters=2048, pnp_iters=1024),
        # Provisioned ~7x above the scene's peak point count; BA cost is
        # capacity-proportional (dense grid), so right-sizing matters.
        map=MapConfig(max_cameras=64, max_points=16384),
    )
    Kj = jnp.asarray(cfg.intrinsic_matrix())

    # Pre-stage the whole sequence on device as uint8 (143MB at full res).
    t0 = time.time()
    stack8 = jax.device_put(
        np.stack([(g * 255.0).astype(np.uint8) for g in imgs])
    )
    jax.block_until_ready(stack8)
    log(f"staged {N_FRAMES} frames to device in {time.time()-t0:.1f}s")

    @partial(jax.jit, static_argnames=())
    def detect_u8(img8, eps=0.0):
        # eps is a zero-VALUED but data-dependent scalar that chains each
        # pass's inputs to the previous pass's output.
        return sift.detect_and_compute(
            img8.astype(jnp.float32) / 255.0 + eps, cfg.frontend
        )

    def gray_bgr(img8):
        return jnp.repeat(img8[..., None], 3, axis=-1).astype(jnp.float32)

    # Three programs per frame (detect / register / BA), as the driver
    # runs them (docs/DESIGN.md §5).
    def frame_step(key, pstate, img8, eps=0.0):
        feats = detect_u8(img8, eps)
        pstate, st = register_frame(key, pstate, feats, gray_bgr(img8), cfg)
        mstate, ba_stats = ba.bundle_adjust_map(
            pstate.map, max_iterations=8, cg_iters=15
        )
        return pstate._replace(map=mstate), st, ba_stats

    key = jax.random.PRNGKey(0)

    # --- Compile warmup (frames 0-2), not timed. ---
    t0 = time.time()
    f0, f1 = detect_u8(stack8[0]), detect_u8(stack8[1])
    key, k0 = jax.random.split(key)
    pstate0, st = init_from_bootstrap(k0, f0, f1, gray_bgr(stack8[1]), Kj, cfg)
    key, k1 = jax.random.split(key)
    pstate, _, _ = frame_step(k1, pstate0, stack8[2], jnp.float32(0.0))
    jax.block_until_ready(pstate.map.points)
    log(f"compile+bootstrap: {time.time()-t0:.1f}s")

    # --- Timed steady-state loop: frames 3..N-1, one dispatch per frame.
    # Repeated N_REPS times; each rep times N_PASSES consecutive replays
    # of the sequence from the same post-bootstrap device state. Every
    # pass is value-distinct (a fresh 1e-6-scale eps, far below any
    # detection threshold) and data-chained through the previous pass's
    # BA output.
    n_timed = (N_FRAMES - 3) * max(1, N_PASSES)
    keys = jax.random.split(key, N_FRAMES)
    rep_fps = []
    eps = jnp.float32(0.0)  # becomes data-dependent after the first pass
    pass_no = 0
    timed_t0 = time.time()
    for rep in range(max(1, N_REPS)):
        pstate2, _, ba_stats = frame_step(k1, pstate0, stack8[2], eps)
        jax.block_until_ready(pstate2.map.points)
        ba_costs = []
        t0 = time.time()
        for _p in range(max(1, N_PASSES)):
            pstate = pstate2  # post-frame-2 state: passes replay 3..N-1
            for i in range(3, N_FRAMES):
                pstate, st, ba_stats = frame_step(keys[i], pstate, stack8[i], eps)
                ba_costs.append(ba_stats.final_cost)  # device scalars, no sync
            # Accumulating, data-dependent carry into the next pass.
            pass_no += 1
            eps = ba_stats.final_cost * 0.0 + jnp.float32(1e-6) * pass_no
        jax.block_until_ready(pstate.map.points)
        elapsed = time.time() - t0
        rep_fps.append(n_timed / elapsed)
        log(f"rep {rep}: frames/s={rep_fps[-1]:.3f} ({elapsed:.2f}s)")
    timed_wall = time.time() - timed_t0
    # Canonical value: median of the WARM reps — rep 0 is the
    # dispatch-warmup pass.
    warm = rep_fps[1:] if len(rep_fps) > 2 else rep_fps
    fps = float(np.median(warm))
    spread = float((max(warm) - min(warm)) / fps) if len(warm) > 1 else 0.0
    elapsed = n_timed / fps
    # Wall cross-check: the sum of per-rep windows must account for most
    # of the timed section's wall clock, else block_until_ready returned
    # without waiting.
    window_sum = sum(n_timed / f for f in rep_fps)
    if window_sum < 0.5 * timed_wall - 2.0:
        log(
            f"WARNING: timed windows sum to {window_sum:.1f}s inside a "
            f"{timed_wall:.1f}s wall — timing suspect, treat fps "
            f"as an upper bound"
        )

    state = pstate.map
    n_cams = int(np.asarray(state.cam_valid).sum())
    poses = np.asarray(state.poses)[np.asarray(state.cam_valid)]
    ate = evaluate.ate_rmse(poses, Rt_gt[:n_cams]) if n_cams == N_FRAMES else float("nan")
    final_rms = float(np.sqrt(np.asarray(ba_costs[-1])))
    log(
        f"frames/s={fps:.3f} median of {len(warm)} warm reps "
        f"(spread {100*spread:.1f}%), ({n_timed} frames in {elapsed:.1f}s), "
        f"registered {n_cams}/{N_FRAMES} cams, "
        f"{int(state.num_points)} points, {int(map_store.num_observations(state))} obs, "
        f"final BA rms={final_rms:.4f}px, ATE={ate:.5f}"
    )

    # --- Finalize: densification sweep to reference cloud density. ---
    # The reference's Gustav artifact holds 19,282 points (sparse.ply:3,
    # the accumulate-everything loop sfm.py:387-395); the registration
    # loop above keeps a deduplicated track map instead, so density is
    # restored by a one-time per-pair sweep at a denser detection budget
    # from the final bundle-adjusted trajectory.
    import dataclasses

    from sfm_mvs_tpu.models import densify
    from sfm_mvs_tpu.utils.config import SweepConfig

    t0 = time.time()
    small = os.environ.get("BENCH_SMALL", "0") == "1"
    # Sweep detection is CONTRAST-limited on this scene, not budget-limited
    # (measured: ct=0.006 -> ~1.2k valid features, ct=0.0025 -> ~2.5k with
    # ~1.9k matches/pair), so density comes from the lower threshold; the
    # 4096 budget already holds the yield and keeps matching cheap.
    cfg_sweep = dataclasses.replace(
        cfg,
        sweep=SweepConfig(
            enabled=True,
            grow_points=16384 if small else 65536,
            reproj_px=1.5,
            max_features=4096,
            contrast_threshold=0.0025,
            pair_strides=(1, 2),
        ),
    )
    sweep_feats = densify.redetect_for_sweep(
        [stack8[i].astype(jnp.float32) / 255.0 for i in range(N_FRAMES)],
        cfg_sweep,
    )
    state, sweep_info = densify.finalize_with_sweep(
        state, sweep_feats, [gray_bgr(stack8[i]) for i in range(N_FRAMES)],
        cfg_sweep,
    )
    jax.block_until_ready(state.points)
    n_pts = int(np.asarray(state.point_valid).sum())
    n_obs = int(map_store.num_observations(state))
    rms_sweep = float(np.sqrt(sweep_info["final_cost"]))
    poses = np.asarray(state.poses)[np.asarray(state.cam_valid)]
    ate_sweep = (
        evaluate.ate_rmse(poses, Rt_gt[:n_cams]) if n_cams == N_FRAMES else float("nan")
    )
    log(
        f"densify sweep: {n_pts} points ({sweep_info['swept_points']} swept), "
        f"{n_obs} obs, rms={rms_sweep:.4f}px, ATE={ate_sweep:.5f}, "
        f"{time.time()-t0:.1f}s one-time"
    )
    ply_path = os.environ.get("BENCH_PLY", "")
    if ply_path:
        from sfm_mvs_tpu.utils import io as sfm_io

        # Reference export semantics (x200 scale + centroid cut), with the
        # cut radius sized to THIS scene's extent (the reference's +300 is
        # tuned to Gustav's statue scale; the staircase scene is wider, so
        # the same constant would slice off real structure).
        n_ply = sfm_io.map_to_ply(ply_path, state, outlier_offset=900.0)
        log(f"wrote {n_ply} vertices to {ply_path}")

    print(
        json.dumps(
            {
                "metric": "gustav_scale_57frame_sfm_with_per_frame_ba",
                "value": round(fps, 4),
                "unit": "frames/s",
                "vs_baseline": round(fps / REFERENCE_BA_FPS, 2),
                "reps": [round(f, 3) for f in rep_fps],
                "warm_spread_pct": round(100 * spread, 1),
                "frames_per_rep_window": n_timed,
            }
        )
    )


if __name__ == "__main__":
    main()
