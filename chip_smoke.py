"""Run the system's main path once on an NVIDIA GPU and check what it returns.

    python chip_smoke.py             # one card: phases (a)-(e)
    python chip_smoke.py --cards 4   # four cards: the sharded flow only

One card:

(a) device: JAX's devices and device kind, and nvidia-smi's name and power
    limit. Stops with a non-zero exit unless JAX's platform is ``gpu``;
    nothing runs on the CPU in its place. Turns on the compile cache.
(b) main path: bench.py's sequence (57 frames of the staircase scene at
    968x648, rendered in memory at 8-bit levels as decoded images have)
    through ``IncrementalSfM.run`` with a global BA every frame, then
    ``finalize()`` with bench.py's densification sweep. Gates: every
    camera registered, ATE < 0.01 scene units (the orbit radius is 9),
    final BA RMS < 1 px, >= MIN_SWEPT points added by the sweep.
(c) MVS: ``mvs.densify_map`` over the first 8 reference frames at full
    resolution. Gate: a non-empty dense cloud. Reports the median relative
    depth error against the renderer's depth.
(d) matcher: the matcher the pipeline runs, on two frames' SIFT
    descriptors (4096 x 4096 x 128), against a float64 NumPy brute force.
    Gates: ``valid`` agrees on >= 99.9% of queries; ``idx1`` is identical
    on every query valid in both whose ratio margin |d1 - r^2 d2| / d2
    exceeds 1e-5.
(e) the last line: {"ok": true, "device": {"platform", "kind", "count"}}.

With ``--cards 4``: the sharded flow of ``__graft_entry__._dryrun_scale``
at its bench-like scale (16 cameras at 480x360, a 16384-point map) on a
1-D ("data",) mesh of the four cards: sharded detect and pair matching,
registration, sharded BA checked against single-device BA, sharded MVS.
Checks that the sharded BA's point blocks (the point axis of the
observation grid it shards) sit on four distinct devices.

A failed gate raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np

N_FRAMES = 57
IMAGE_SIZE = (968, 648)
MVS_REFS = 8
MATCH_FRAMES = (10, 11)
# Points the sweep adds on this sequence's 8-bit frames: 36,756-36,860 in
# five H100 runs (bench.py's recipe and this one's). The gate sits 5% below
# the lowest, outside the run-to-run spread and well inside a 20% loss.
MIN_SWEPT = 35_000


def device_phase(cards: int):
    import jax

    from sfm_mvs_tpu.utils import cache

    devices = jax.devices()
    print(f"[a] devices: {devices}")
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found no GPU (platform {devices[0].platform!r}); "
            "no phase runs on the CPU in its place"
        )
    if len(devices) < cards:
        raise SystemExit(f"chip_smoke: {cards} cards asked for, {len(devices)} found")
    print(f"[a] device_kind: {devices[0].device_kind}, count: {len(devices)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    print(f"[a] compile cache: {cache.enable()}")
    return devices


def smoke_config(image_size=IMAGE_SIZE):
    """bench.py's configuration, with its BA and sweep as SfmConfig fields."""
    from sfm_mvs_tpu.utils.config import (
        BaConfig, FrontendConfig, MapConfig, RansacConfig, SfmConfig, SweepConfig,
    )

    W, H = image_size
    focal = 1200.0 * W / 968.0
    return SfmConfig(
        fx=focal, fy=focal, cx=W / 2.0, cy=H / 2.0, downscale=1,
        frontend=FrontendConfig(
            max_features=4096, num_octaves=4, upsample_input=True,
            contrast_threshold=0.012, lowe_ratio=0.75,
        ),
        ransac=RansacConfig(essential_iters=2048, pnp_iters=1024),
        ba=BaConfig(enabled=True, cadence=1, max_iterations=8),
        map=MapConfig(max_cameras=64, max_points=16384),
        sweep=SweepConfig(
            enabled=True, grow_points=65536, reproj_px=1.5, max_features=4096,
            contrast_threshold=0.0025, pair_strides=(1, 2),
        ),
    )


def render(n_frames=N_FRAMES, image_size=IMAGE_SIZE):
    from sfm_mvs_tpu.utils.synthetic import render_staircase_sequence

    t0 = time.time()
    imgs, Rt_gt, _, gt_depth = render_staircase_sequence(
        num_cameras=n_frames, image_size=image_size,
        focal=1200.0 * image_size[0] / 968.0, radius=9.0, arc_degrees=50.0,
        num_strips=10, depth_spread=2.0, return_depth=True,
    )
    print(f"[b] rendered {n_frames} frames {image_size[0]}x{image_size[1]} "
          f"in {time.time() - t0:.1f}s")
    # 8-bit levels, as the CLI's decoded images and bench.py's frames have;
    # the sweep adds about twice as many points on them as on float frames.
    grays = [(np.asarray(g) * 255.0).astype(np.uint8).astype(np.float32) / 255.0
             for g in imgs]
    return grays, Rt_gt, gt_depth


def main_path_phase(cfg, grays, Rt_gt):
    """IncrementalSfM.run + finalize(). Returns (sfm, state, metrics)."""
    from sfm_mvs_tpu.models.incremental import IncrementalSfM
    from sfm_mvs_tpu.utils import evaluate

    sfm = IncrementalSfM(cfg)
    t0 = time.time()
    sfm.run(grays, seed=0)
    run_wall = time.time() - t0
    steady = [s["wall_s"] for s in sfm.stats if s["frame"] >= 3]
    t0 = time.time()
    state = sfm.finalize()
    finalize_wall = time.time() - t0
    n_cams = int(np.asarray(state.cam_valid).sum())
    poses = np.asarray(state.poses)[np.asarray(state.cam_valid)]
    info = sfm.finalize_info
    m = {
        "cameras": n_cams,
        "ate": evaluate.ate_rmse(poses, Rt_gt[:n_cams]) if n_cams == len(grays) else float("nan"),
        "rms_px": float(np.sqrt(info["final_cost"])),
        "points": int(info["points"]),
        "swept_points": int(info["swept_points"]),
        "compile_plus_bootstrap_s": run_wall - sum(steady),
        "frame_wall_median_s": float(np.median(steady)),
        "frame_wall_max_s": float(np.max(steady)),
        "finalize_s": finalize_wall,
    }
    print(
        f"[b] main path: {n_cams}/{len(grays)} cameras, ATE {m['ate']:.5f}, "
        f"final BA RMS {m['rms_px']:.4f} px, {m['points']} points "
        f"({m['swept_points']} swept); compile+bootstrap "
        f"{m['compile_plus_bootstrap_s']:.1f} s, steady per-frame wall median "
        f"{1e3 * m['frame_wall_median_s']:.1f} ms (max "
        f"{1e3 * m['frame_wall_max_s']:.1f} ms) over {len(steady)} frames, "
        f"finalize+sweep {finalize_wall:.1f} s (compile included)"
    )
    return sfm, state, m


def check_main_path(m, n_frames=N_FRAMES):
    failed = []
    if m["cameras"] != n_frames:
        failed.append(f"{m['cameras']}/{n_frames} cameras")
    if not m["ate"] < 0.01:
        failed.append(f"ATE {m['ate']}")
    if not m["rms_px"] < 1.0:
        failed.append(f"final BA RMS {m['rms_px']} px")
    if m["swept_points"] < MIN_SWEPT:
        failed.append(f"{m['swept_points']} points added by the sweep")
    if failed:
        raise SystemExit("chip_smoke: main path failed: " + "; ".join(failed))


def mvs_phase(state, grays, Rt_gt, gt_depth, max_refs=MVS_REFS):
    from sfm_mvs_tpu.models import mvs
    from sfm_mvs_tpu.utils import evaluate

    t0 = time.time()
    pts, _, dms = mvs.densify_map(
        grays, state, num_depths=64, stride=2, max_refs=max_refs,
        return_depth_maps=True, min_conf=0.5,
    )
    wall = time.time() - t0
    n = int(state.num_cams)
    s_align, _, _ = evaluate.umeyama_alignment(
        evaluate.camera_centers(np.asarray(state.poses)[:n]),
        evaluate.camera_centers(Rt_gt[:n]),
    )
    rels = []
    for r, dm in dms.items():
        d_gt = gt_depth[r]
        ok = np.asarray(dm.valid) & (d_gt > 0.1)
        rels.append(np.abs(np.asarray(dm.depth)[ok] * s_align - d_gt[ok]) / d_gt[ok])
    rel = np.concatenate(rels) if rels else np.zeros(0)
    med = float(np.median(rel)) if rel.size else float("nan")
    print(f"[c] MVS: {len(pts)} dense points from {len(dms)} reference frames, "
          f"median relative depth error {med:.5f} over {rel.size} pixels, "
          f"{wall:.1f} s (compile included)")
    if len(pts) == 0:
        raise SystemExit("chip_smoke: MVS returned an empty cloud")
    return med


def reference_match(d0, d1, v0, v1, ratio):
    """float64 brute-force 2-NN + ratio test: (idx1, valid, margin)."""
    a = np.asarray(d0, np.float64)
    b = np.asarray(d1, np.float64)
    d2 = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * a @ b.T
    d2 = np.where(np.asarray(v1)[None, :], np.maximum(d2, 0.0), np.inf)
    rows = np.arange(len(a))
    j1 = np.argmin(d2, axis=1)  # lowest column on ties
    best = d2[rows, j1]
    d2[rows, j1] = np.inf
    second = d2.min(axis=1)
    r2 = ratio * ratio
    valid = np.asarray(v0) & np.isfinite(best) & (best < r2 * second)
    with np.errstate(invalid="ignore", divide="ignore"):
        margin = np.abs(best - r2 * second) / second
    return j1, valid, margin


def matcher_phase(cfg, grays, reps=20):
    import jax
    import jax.numpy as jnp

    from sfm_mvs_tpu.ops import matching, sift

    f0, f1 = (sift.detect_and_compute(jnp.asarray(grays[i]), cfg.frontend)
              for i in MATCH_FRAMES)
    args = (f0.desc, f1.desc, f0.valid, f1.valid)
    match = jax.jit(lambda *a: matching.match_with_config(*a, cfg.frontend))
    m = jax.block_until_ready(match(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(match(*args))
        times.append(time.perf_counter() - t0)
    idx_ref, valid_ref, margin = reference_match(*args, cfg.frontend.lowe_ratio)
    valid = np.asarray(m.valid)
    idx = np.asarray(m.idx1)
    agree = float(np.mean(valid == valid_ref))
    sure = valid & valid_ref & (margin > 1e-5)
    idx_bad = int(np.sum(idx[sure] != idx_ref[sure]))
    print(f"[d] matcher {f0.desc.shape[0]}x{f1.desc.shape[0]}x{f0.desc.shape[1]}: "
          f"{int(valid.sum())} matches (reference {int(valid_ref.sum())}), "
          f"valid agreement {agree:.5f}, idx1 mismatches on {int(sure.sum())} "
          f"clear queries: {idx_bad}; median {1e3 * np.median(times):.3f} ms "
          f"over {reps} runs")
    if agree < 0.999 or idx_bad:
        raise SystemExit("chip_smoke: matcher disagrees with the float64 reference")


def multi_card_phase(devices, cards):
    from __graft_entry__ import _bench_like_config, _dryrun_scale
    from sfm_mvs_tpu.parallel import mesh as meshlib

    mesh = meshlib.make_mesh((cards,), ("data",), devices=devices[:cards])
    t0 = time.time()
    points = _dryrun_scale(
        mesh, _bench_like_config(), n_frames=16, image_size=(480, 360),
        focal=600.0, arc_degrees=40.0, label="bench-like",
    )
    print(f"[4] sharded flow: {time.time() - t0:.1f} s (compile included)")
    shards = points.addressable_shards
    for s in shards:
        print(f"[4] sharded BA point block {s.index} on {s.device}")
    if len({s.device.id for s in shards}) != cards:
        raise SystemExit("chip_smoke: sharded BA's point blocks not spread "
                         f"over {cards} distinct devices")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cards", type=int, choices=(1, 4), default=1,
                   help="4: run only the sharded flow over four cards")
    args = p.parse_args(argv)
    devices = device_phase(args.cards)
    if args.cards > 1:
        multi_card_phase(devices, args.cards)
    else:
        cfg = smoke_config()
        grays, Rt_gt, gt_depth = render()
        _, state, m = main_path_phase(cfg, grays, Rt_gt)
        check_main_path(m)
        mvs_phase(state, grays, Rt_gt, gt_depth)
        matcher_phase(cfg, grays)
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
