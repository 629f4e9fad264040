"""Worker for the contention-free END-TO-END multi-process scaling bench.

Launched by benchmarks/e2e_multiproc.py as
    taskset -c <core> python benchmarks/_e2e_worker.py \
        <pid> <nprocs> <coordinator> <frames> <W> <H>

One CPU device per process, disjoint physical cores (parent pins). The
FULL pipeline runs distributed:

  - detection: the frame batch shards over the process mesh
    (frontend.detect_batch_sharded) — the embarrassingly parallel axis;
  - registration (match + PnP-RANSAC + triangulation): replicated SPMD
    (sequential by nature; every process computes the same update);
  - per-frame windowed BA: point-axis-sharded shard_map solve
    (distributed_ba.bundle_adjust_window_sharded).

Process 0 prints one JSON line with phase walls and frames/s.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 1)


def main() -> int:
    pid, nprocs, addr = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    n_frames, W, H = int(sys.argv[4]), int(sys.argv[5]), int(sys.argv[6])

    import numpy as np

    from sfm_mvs_tpu.parallel import multihost

    if nprocs > 1:
        ok = multihost.initialize(addr, nprocs, pid)
        assert ok and jax.process_count() == nprocs

    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as Pp

    from sfm_mvs_tpu.models import map_store
    from sfm_mvs_tpu.models.incremental import init_from_bootstrap, register_frame
    from sfm_mvs_tpu.parallel import distributed_ba, frontend
    from sfm_mvs_tpu.utils import evaluate
    from sfm_mvs_tpu.utils.config import (
        FrontendConfig, MapConfig, RansacConfig, SfmConfig,
    )
    from sfm_mvs_tpu.utils.synthetic import render_staircase_sequence

    devices = jax.devices()
    assert len(devices) == nprocs
    mesh = Mesh(np.asarray(devices).reshape(nprocs), ("data",))

    focal = 600.0 * W / 480.0
    imgs, Rt_gt, K = render_staircase_sequence(
        num_cameras=n_frames, image_size=(W, H), focal=focal,
        radius=9.0, arc_degrees=0.6 * n_frames, num_strips=10,
        depth_spread=2.0,
    )
    cfg = SfmConfig(
        fx=focal, fy=focal, cx=W / 2.0, cy=H / 2.0, downscale=1,
        frontend=FrontendConfig(
            max_features=1024, num_octaves=4, upsample_input=False,
            contrast_threshold=0.008, lowe_ratio=0.75,
        ),
        ransac=RansacConfig(essential_iters=512, pnp_iters=512),
        map=MapConfig(max_cameras=64, max_points=16384),
    )
    Kj = jnp.asarray(cfg.intrinsic_matrix())

    def rep(x):
        xn = np.asarray(x)
        sh = NamedSharding(mesh, Pp())
        return jax.make_array_from_callback(xn.shape, sh, lambda i: xn[i])

    pad = (-n_frames) % nprocs
    batch_host = np.stack(
        [np.asarray(g, np.float32) for g in imgs]
        + [np.asarray(imgs[-1], np.float32)] * pad
    )
    sh_data = NamedSharding(mesh, Pp("data"))
    batch = jax.make_array_from_callback(
        batch_host.shape, sh_data, lambda i: batch_host[i]
    )
    bgr_host = np.repeat(batch_host[..., None] * 255.0, 3, axis=-1)
    bgr_all = jax.make_array_from_callback(
        bgr_host.shape, NamedSharding(mesh, Pp()), lambda i: bgr_host[i]
    )

    def frame_ba(state):
        # Per-frame GLOBAL BA over the full (16384, 64) grid — the
        # canonical bench recipe (bench.py) and the distributed-BA
        # regime the design targets: enough per-iteration compute that
        # the psum'd camera system is a small fraction (the first cut
        # used an (8192, 16) window whose per-iteration work was smaller
        # than the collective+reshard overhead: 0.495 efficiency).
        state, stats = distributed_ba.bundle_adjust_map_sharded(
            state, mesh, max_iterations=4, cg_iters=12,
        )
        return state, stats

    def run_pipeline():
        """One full pass: sharded detect -> register+distributed-BA loop."""
        t0 = time.time()
        fb = frontend.detect_batch_sharded(batch, cfg.frontend, mesh)
        # Replicate the feature batch once (one all-gather) so the
        # sequential registration loop reads it locally.
        fb = jax.device_put(fb, NamedSharding(mesh, Pp()))
        jax.block_until_ready(fb.xy)
        t_detect = time.time() - t0

        feats = [
            jax.tree_util.tree_map(lambda a: a[i], fb)
            for i in range(n_frames)
        ]
        t0 = time.time()
        key = jax.random.PRNGKey(0)
        keys = jax.random.split(key, n_frames)
        pstate, _ = init_from_bootstrap(
            keys[0], feats[0], feats[1], bgr_all[1], Kj, cfg
        )
        t_reg = 0.0
        t_ba = 0.0
        stats = None
        for i in range(2, n_frames):
            ti = time.time()
            pstate, st = register_frame(
                keys[i], pstate, feats[i], bgr_all[i], cfg
            )
            jax.block_until_ready(pstate.map.points)
            t_reg += time.time() - ti
            ti = time.time()
            mstate, stats = frame_ba(pstate.map)
            pstate = pstate._replace(map=mstate)
            jax.block_until_ready(pstate.map.points)
            t_ba += time.time() - ti
        total = t_detect + (time.time() - t0)
        return pstate, stats, total, t_detect, t_reg, t_ba

    # Warmup pass compiles everything; the second pass is the timed one.
    run_pipeline()
    pstate, stats, total, t_detect, t_reg, t_ba = run_pipeline()

    state = pstate.map
    n_cams = int(np.asarray(state.cam_valid).sum())
    poses = np.asarray(state.poses)[np.asarray(state.cam_valid)]
    ate = (
        evaluate.ate_rmse(poses, Rt_gt[:n_cams])
        if n_cams == n_frames else float("nan")
    )
    if pid == 0:
        print(json.dumps({
            "nprocs": nprocs,
            "frames": n_frames,
            "total_s": round(total, 3),
            "frames_per_s": round(n_frames / total, 4),
            "detect_s": round(t_detect, 3),
            "register_s": round(t_reg, 3),
            "ba_s": round(t_ba, 3),
            "cameras": n_cams,
            "final_ba_cost": float(stats.final_cost),
            "ate": round(float(ate), 5),
            "points": int(np.asarray(state.point_valid).sum()),
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
