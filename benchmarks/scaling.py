"""Multi-device scaling harness: front end + distributed BA.

Measures data-parallel front-end throughput and distributed-BA wall time
at 1, 2, 4, ... N devices on whatever platform is present, reporting
scaling efficiency (the BASELINE.md north-star asks for >=70% frames/s
efficiency at 2+ hosts). On virtual CPU devices the numbers only validate
the sharding machinery; run unchanged on several GPUs for true efficiency.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python benchmarks/scaling.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from sfm_mvs_tpu.models import map_store
    from sfm_mvs_tpu.parallel import distributed_ba, frontend, mesh as meshlib
    from sfm_mvs_tpu.utils import cache
    from sfm_mvs_tpu.utils.config import FrontendConfig, MapConfig
    from sfm_mvs_tpu.utils.synthetic import make_scene, render_staircase_sequence

    cache.enable()
    devices = jax.devices()
    n_dev = len(devices)
    sizes = [s for s in [1, 2, 4, 8, 16, 32] if s <= n_dev]
    print(f"platform={devices[0].platform} devices={n_dev}", file=sys.stderr)

    results = {"platform": devices[0].platform, "num_devices": n_dev}
    if devices[0].platform == "cpu":
        # Virtual CPU devices share the host's physical cores (they exist
        # to validate sharding semantics, not to add compute), so measured
        # "efficiency" here is a lower bound that mostly reflects XLA-CPU
        # thread-pool contention — NOT hardware scaling. On a real slice
        # each mesh step adds actual chips.
        results["note"] = (
            "virtual CPU mesh: devices share physical cores; efficiency "
            "validates machinery, not hardware scaling"
        )

    # --- Data-parallel front end: fixed per-device batch (weak scaling). ---
    cfg = FrontendConfig(
        max_features=1024, num_octaves=3, upsample_input=False,
        contrast_threshold=0.015,
    )
    imgs, _, _ = render_staircase_sequence(num_cameras=8, image_size=(320, 240))
    fe = []
    for s in sizes:
        mesh = meshlib.make_mesh((s,), ("data",), devices=devices[:s])
        batch = jnp.asarray(np.stack([imgs[i % 8] for i in range(s)]))
        f = frontend.detect_batch_sharded(batch, cfg, mesh)  # compile
        jax.block_until_ready(f.desc)
        t0 = time.time()
        for _ in range(5):
            f = frontend.detect_batch_sharded(batch, cfg, mesh)
        jax.block_until_ready(f.desc)
        dt = (time.time() - t0) / 5
        fe.append({"devices": s, "images_per_s": round(s / dt, 2)})
        print(f"frontend x{s}: {s/dt:.2f} img/s", file=sys.stderr)
    if len(fe) > 1:
        eff = fe[-1]["images_per_s"] / (fe[0]["images_per_s"] * fe[-1]["devices"])
        results["frontend_weak_scaling_efficiency"] = round(eff, 3)
    results["frontend"] = fe

    # --- Distributed BA: fixed problem (strong scaling). ---
    rng = np.random.default_rng(0)
    scene = make_scene(num_points=16000, num_cameras=32, arc_degrees=50)
    mc = MapConfig(max_cameras=32, max_points=32768)
    state = map_store.init_map(jnp.asarray(scene.K), mc)
    for c in range(32):
        state, _ = map_store.append_camera(state, jnp.asarray(scene.Rt[c]))
    Xn = scene.points + rng.normal(scale=0.03, size=scene.points.shape).astype(
        np.float32
    )
    state, pids = map_store.append_points(
        state, jnp.asarray(Xn), jnp.zeros((16000, 3)), jnp.ones(16000, dtype=bool)
    )
    for c in range(0, 32, 4):
        uv, _ = scene.project(c)
        state = map_store.append_observations(
            state, c, pids, jnp.asarray(uv.astype(np.float32)),
            jnp.ones(16000, dtype=bool),
        )
    bas = []
    for s in sizes:
        mesh = meshlib.make_mesh((s,), ("data",), devices=devices[:s])
        _, st = distributed_ba.bundle_adjust_map_sharded(
            state, mesh, max_iterations=6, cg_iters=12
        )
        jax.block_until_ready(st.final_cost)
        t0 = time.time()
        for _ in range(3):
            _, st = distributed_ba.bundle_adjust_map_sharded(
                state, mesh, max_iterations=6, cg_iters=12
            )
        jax.block_until_ready(st.final_cost)
        dt = (time.time() - t0) / 3
        bas.append({"devices": s, "ba_wall_s": round(dt, 4)})
        print(f"dist-BA x{s}: {dt*1e3:.1f} ms", file=sys.stderr)
    if len(bas) > 1:
        speedup = bas[0]["ba_wall_s"] / bas[-1]["ba_wall_s"]
        results["ba_strong_scaling_speedup"] = round(speedup, 2)
        results["ba_strong_scaling_efficiency"] = round(
            speedup / bas[-1]["devices"], 3
        )
    results["distributed_ba"] = bas

    # --- Communication isolation (the >=70%-at-2-hosts basis). ---
    # Per LM iteration at (P=131072, C=64): each device's LOCAL work is the
    # dense Schur elimination over its point shard; the ONLY communicated
    # state is the reduced camera system. Two measurements separate them:
    #   t_sharded(s): per-LM-iter wall of the sharded solve on s devices;
    #   t_local(P/s): per-LM-iter wall of the UNSHARDED solve on ONE device
    #                 holding a P/s-point problem (a device's local share,
    #                 zero collectives).
    # comm+contention share = 1 - t_local(P/s)/t_sharded(s). On a virtual
    # CPU mesh the devices share physical cores, so t_sharded also absorbs
    # compute contention — the share reported here is an UPPER bound on
    # communication. The analytic psum payload is reported alongside: at
    # C=64, cg_iters=12 it is ~50 KB per LM iteration against ~100 MB of
    # local grid traffic per device — a 1:2000 ratio, which is why the
    # design scales until the reduced camera system stops fitting.
    from sfm_mvs_tpu.models import ba as ba_mod

    P_BIG = int(os.environ.get("SCALING_P", "131072"))
    C_BIG = 64
    CGI = 12
    LM_IT = int(os.environ.get("SCALING_LM_ITERS", "4"))
    rng = np.random.default_rng(1)
    scene_b = make_scene(num_points=4096, num_cameras=C_BIG, arc_degrees=70)
    mcb = MapConfig(max_cameras=C_BIG, max_points=P_BIG)
    stb = map_store.init_map(jnp.asarray(scene_b.K), mcb)
    for c in range(C_BIG):
        stb, _ = map_store.append_camera(stb, jnp.asarray(scene_b.Rt[c]))
    # Tile the 4096 ground-truth points to fill P_BIG slots (the dense-grid
    # cost depends on CAPACITY, not on content).
    reps = P_BIG // 4096
    Xb = np.tile(scene_b.points, (reps, 1)) + rng.normal(
        scale=0.03, size=(P_BIG, 3)
    ).astype(np.float32)
    stb, pb = map_store.append_points(
        stb, jnp.asarray(Xb), jnp.zeros((P_BIG, 3)), jnp.ones(P_BIG, dtype=bool)
    )
    for c in range(0, C_BIG, 8):
        uv, _ = scene_b.project(c)
        stb = map_store.append_observations(
            stb, c, pb, jnp.asarray(np.tile(uv, (reps, 1)).astype(np.float32)),
            jnp.ones(P_BIG, dtype=bool),
        )
    prob_big = ba_mod.problem_from_map(stb)

    def time_lm(fn, *a, reps_t=2, **kw):
        out = fn(*a, **kw)  # compile
        jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
        t0 = time.time()
        for _ in range(reps_t):
            out = fn(*a, **kw)
        jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
        return (time.time() - t0) / (reps_t * LM_IT)

    comm = []
    for s in sizes:
        mesh = meshlib.make_mesh((s,), ("data",), devices=devices[:s])
        t_shard = time_lm(
            distributed_ba.run_ba_sharded, prob_big, mesh,
            max_iterations=LM_IT, cg_iters=CGI,
        )
        # A device's local share, unsharded (no collectives at all).
        sl = slice(0, P_BIG // s)
        prob_loc = prob_big._replace(
            points=prob_big.points[sl],
            point_valid=prob_big.point_valid[sl],
            obs_uv=prob_big.obs_uv[sl],
            obs_mask=prob_big.obs_mask[sl],
        )
        t_loc = time_lm(
            ba_mod.run_ba, prob_loc, max_iterations=LM_IT, cg_iters=CGI
        )
        comm.append(
            {
                "devices": s,
                "lm_iter_sharded_ms": round(t_shard * 1e3, 2),
                "lm_iter_local_share_ms": round(t_loc * 1e3, 2),
                "comm_plus_contention_share": round(
                    max(0.0, 1.0 - t_loc / t_shard), 3
                ),
            }
        )
        print(f"comm-isolation x{s}: sharded {t_shard*1e3:.1f} ms/LM-iter, "
              f"local share {t_loc*1e3:.1f} ms", file=sys.stderr)
    # Analytic psum payload per LM iteration (f32 bytes): U (C,6,6) +
    # g_c (C,6) + cam_active (C,) + Schur rhs (C,6) + cost num/den x2, and
    # per CG step one (C,6) back-reduction.
    psum_bytes = 4 * (
        C_BIG * 36 + C_BIG * 6 + C_BIG + C_BIG * 6 + 4 + CGI * C_BIG * 6
    )
    grid_bytes_per_dev = prob_big.obs_uv.nbytes // max(sizes)
    results["comm_isolation"] = {
        "P": P_BIG,
        "C": C_BIG,
        "cg_iters": CGI,
        "rows": comm,
        "analytic_psum_bytes_per_lm_iter": int(psum_bytes),
        "local_grid_bytes_per_device": int(grid_bytes_per_dev),
        "note": (
            "comm_plus_contention_share is an UPPER bound on communication "
            "(virtual CPU devices share cores, so sharded runs also absorb "
            "compute contention); the analytic psum payload is the true "
            "communicated volume per LM iteration"
        ),
    }

    print(json.dumps(results))


if __name__ == "__main__":
    main()
