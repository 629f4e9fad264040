"""Per-kernel microbenchmarks at bench shapes.

Times each hot kernel and prints a JSON line per kernel (wall ms +
achieved GFLOP/s or GB/s where meaningful). Run on the GPU:

    python benchmarks/kernels.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json
import sys
import time

import numpy as np


def timeit(fn, iters=20):
    """fn(i) -> output; varies its computation with i, so no two timed
    dispatches are identical."""
    import jax

    jax.block_until_ready(fn(0))
    t0 = time.time()
    keep = [fn(1 + i) for i in range(iters)]
    jax.block_until_ready(keep)
    return (time.time() - t0) / iters


def main():
    import jax
    import jax.numpy as jnp

    from sfm_mvs_tpu.models import ba, map_store
    from sfm_mvs_tpu.ops import matching, ransac, sift, triangulation, projection
    from sfm_mvs_tpu.utils import cache
    from sfm_mvs_tpu.utils.config import FrontendConfig, MapConfig
    from sfm_mvs_tpu.utils.synthetic import make_scene, render_staircase_sequence

    cache.enable()
    rng = np.random.default_rng(0)
    out = []

    def emit(name, seconds, flops=None, bytes_=None, note=""):
        rec = {"kernel": name, "ms": round(seconds * 1e3, 3)}
        if flops:
            rec["gflops"] = round(flops / seconds / 1e9, 1)
        if bytes_:
            rec["gbps"] = round(bytes_ / seconds / 1e9, 1)
        if note:
            rec["note"] = note
        out.append(rec)
        print(json.dumps(rec), file=sys.stderr)

    # --- KNN matching (4096 x 4096 x 128) ---
    d0 = jnp.asarray(rng.random((4096, 128), dtype=np.float64).astype(np.float32))
    d1 = jnp.asarray(rng.random((4096, 128), dtype=np.float64).astype(np.float32))
    v = jnp.ones(4096, dtype=bool)
    fl = 2 * 4096 * 4096 * 128
    emit("knn_match_xla",
         timeit(lambda i: matching.knn_match(d0 + 1e-4 * i, d1, v, v)), flops=fl)

    # --- SIFT detect at bench resolution ---
    imgs, _, K = render_staircase_sequence(
        num_cameras=1, image_size=(968, 648), focal=1200.0
    )
    img = jnp.asarray(imgs[0])
    cfg = FrontendConfig(
        max_features=4096, num_octaves=4, upsample_input=True,
        contrast_threshold=0.012,
    )
    emit(
        "sift_detect_968x648",
        timeit(lambda i: sift.detect_and_compute(img + 1e-5 * i, cfg), iters=5),
        note="4 octaves, upsampled, 4096 features",
    )

    # --- Triangulation (8192 correspondences) ---
    scene = make_scene(num_points=8192, num_cameras=2)
    uv0, _ = scene.project(0)
    uv1, _ = scene.project(1)
    P0 = jnp.asarray(scene.K @ scene.Rt[0])
    P1 = jnp.asarray(scene.K @ scene.Rt[1])
    u0 = jnp.asarray(uv0.astype(np.float32))
    u1 = jnp.asarray(uv1.astype(np.float32))
    tri = jax.jit(triangulation.triangulate_euclidean)
    emit("triangulate_8192", timeit(lambda i: tri(P0, P1, u0 + 1e-5 * i, u1)))

    # --- E-RANSAC (2048 hypotheses x 4096 correspondences) ---
    Kj = jnp.asarray(scene.K)
    n0 = projection.normalize_points(u0[:4096], Kj)
    n1 = projection.normalize_points(u1[:4096], Kj)
    mask = jnp.ones(4096, dtype=bool)
    key = jax.random.PRNGKey(0)
    emit(
        "ransac_essential_2048x4096",
        timeit(
            lambda i: ransac.ransac_essential(
                jax.random.PRNGKey(i), n0, n1, mask, Kj[0, 0], iters=2048),
            iters=5,
        ),
    )

    # --- BA LM iteration rate (the reference's ~30s/frame counterpart) ---
    scene = make_scene(num_points=20000, num_cameras=50, arc_degrees=50)
    mc = MapConfig(max_cameras=64, max_points=32768)
    state = map_store.init_map(jnp.asarray(scene.K), mc)
    for c in range(50):
        state, _ = map_store.append_camera(state, jnp.asarray(scene.Rt[c]))
    Xn = scene.points + rng.normal(scale=0.03, size=scene.points.shape).astype(
        np.float32
    )
    state, pids = map_store.append_points(
        state, jnp.asarray(Xn), jnp.zeros((20000, 3)), jnp.ones(20000, dtype=bool)
    )
    for c in range(0, 50, 5):
        uv, _ = scene.project(c)
        state = map_store.append_observations(
            state, c, pids, jnp.asarray(uv.astype(np.float32)),
            jnp.ones(20000, dtype=bool),
        )
    t = timeit(
        lambda i: ba.bundle_adjust_map(
            state._replace(points=state.points + 1e-6 * i),
            max_iterations=8, cg_iters=15)[1].final_cost,
        iters=5,
    )
    emit(
        "ba_8lm_200k_obs", t,
        note=f"LM iters/s = {8 / t:.1f} (reference: dense TRF ~30s/frame)",
    )

    # --- Plane-sweep MVS at config-4 scale (480x360, 64 depths, 2 nbrs) ---
    from sfm_mvs_tpu.models import mvs

    imgs, Rt, Km = render_staircase_sequence(
        num_cameras=3, arc_degrees=10, image_size=(480, 360), focal=600.0
    )
    ref = jnp.asarray(imgs[1])
    nbrs = jnp.stack([jnp.asarray(imgs[0]), jnp.asarray(imgs[2])])
    t = timeit(
        lambda i: mvs.plane_sweep_depth(
            ref + 1e-5 * i, nbrs, jnp.asarray(Rt[1]), jnp.asarray(Rt[[0, 2]]),
            jnp.asarray(Km), jnp.asarray(5.0), jnp.asarray(12.0),
            num_depths=64,
        ).depth,
        iters=5,
    )
    emit(
        "plane_sweep_480x360_64d_2n", t,
        note=f"{480 * 360 * 64 * 2 / t / 1e9:.2f} Gsamples/s warp+cost",
    )

    print(json.dumps({"kernels": out}))


if __name__ == "__main__":
    main()
