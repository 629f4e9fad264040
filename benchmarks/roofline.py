"""Per-kernel roofline on the device.

For each hot kernel: chained-dispatch timing, an ANALYTIC work model
(FLOPs and algorithmic-minimum device-memory bytes), and the achieved
fraction of the device's published peak (utils/profiling.PEAKS, keyed by
`device_kind`; an unknown device stops the script) on whichever axis
binds. Gather-bound kernels are also scored against an element-gather
rate calibrated at the top of main(), because random gathers saturate far
below nominal memory bandwidth.

    python benchmarks/roofline.py

Writes artifacts/ROOFLINE.json.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import numpy as np

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "artifacts")

# Element-gather speed of light: calibrated by a dedicated microbench at
# the top of main().
GATHER_NEAREST_PER_S = 0.0
GATHER_BILINEAR_PER_S = 0.0


def timeit(fn, arglists, reps=10):
    """Chained timing (see benchmarks/detect_breakdown.timeit)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def step(carry, args):
        dep = jnp.where(jnp.isnan(carry), 1, 0)

        def leaf(a):
            if hasattr(a, "dtype") and a.dtype != jnp.bool_:
                return a + dep.astype(a.dtype)
            return a

        out = fn(*jax.tree_util.tree_map(leaf, args))
        leaves = [l for l in jax.tree_util.tree_leaves(out) if hasattr(l, "dtype")]
        s = jnp.float32(0.0)
        for l in leaves[:3]:
            la = jnp.atleast_1d(l)
            s = s + jnp.sum(la[..., :1].astype(jnp.float32))
        # Accumulate the carry: without this, carries CYCLE with the
        # arglist period and reps become bitwise-identical dispatches.
        return carry * 0.5 + s * 1e-12

    carry = step(jnp.float32(0.0), arglists[0])
    import jax as _j

    _j.block_until_ready(carry)
    t0 = time.time()
    for i in range(reps):
        carry = step(carry, arglists[i % len(arglists)])
    _j.block_until_ready(carry)
    return (time.time() - t0) / reps


def timeit_amortized(step_fn, arglists, chain_iters=16, reps=8):
    """Per-iteration kernel time with dispatch overhead SUBTRACTED.

    The single-dispatch chained `timeit` carries the per-rep dispatch
    overhead, which for sub-millisecond kernels is the measurement. Here
    `step_fn`
    (carry, args) -> (carry, aux) is chained INSIDE one jit program via
    lax.scan for `chain_iters` iterations (carry keeps every iteration
    data-dependent and value-distinct); the 1-iteration program's time is
    subtracted, so per-iteration = (t_K - t_1) / (K - 1) is pure kernel.
    """
    import jax
    import jax.numpy as jnp

    def make(K):
        @jax.jit
        def prog(*args):
            def body(carry, i):
                c2, aux = step_fn(carry + i.astype(jnp.float32) * 0.0, args, i)
                return c2, aux
            return jax.lax.scan(body, jnp.float32(0.0), jnp.arange(K))
        return prog

    t1 = timeit(make(1), arglists, reps=reps)
    tK = timeit(make(chain_iters), arglists, reps=reps)
    return max((tK - t1) / (chain_iters - 1), 1e-9)


def main():
    import jax
    import jax.numpy as jnp
    from functools import partial

    from sfm_mvs_tpu.models import ba, map_store, mvs
    from sfm_mvs_tpu.ops import matching, pyramid, sift
    from sfm_mvs_tpu.utils import cache
    from sfm_mvs_tpu.utils.config import FrontendConfig, MapConfig
    from sfm_mvs_tpu.utils.profiling import PEAKS
    from sfm_mvs_tpu.utils.synthetic import make_scene, render_staircase_sequence

    cache.enable()
    kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise SystemExit(f"no peak rates for device kind {kind!r} (utils/profiling.PEAKS)")
    peak = PEAKS[kind]
    rows = []

    # --- Calibrate the gather ceiling: pure element gathers, chained. ---
    global GATHER_NEAREST_PER_S, GATHER_BILINEAR_PER_S
    rngc = np.random.default_rng(7)
    src = jnp.asarray(rngc.standard_normal(1 << 20), jnp.float32)
    idx = jnp.asarray(rngc.integers(0, 1 << 20, 4 << 20), jnp.int32)
    xy = jnp.asarray(rngc.uniform(1, 1022, (4 << 20, 2)), jnp.float32)
    img2d = jnp.asarray(rngc.standard_normal((1024, 1024)), jnp.float32)

    def pure_gather(s, ix):
        return jnp.sum(s[ix])

    def pure_bilinear(im, p):
        x, y = p[:, 0], p[:, 1]
        x0 = jnp.floor(x).astype(jnp.int32)
        y0 = jnp.floor(y).astype(jnp.int32)
        fx, fy = x - x0, y - y0
        fl = im.reshape(-1)
        at = lambda yy, xx: fl[yy * 1024 + xx]
        v = (at(y0, x0) * (1 - fy) * (1 - fx) + at(y0, x0 + 1) * (1 - fy) * fx
             + at(y0 + 1, x0) * fy * (1 - fx) + at(y0 + 1, x0 + 1) * fy * fx)
        return jnp.sum(v)

    t_n = timeit(pure_gather, [(src + 1e-6 * i, idx) for i in range(4)])
    t_b = timeit(pure_bilinear, [(img2d + 1e-6 * i, xy) for i in range(4)])
    GATHER_NEAREST_PER_S = (4 << 20) / t_n
    GATHER_BILINEAR_PER_S = (4 << 20) / t_b
    rows.append({
        "kernel": "calibration_gather_ceiling",
        "nearest_taps_per_s_M": round(GATHER_NEAREST_PER_S / 1e6, 1),
        "bilinear_samples_per_s_M": round(GATHER_BILINEAR_PER_S / 1e6, 1),
        "note": ("4M random element gathers from a 4MB table, chained — "
                 "a SMALL-TABLE upper bound (the table stays in cache)"),
    })
    print(json.dumps(rows[-1]), file=sys.stderr)

    def add(name, seconds, flops=0.0, bytes_=0.0, gathers=0.0,
            gather_kind="nearest", note=""):
        row = {"kernel": name, "ms": round(seconds * 1e3, 3)}
        fracs = {}
        if flops:
            tf = flops / seconds / 1e12
            row["achieved_f32_tflops"] = round(tf, 3)
            fracs["f32"] = tf / peak["f32_tflops"]
        if bytes_:
            gb = bytes_ / seconds / 1e9
            row["achieved_gbps"] = round(gb, 1)
            fracs["hbm"] = gb / peak["hbm_gbps"]
        if gathers:
            sol = (GATHER_NEAREST_PER_S if gather_kind == "nearest"
                   else GATHER_BILINEAR_PER_S)
            rate = gathers / seconds
            row["achieved_gather_samples_per_s_M"] = round(rate / 1e6, 1)
            fracs["gather_small_table_ceiling"] = rate / sol
        if fracs:
            bind = max(fracs, key=fracs.get)
            row["binding_axis"] = bind
            row["fraction_of_peak"] = round(fracs[bind], 4)
            row["fractions"] = {k: round(v, 4) for k, v in fracs.items()}
        if note:
            row["note"] = note
        rows.append(row)
        print(json.dumps(row), file=sys.stderr)

    # ---------------- 2-NN matcher (4096 x 4096 x 128) -------------------
    rng = np.random.default_rng(0)
    d0 = jnp.asarray(rng.standard_normal((4096, 128)), jnp.float32)
    d1 = jnp.asarray(rng.standard_normal((4096, 128)), jnp.float32)
    v = jnp.ones((4096,), bool)

    def match_step(carry, args, i):
        a, b = args
        m = matching.knn_match(a + carry, b, v, v, ratio=0.75)
        c2 = jnp.sum(m.idx1[:1]).astype(jnp.float32) * 0.0 + (
            i + 1
        ).astype(jnp.float32) * 1e-6
        return c2, m.valid[0]

    t = timeit_amortized(
        match_step, [(d0 + 1e-4 * i, d1) for i in range(6)]
    )
    N = 4096
    add(
        "matching_xla_2nn_4096", t,
        flops=2.0 * N * N * 128,
        bytes_=4.0 * (N * 128 * 2 + 3 * N * N),
        note=("XLA distance matmul at highest precision + argmin + masked "
              "min; AMORTIZED in-program timing. FLOP count is the "
              "distance matmul; bytes count writing the (N,N) distance "
              "matrix once and reading it twice"),
    )

    # ---------------- Detect stages at bench resolution ------------------
    imgs, _, _ = render_staircase_sequence(
        num_cameras=2, image_size=(968, 648), focal=1200.0,
        radius=9.0, arc_degrees=2.0, num_strips=10, depth_spread=2.0,
    )
    img = jnp.asarray(imgs[0])
    cfg = FrontendConfig(
        max_features=4096, num_octaves=4, upsample_input=True,
        contrast_threshold=0.012, lowe_ratio=0.75,
    )
    S = cfg.scales_per_octave

    @jax.jit
    def stage_pyramid(image):
        base = pyramid.upsample2(image)
        outs = []
        cur = base
        for o in range(cfg.num_octaves):
            blur_in = 1.0 if o == 0 else cfg.sigma0
            gauss = pyramid.gaussian_scale_space(
                cur, sigma0=cfg.sigma0, scales_per_octave=S, assumed_blur=blur_in
            )
            dog = gauss[1:] - gauss[:-1]
            gsl = gauss[1 : S + 1]
            pad = jnp.pad(gsl, ((0, 0), (1, 1), (1, 1)), mode="edge")
            gdx = 0.5 * (pad[:, 1:-1, 2:] - pad[:, 1:-1, :-2])
            gdy = 0.5 * (pad[:, 2:, 1:-1] - pad[:, :-2, 1:-1])
            outs.append((dog, sift._pack_polar(jnp.stack([gdx, gdy]))))
            cur = pyramid.subsample2(gauss[S])
        return outs

    t = timeit(stage_pyramid, [(img + 1e-5 * i,) for i in range(6)])
    H0, W0 = 648 * 2, 968 * 2  # upsampled base
    area = sum((H0 // (1 << o)) * (W0 // (1 << o)) for o in range(4))
    # Per octave: (S+3) gauss levels x 2 separable passes x (read+write),
    # DoG subtract, gradient shifts, polar pack — ~14 full-plane
    # read+write pairs per pixel of each octave (algorithmic estimate).
    add(
        "detect_pyramid_dog_grads", t,
        flops=area * (S + 3) * 2 * 9 * 2.0,
        bytes_=area * 4.0 * 2 * 14,
        note="separable gaussian pyramid + DoG + central grads + polar pack",
    )

    pyr = stage_pyramid(img)
    dogs = [p[0] for p in pyr]
    packs = [p[1] for p in pyr]

    @jax.jit
    def stage_candidates(ds):
        return [sift._octave_candidates(d, cfg) for d in ds]

    t = timeit(stage_candidates, [tuple([[d + 1e-6 * i for d in dogs]])
                                  for i in range(6)])
    vol = sum(int(np.prod(d.shape)) for d in dogs)
    add(
        "detect_extrema_candidates", t,
        bytes_=vol * 4.0 * 4,
        note="dense 26-neighbor extrema masks + subpixel solve over the DoG volume",
    )

    cands = stage_candidates(dogs)
    budgets = sift._octave_budgets(cfg)

    @jax.jit
    def stage_topk(cs):
        outs = []
        for (resp, _), Ko in zip(cs, budgets):
            outs.append(jax.lax.top_k(resp.reshape(-1), Ko))
        return outs

    t = timeit(stage_topk, [tuple([[(r + 1e-7 * i, o) for (r, o) in cands]])
                            for i in range(6)])
    add("detect_topk", t, bytes_=vol * 4.0,
        note="exact top_k over per-octave response volumes")

    # Orientation + descriptor cluster via the full detect minus the rest.
    det = partial(sift.detect_and_compute, cfg=cfg)
    t_full = timeit(det, [(img + 1e-5 * i,) for i in range(6)])
    t_pyr = timeit(stage_pyramid, [(img + 1e-5 * i,) for i in range(6)])
    t_cand = timeit(stage_candidates, [tuple([[d + 1e-6 * i for d in dogs]])
                                       for i in range(6)])
    t_topk = timeit(stage_topk, [tuple([[(r + 1e-7 * i, o) for (r, o) in cands]])
                                 for i in range(6)])
    t_orides = max(t_full - t_pyr - t_cand - t_topk, 1e-6)
    K = cfg.max_features
    add(
        "detect_orientation_descriptor", t_orides,
        gathers=2.0 * K * 256, gather_kind="nearest",
        note=("subtractive: full detect minus pyramid/extrema/topk; "
              "2 x K x 256 one-tap polar gathers (orientation + "
              "descriptor windows) + 36-bin histograms + one-hot matmul"),
    )
    rows.append({"kernel": "detect_total", "ms": round(t_full * 1e3, 3)})

    # ---------------- One LM iteration (bench BA shape) ------------------
    scene = make_scene(num_points=4096, num_cameras=64, arc_degrees=50)
    mc = MapConfig(max_cameras=64, max_points=16384)
    st = map_store.init_map(jnp.asarray(scene.K), mc)
    for c in range(64):
        st, _ = map_store.append_camera(st, jnp.asarray(scene.Rt[c]))
    reps_p = 16384 // 4096
    Xb = np.tile(scene.points, (reps_p, 1)).astype(np.float32)
    st, pb = map_store.append_points(
        st, jnp.asarray(Xb), jnp.zeros((16384, 3)), jnp.ones(16384, bool)
    )
    for c in range(0, 64, 4):
        uv, _ = scene.project(c)
        st = map_store.append_observations(
            st, c, pb, jnp.asarray(np.tile(uv, (reps_p, 1)).astype(np.float32)),
            jnp.ones(16384, bool),
        )
    prob = ba.problem_from_map(st)
    CGI = 15

    def lm8(p):
        out, stats = ba.run_ba(p, max_iterations=8, cg_iters=CGI)
        return jnp.reshape(stats.final_cost, (1,))

    t8 = timeit(lm8, [(jax.tree_util.tree_map(
        lambda a: a + 1e-6 * i if a.dtype == jnp.float32 else a, prob),)
        for i in range(4)], reps=6)
    t_iter = t8 / 8
    P_, C_ = 16384, 64
    grid = P_ * C_
    # Per LM iter: residual grid + weights (~4 passes) + CG (cg_iters x
    # ~3 grid passes for the two J/J^T products) + cost eval x2.
    bytes_lm = grid * 4.0 * (4 + CGI * 3 * 2 + 2 * 2)
    add(
        "ba_lm_iteration_16k_x64", t_iter,
        bytes_=bytes_lm,
        note=(f"dense (P,C) grid sparse-Schur LM, cg_iters={CGI}; bytes = "
              "algorithmic grid passes per iteration"),
    )

    # ---------------- One plane-sweep hypothesis (full res) --------------
    ref = jnp.asarray(imgs[0])
    nbrs = jnp.stack([jnp.asarray(imgs[1])] * 4)
    pose_ref = jnp.eye(3, 4)
    nposes = jnp.stack([jnp.eye(3, 4)] * 4)
    Kc = jnp.asarray(
        [[1200.0, 0, 484.0], [0, 1200.0, 324.0], [0, 0, 1]], jnp.float32
    )
    Hh, Ww = ref.shape
    ref_zm = ref - mvs._box_filter(ref, 2)
    nbrs_zm = nbrs - mvs._box_filter(nbrs, 2)
    R_rel = nposes[:, :, :3]
    t_rel = nposes[:, :, 3] + 0.1
    offs = jnp.linspace(0.08, 0.2, 4)

    @jax.jit
    def sweep4(rz, nz):
        invd, bc, mc_, den = mvs._sweep_select(
            rz, nz, Kc, R_rel, t_rel, jnp.zeros_like(rz), offs, 2,
        )
        return bc

    t4 = timeit(sweep4, [(ref_zm + 1e-5 * i, nbrs_zm) for i in range(6)],
                reps=6)
    t_hyp = t4 / 4
    add(
        "mvs_sweep_per_hypothesis_968x648_m4", t_hyp,
        gathers=Hh * Ww * 4, gather_kind="bilinear",
        note="one inverse-depth hypothesis: H*W*M bilinear samples + 2 box planes",
    )

    result = {
        "device_kind": kind,
        "peaks": peak,
        "gather_speed_of_light_per_s": {
            "nearest_1tap": GATHER_NEAREST_PER_S,
            "bilinear_4corner": GATHER_BILINEAR_PER_S,
        },
        "method": (
            "chained dispatches; FLOPs/bytes are analytic algorithmic "
            "minimums, so fractions are conservative; gather-bound "
            "kernels are also scored against the calibrated element-"
            "gather rate"
        ),
        "kernels": rows,
    }
    os.makedirs(ART, exist_ok=True)
    with open(os.path.join(ART, "ROOFLINE.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
