"""Stage-by-stage detector timing on the device + the matcher.

Times each stage of detect_and_compute separately (pyramid/DoG, extrema
candidates, top-k, orientation, deferred descriptor) at bench resolution,
plus the 2-NN matcher at bench shapes, as a pipelined chain of calls
(throughput, not per-call latency).

    python benchmarks/detect_breakdown.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json
import time

import numpy as np


def timeit(fn, arglists, reps=12):
    """CHAINED timing: each rep's input carries a zero-valued but
    data-dependent term derived from the previous rep's output, so reps
    run in order. The dep-injection and output-scalar extraction are
    folded into one jitted step, so each rep is exactly one dispatch.
    """
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
        leaves = [l for l in jax.tree_util.tree_leaves(out)
                  if hasattr(l, "dtype")]
        s = jnp.float32(0.0)
        for l in leaves[:3]:
            s = s + jnp.sum(l[..., :1].astype(jnp.float32))
        # Accumulate the carry: without this, carries CYCLE with the
        # arglist period and reps become bitwise-identical dispatches.
        return carry * 0.5 + s * 1e-12

    carry = step(jnp.float32(0.0), arglists[0])  # compile
    jax.block_until_ready(carry)

    t0 = time.time()
    for i in range(reps):
        carry = step(carry, arglists[i % len(arglists)])
    jax.block_until_ready(carry)
    return (time.time() - t0) / reps


def vary_img(img, n=6):
    import jax.numpy as jnp

    return [(img + 1e-5 * i,) for i in range(n)]


def main():
    import jax
    import jax.numpy as jnp
    from functools import partial

    from sfm_mvs_tpu.ops import matching, pyramid, sift
    from sfm_mvs_tpu.utils import cache
    from sfm_mvs_tpu.utils.config import FrontendConfig
    from sfm_mvs_tpu.utils.synthetic import render_staircase_sequence

    cache.enable()
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
    res = {}

    # --- full detect ---
    det = partial(sift.detect_and_compute, cfg=cfg)
    res["detect_total_ms"] = timeit(det, vary_img(img)) * 1e3

    # --- stage: pyramid + DoG + gradients (all octaves) ---
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

    pyr = stage_pyramid(img)
    res["pyramid_dog_grad_ms"] = timeit(stage_pyramid, vary_img(img)) * 1e3

    dogs = [p[0] for p in pyr]
    packs = [p[1] for p in pyr]

    # --- stage: extrema candidates (dense masks + subpixel solve) ---
    @jax.jit
    def stage_candidates(dogs):
        return [sift._octave_candidates(d, cfg) for d in dogs]

    cands = stage_candidates(dogs)
    dogs_v = [tuple([[d + 1e-6 * i for d in dogs]]) for i in range(6)]
    res["extrema_candidates_ms"] = timeit(stage_candidates, dogs_v) * 1e3

    # --- stage: top-k per octave ---
    budgets = sift._octave_budgets(cfg)

    @jax.jit
    def stage_topk(cands):
        outs = []
        for (resp, _), Ko in zip(cands, budgets):
            outs.append(jax.lax.top_k(resp.reshape(-1), Ko))
        return outs

    tops = stage_topk(cands)
    cands_v = [
        tuple([[(r + 1e-7 * i, o) for (r, o) in cands]]) for i in range(6)
    ]
    res["topk_ms"] = timeit(stage_topk, cands_v) * 1e3

    # --- stage: orientation (octave 0 budget, the dominant one) ---
    (resp0, (dx0, dy0, ds0)) = cands[0]
    top_resp0, top_idx0 = tops[0]
    h0, w0 = dogs[0].shape[1], dogs[0].shape[2]

    @jax.jit
    def stage_orient(pack, top_idx):
        lay = top_idx // (h0 * w0)
        rem = top_idx % (h0 * w0)
        iy = (rem // w0).astype(jnp.float32)
        ix = (rem % w0).astype(jnp.float32)
        sig = jnp.full_like(ix, cfg.sigma0 * 1.5)
        sampler = sift._polar_sampler(pack)
        return sift._orientation(sampler, lay, ix, iy, sig)

    ori_v = [(packs[0], jnp.roll(top_idx0, i)) for i in range(6)]
    res["orientation_oct0_ms"] = timeit(stage_orient, ori_v) * 1e3

    # --- stage: deferred descriptor at full capacity ---
    K = cfg.max_features

    @jax.jit
    def stage_desc(pack, top_idx):
        idx = jnp.tile(top_idx, (K // top_idx.shape[0] + 1,))[:K]
        lay = idx // (h0 * w0)
        rem = idx % (h0 * w0)
        iy = (rem // w0).astype(jnp.float32)
        ix = (rem % w0).astype(jnp.float32)
        sig = jnp.full_like(ix, cfg.sigma0 * 1.5)
        ang = jnp.zeros_like(ix)
        sampler = sift._polar_sampler(pack)
        return sift._descriptor(sampler, lay, ix, iy, sig, ang, cfg)

    desc_v = [(packs[0], jnp.roll(top_idx0, i)) for i in range(6)]
    res["descriptor_4096_ms"] = timeit(stage_desc, desc_v) * 1e3

    # --- matcher at bench shapes ---
    rng = np.random.default_rng(0)
    d0 = jnp.asarray(rng.standard_normal((4096, 128)), jnp.float32)
    d1 = jnp.asarray(rng.standard_normal((4096, 128)), jnp.float32)
    v = jnp.ones((4096,), bool)

    m_v = [(d0 + 1e-4 * i, d1) for i in range(6)]
    res["matcher_xla_ms"] = timeit(
        lambda a, b: matching.knn_match(a, b, v, v, ratio=0.75), m_v
    ) * 1e3

    # Sanity floor: a full detect at 968x648 cannot execute in <1 ms; if
    # it reads less, block_until_ready returned before the work finished.
    if res.get("detect_total_ms", 1e9) < 1.0:
        res["WARNING"] = (
            "timings are dispatch-only (results were not ready); cross-check"
            " against an end-to-end wall"
        )
    print(json.dumps({k: round(v, 3) if isinstance(v, float) else v
                      for k, v in res.items()}))


if __name__ == "__main__":
    main()
