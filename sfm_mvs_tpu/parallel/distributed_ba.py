"""Distributed bundle adjustment: point-block-sharded Schur reduction.

The map's dense (P, C) observation grid and its point state shard by
POINT BLOCKS across the mesh (the 'sequence axis' of this domain,
SURVEY.md §5); camera state is replicated. Each device eliminates its own
point blocks entirely locally (V, V^-1, point back-substitution never
leave the device); only the small reduced camera system — (C,6,6) Hessian
blocks, (C,6) gradients and CG products — is psum-aggregated.
That is exactly the "per-device Schur elimination of local point blocks,
reduced camera blocks aggregated with collectives" design of SURVEY.md
§2.3. The LM trajectory is identical to the single-device solve —
verified in tests — while the O(P*C) work scales with device count.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from sfm_mvs_tpu.models import ba
from sfm_mvs_tpu.models.ba import BAProblem, BAStats
from sfm_mvs_tpu.models.map_store import MapState


def _specs(mesh: Mesh, axis: str):
    """BAProblem spec tree: point axis sharded, camera state replicated."""
    rep = P()
    pt = P(axis)
    return BAProblem(
        cam_params=rep, points=pt, cam_valid=rep, point_valid=pt,
        obs_uv=pt, obs_mask=pt, K=rep, frozen=rep, intr=rep,
    )


@lru_cache(maxsize=None)
def _sharded_runner(
    mesh: Mesh, axis: str, max_iterations: int, cg_iters: int,
    damping_init: float, huber_delta: float,
):
    """Build (once per config) the jitted shard_map BA runner.

    Building the shard_map + jit closure inside every call created a
    fresh Python callable each time — a jit cache miss, i.e. a full
    RECOMPILE per invocation (caught in round 5 when the per-frame
    sharded windowed BA recompiled every frame). Mesh is hashable, so
    the compiled runner caches on (mesh, axis, solver params).
    """
    in_specs = _specs(mesh, axis)
    out_specs = (in_specs, BAStats(P(), P(), P(), P()))

    @partial(
        shard_map, mesh=mesh, in_specs=(in_specs,), out_specs=out_specs,
        check_vma=False,
    )
    def _run(p: BAProblem):
        return ba.run_ba(
            p,
            max_iterations=max_iterations,
            cg_iters=cg_iters,
            damping_init=damping_init,
            huber_delta=huber_delta,
            axis_name=axis,
        )

    return jax.jit(_run)


def run_ba_sharded(
    prob: BAProblem,
    mesh: Mesh,
    axis: str = "data",
    max_iterations: int = 20,
    cg_iters: int = 20,
    damping_init: float = 1e-3,
    huber_delta: float = 0.0,
) -> tuple[BAProblem, BAStats]:
    """LM bundle adjustment with point blocks sharded over `axis`.

    Requires max_points divisible by the axis size (capacities are powers
    of two, so any power-of-two mesh works).
    """
    return _sharded_runner(
        mesh, axis, max_iterations, cg_iters, damping_init, huber_delta
    )(prob)


def bundle_adjust_window_sharded(
    state: MapState,
    mesh: Mesh,
    axis: str = "data",
    window_cams: int = 16,
    window_points: int = 16384,
    max_iterations: int = 8,
    cg_iters: int = 12,
    freeze_cams: int = 2,
    huber_delta: float = 0.0,
) -> tuple[MapState, BAStats]:
    """Sliding-window local BA with the WINDOW's point axis sharded.

    The distributed analog of ba.bundle_adjust_window (config-4 scale:
    long sequences registered with windowed BA on a sharded map — the
    windowed path had only ever run single-device, VERDICT r4 item 1).
    The static (Wp, Wc) sub-problem is extracted exactly like the
    single-device version, then its point axis (Wp) shards over the mesh
    and the same run_ba executes under shard_map with psum'd camera
    blocks — the LM trajectory is identical to the single-device window
    solve. window_points must be divisible by the axis size (capacities
    are powers of two).
    """
    import jax.numpy as jnp

    from sfm_mvs_tpu.ops import lie

    C = state.poses.shape[0]
    P_ = state.points.shape[0]
    Wc = min(window_cams, C)
    Wp = min(window_points, P_)
    c0 = jnp.clip(state.num_cams - Wc, 0, C - Wc)
    p0 = jnp.clip(state.num_points - Wp, 0, P_ - Wp)

    poses_w = jax.lax.dynamic_slice(state.poses, (c0, 0, 0), (Wc, 3, 4))
    cam_valid_w = jax.lax.dynamic_slice(state.cam_valid, (c0,), (Wc,))
    points_w = jax.lax.dynamic_slice(state.points, (p0, 0), (Wp, 3))
    point_valid_w = jax.lax.dynamic_slice(state.point_valid, (p0,), (Wp,))
    obs_uv_w = jax.lax.dynamic_slice(state.obs_uv, (p0, c0, 0), (Wp, Wc, 2))
    obs_mask_w = jax.lax.dynamic_slice(state.obs_mask, (p0, c0), (Wp, Wc))

    obs_w = obs_mask_w & point_valid_w[:, None] & cam_valid_w[None, :]
    point_ok = point_valid_w & (jnp.sum(obs_w.astype(jnp.int32), axis=1) >= 2)
    slot = jnp.arange(Wc)
    frozen = (slot < freeze_cams) | ~cam_valid_w

    rvec, tvec = lie.matrix_to_rt(poses_w)
    prob = BAProblem(
        cam_params=jnp.concatenate([rvec, tvec], axis=-1),
        points=points_w,
        cam_valid=cam_valid_w,
        point_valid=point_ok,
        obs_uv=obs_uv_w,
        obs_mask=obs_mask_w,
        K=state.K,
        frozen=frozen,
        intr=prob_intr(points_w.dtype),
    )
    prob, stats = _sharded_runner(
        mesh, axis, max_iterations, cg_iters, 1e-3, huber_delta
    )(prob)

    poses_new = lie.rt_to_matrix(prob.cam_params[:, :3], prob.cam_params[:, 3:6])
    poses_new = jnp.where(frozen[:, None, None], poses_w, poses_new)
    points_new = jnp.where(point_ok[:, None], prob.points, points_w)
    return state._replace(
        poses=jax.lax.dynamic_update_slice(state.poses, poses_new, (c0, 0, 0)),
        points=jax.lax.dynamic_update_slice(state.points, points_new, (p0, 0)),
    ), stats


def prob_intr(dtype):
    import jax.numpy as jnp

    return jnp.asarray(ba._INTR_IDENTITY, dtype)


def bundle_adjust_map_sharded(
    state: MapState,
    mesh: Mesh,
    axis: str = "data",
    max_iterations: int = 20,
    cg_iters: int = 20,
    frozen_first: int = 1,
    huber_delta: float = 0.0,
) -> tuple[MapState, BAStats]:
    """map -> distributed BA -> map."""
    prob = ba.problem_from_map(state, frozen_first=frozen_first)
    prob, stats = run_ba_sharded(
        prob, mesh, axis=axis, max_iterations=max_iterations,
        cg_iters=cg_iters, huber_delta=huber_delta,
    )
    return ba.write_back_to_map(state, prob), stats
