"""Incremental SfM driver: bootstrap, then register-PnP-triangulate per frame.

JAX equivalent of the reference's main loop (sfm.py:274-423). The
per-frame step (sfm.py:341-412) becomes ONE jitted function
(:func:`register_frame`) over fixed-capacity masked state:

- the reference's `common_points` float-equality association
  (sfm.py:215-239) is replaced by integer track ids carried per feature
  slot of the newest frame;
- `cv2.solvePnPRansac` (sfm.py:67) by the vmapped DLT-PnP RANSAC +
  Gauss-Newton polish;
- `cv2.triangulatePoints` (sfm.py:53) by batched DLT;
- the numpy vstack cloud accumulation (sfm.py:387-395) by masked appends
  into the fixed-capacity MapState.

The host loop only decodes images, calls the jitted pieces, and logs.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from sfm_mvs_tpu.models import map_store
from sfm_mvs_tpu.models.map_store import MapState
from sfm_mvs_tpu.models.two_view import bootstrap
from sfm_mvs_tpu.ops import matching, projection, ransac, sift, triangulation
from sfm_mvs_tpu.ops.sift import Features
from sfm_mvs_tpu.utils.config import SfmConfig


class FrameStats(NamedTuple):
    num_matches: jnp.ndarray  # () matches to previous frame
    num_tracked: jnp.ndarray  # () matches with existing 3D points
    num_pnp_inliers: jnp.ndarray  # () PnP inliers
    num_new_points: jnp.ndarray  # () newly triangulated points
    reproj_error: jnp.ndarray  # () reference-metric mean reprojection error
    accepted: jnp.ndarray  # () bool — False when the frame was rejected


class PipelineState(NamedTuple):
    """Carried across frames (the reference's sliding window, sfm.py:399-409)."""

    map: MapState
    prev_feats: Features
    prev_track: jnp.ndarray  # (max_features,) point id per prev-frame feature slot


def _sample_colors(image_bgr: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Nearest-pixel BGR color at uv — int truncation like the reference
    (`np.array(temp2, dtype=np.int32)`, sfm.py:393-394)."""
    H, W = image_bgr.shape[0], image_bgr.shape[1]
    x = jnp.clip(uv[:, 0].astype(jnp.int32), 0, W - 1)
    y = jnp.clip(uv[:, 1].astype(jnp.int32), 0, H - 1)
    return image_bgr[y, x].astype(jnp.float32)


def _undistort_features(feats: Features, K: jnp.ndarray, cfg: SfmConfig):
    """Front-door radial-distortion correction (cfg.k1/k2; zero = no-op).

    Undistorting the detected keypoints ONCE AT DETECTION TIME makes every
    downstream consumer (E-RANSAC, triangulation, PnP, BA, MVS rays, the
    finalize loop-closure injection and densify sweep) pinhole-consistent —
    the same factorization as undistorting the images, at keypoint cost.
    The reference instead threads dist through each cv2 call (sfm.py:67,88).

    Applied by the driver in ``get_feats`` right after detection, so the
    stored per-camera features (``_cam_feats``) and everything derived
    from them live in the SAME corrected coordinates as the map.
    ``register_frame``/``init_from_bootstrap`` therefore expect features
    that are already pinhole-consistent and do NOT undistort internally
    (advisor r4: the old internal correction left ``_cam_feats`` raw,
    so finalize injected distorted pixels into an undistorted map).
    """
    if cfg.k1 == 0.0 and cfg.k2 == 0.0:
        return feats
    from sfm_mvs_tpu.ops import projection

    dist = jnp.array([cfg.k1, cfg.k2], dtype=feats.xy.dtype)
    return feats._replace(xy=projection.undistort_pixels(feats.xy, K, dist))


@partial(jax.jit, static_argnames=("cfg", "return_track0"))
def init_from_bootstrap(
    key: jax.Array,
    feats0: Features,
    feats1: Features,
    image1_bgr: jnp.ndarray,
    K: jnp.ndarray,
    cfg: SfmConfig,
    return_track0: bool = False,
) -> tuple[PipelineState, FrameStats]:
    """Run the two-view bootstrap and materialize the initial map.

    return_track0: additionally return the track-id vector for frame 0's
    feature slots (the auto-bootstrap driver registers frames on BOTH
    sides of the bootstrap pair, so both anchors need track vectors).

    feats0/feats1 must be pinhole-consistent: with nonzero cfg.k1/k2 the
    caller undistorts once at detection time (see _undistort_features).
    """
    tv = bootstrap(key, feats0, feats1, K, cfg)
    state = map_store.init_map(K, cfg.map)
    state, cam0 = map_store.append_camera(state, tv.pose0)
    state, cam1 = map_store.append_camera(state, tv.pose1)
    colors = _sample_colors(image1_bgr, tv.uv1)
    state, pids = map_store.append_points(state, tv.points, colors, tv.valid)
    state = map_store.append_observations(state, cam0, pids, tv.uv0, tv.valid)
    state = map_store.append_observations(state, cam1, pids, tv.uv1, tv.valid)
    # Track ids for frame-1 feature slots.
    max_feat = feats1.xy.shape[0]
    track = jnp.full((max_feat,), -1, jnp.int32)
    slot = jnp.where(tv.valid, tv.idx1, max_feat)  # OOB -> dropped
    track = track.at[slot].set(pids.astype(jnp.int32), mode="drop")
    stats = FrameStats(
        num_matches=tv.num_matches,
        num_tracked=jnp.sum(tv.valid),
        num_pnp_inliers=tv.num_inliers,
        num_new_points=jnp.sum(tv.valid),
        reproj_error=tv.reproj_error,
        accepted=jnp.asarray(True),
    )
    pstate = PipelineState(map=state, prev_feats=feats1, prev_track=track)
    if return_track0:
        max_feat0 = feats0.xy.shape[0]
        track0 = jnp.full((max_feat0,), -1, jnp.int32)
        slot0 = jnp.where(tv.valid, tv.idx0, max_feat0)
        track0 = track0.at[slot0].set(pids.astype(jnp.int32), mode="drop")
        return pstate, stats, track0
    return pstate, stats


@partial(jax.jit, static_argnames=("cfg",))
def register_frame(
    key: jax.Array,
    pstate: PipelineState,
    new_feats: Features,
    image_bgr: jnp.ndarray,
    cfg: SfmConfig,
    anchor_cam: Optional[jnp.ndarray] = None,
) -> tuple[PipelineState, FrameStats]:
    """Register one new frame against the map (sfm.py:341-412, one jit).

    anchor_cam: camera id of the frame `pstate.prev_feats` belongs to.
    Defaults to the most recently appended camera (the sequential sliding
    window); the auto-bootstrap driver passes it explicitly because its
    registration order walks away from the bootstrap pair in both
    directions.

    new_feats must be pinhole-consistent: with nonzero cfg.k1/k2 the
    caller undistorts once at detection time (see _undistort_features).
    """
    fc, rc = cfg.frontend, cfg.ransac
    state = pstate.map
    K = state.K
    prev = pstate.prev_feats

    # 1. Match previous frame -> new frame (sfm.py:347 find_features).
    m = matching.match_with_config(
        prev.desc, new_feats.desc, prev.valid, new_feats.valid, fc
    )
    uv_prev, uv_new, mvalid = matching.gather_match_points(prev.xy, new_feats.xy, m)

    # 2. Split into tracked (have 3D) / untracked (sfm.py:356-362 analog).
    tids = pstate.prev_track[m.idx0]
    safe_tids = jnp.clip(tids, 0, state.points.shape[0] - 1)
    tracked = mvalid & (tids >= 0) & state.point_valid[safe_tids]
    X_tracked = state.points[safe_tids]

    # 3. PnP-RANSAC on the 2D-3D correspondences (sfm.py:362).
    uv_new_norm = projection.normalize_points(uv_new, K)
    k1, k2 = jax.random.split(key)
    pnp_res = ransac.ransac_pnp(
        k1, X_tracked, uv_new, uv_new_norm, tracked, K,
        threshold_px=rc.pnp_threshold_px, iters=rc.pnp_iters,
        use_p3p=rc.pnp_use_p3p,
    )
    pose_new = pnp_res.model
    state, cam_new = map_store.append_camera(state, pose_new)
    prev_cam = (cam_new - 1) if anchor_cam is None else anchor_cam
    pose_prev = state.poses[prev_cam]

    # 4. Observations of existing points in the new frame (PnP inliers).
    state = map_store.append_observations(
        state, cam_new, tids, uv_new, pnp_res.inliers
    )
    err_tracked = projection.masked_mean_reprojection_error(
        X_tracked, uv_new, pose_new, K, pnp_res.inliers
    )

    # 5. Triangulate brand-new points from untracked matches (sfm.py:371).
    untracked = mvalid & (tids < 0)
    P_prev = K @ pose_prev
    P_new = K @ pose_new
    X_new = triangulation.triangulate_euclidean(P_prev, P_new, uv_prev, uv_new)
    d0, d1 = triangulation.triangulation_depths(pose_prev, pose_new, X_new)
    e_prev = jnp.linalg.norm(
        projection.reprojection_residuals(X_new, uv_prev, pose_prev, K), axis=-1
    )
    e_new = jnp.linalg.norm(
        projection.reprojection_residuals(X_new, uv_new, pose_new, K), axis=-1
    )
    good_new = (
        untracked
        & (d0 > 0)
        & (d1 > 0)
        & (e_prev < rc.pnp_threshold_px)
        & (e_new < rc.pnp_threshold_px)
    )

    # 5b. Re-observation merging: a "new" candidate whose position matches
    # an existing recent map point (same pixel in this camera, consistent
    # depth) is a track re-observation, not a new point. The reference's
    # consecutive-frame association cannot represent this; with the dense
    # obs grid it is one windowed pixel-distance argmin.
    merge_tid = jnp.full(good_new.shape, -1, jnp.int32)
    if rc.merge_reobservations:
        Wm = min(rc.merge_window, state.points.shape[0])
        start = jnp.clip(state.num_points - Wm, 0, state.points.shape[0] - Wm)
        win_pts = jax.lax.dynamic_slice(state.points, (start, 0), (Wm, 3))
        win_valid = jax.lax.dynamic_slice(state.point_valid, (start,), (Wm,))
        win_uv, win_depth = projection.project_depth(win_pts, pose_new, K)
        win_ok = win_valid & (win_depth > 0)
        # pairwise squared pixel distances: (M, Wm)
        d2_px = (
            jnp.sum(uv_new * uv_new, axis=1, keepdims=True)
            + jnp.sum(win_uv * win_uv, axis=1)[None, :]
            - 2.0 * uv_new @ win_uv.T
        )
        d2_px = jnp.where(win_ok[None, :], d2_px, jnp.inf)
        nearest = jnp.argmin(d2_px, axis=1)
        dmin = jnp.min(d2_px, axis=1)
        cand_depth = d1  # depth of the candidate in the new camera
        near_depth = win_depth[nearest]
        depth_ok = (
            jnp.abs(near_depth - cand_depth)
            < rc.merge_depth_rel * jnp.maximum(near_depth, 1e-6)
        )
        merged = good_new & (dmin < rc.merge_px**2) & depth_ok
        merge_tid = jnp.where(merged, (start + nearest).astype(jnp.int32), -1)
        good_new = good_new & ~merged
        # record the re-observation for BA
        state = map_store.append_observations(
            state, cam_new, merge_tid, uv_new, merged
        )
    colors = _sample_colors(image_bgr, uv_new)
    state, new_pids = map_store.append_points(state, X_new, colors, good_new)
    state = map_store.append_observations(state, prev_cam, new_pids, uv_prev, good_new)
    state = map_store.append_observations(state, cam_new, new_pids, uv_new, good_new)
    err_new = projection.masked_mean_reprojection_error(
        X_new, uv_new, pose_new, K, good_new
    )

    # 6. Track ids for the new frame's feature slots.
    max_feat = new_feats.xy.shape[0]
    track = jnp.full((max_feat,), -1, jnp.int32)
    keep_tid = jnp.where(pnp_res.inliers, tids, -1)
    keep_tid = jnp.where(good_new, new_pids.astype(jnp.int32), keep_tid)
    keep_tid = jnp.where(merge_tid >= 0, merge_tid, keep_tid)
    slot = jnp.where(
        pnp_res.inliers | good_new | (merge_tid >= 0), m.idx1, max_feat
    )
    track = track.at[slot].set(keep_tid, mode="drop")

    new_pstate = PipelineState(map=state, prev_feats=new_feats, prev_track=track)

    # Degenerate-frame guard: if PnP found too few inliers, the pose is
    # unreliable — reject the whole update (map untouched, sliding window
    # keeps the previous frame) rather than corrupting the reconstruction.
    accepted = pnp_res.num_inliers >= rc.min_pnp_inliers
    out_pstate = jax.tree_util.tree_map(
        lambda new, old: jnp.where(accepted, new, old), new_pstate, pstate
    )

    stats = FrameStats(
        num_matches=jnp.sum(mvalid),
        num_tracked=jnp.sum(tracked),
        num_pnp_inliers=pnp_res.num_inliers,
        num_new_points=jnp.where(accepted, jnp.sum(good_new), 0),
        reproj_error=0.5 * (err_tracked + err_new),
        accepted=accepted,
    )
    return out_pstate, stats


class IncrementalSfM:
    """Host-side driver: decode -> detect -> bootstrap/register -> export.

    The equivalent of running `python3 sfm.py` (README.md:13), as a
    library: per frame it detects, registers (PnP + triangulation), then
    optionally bundle-adjusts every `cfg.ba.cadence` frames and
    checkpoints every `checkpoint_every` frames.
    """

    def __init__(
        self,
        config: Optional[SfmConfig] = None,
        metrics=None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
    ):
        self.config = config or SfmConfig()
        self.stats: list[dict] = []
        self.metrics = metrics
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every

    def _maybe_ba(self, pstate: PipelineState, frame: int) -> PipelineState:
        cfg = self.config
        if not cfg.ba.enabled:
            return pstate
        if cfg.ba.cadence > 1 and (frame % cfg.ba.cadence) != 0:
            return pstate
        from sfm_mvs_tpu.models import ba as ba_mod

        if cfg.ba.local_window > 0:
            mstate, ba_stats = ba_mod.bundle_adjust_window(
                pstate.map,
                window_cams=cfg.ba.local_window,
                window_points=cfg.ba.window_points,
                max_iterations=cfg.ba.max_iterations,
                huber_delta=cfg.ba.huber_delta,
            )
        else:
            mstate, ba_stats = ba_mod.bundle_adjust_map(
                pstate.map,
                max_iterations=cfg.ba.max_iterations,
                huber_delta=cfg.ba.huber_delta,
            )
        if self.metrics is not None:
            self.metrics.log(
                event="ba",
                frame=frame,
                initial_cost=float(ba_stats.initial_cost),
                final_cost=float(ba_stats.final_cost),
                accepted=int(ba_stats.accepted),
            )
        return pstate._replace(map=mstate)

    def _maybe_checkpoint(self, pstate: PipelineState, frame: int) -> None:
        if not self.checkpoint_dir or not self.checkpoint_every:
            return
        if frame % self.checkpoint_every == 0:
            from sfm_mvs_tpu.utils import checkpoint as ckpt

            ckpt.save_pipeline(
                f"{self.checkpoint_dir}/frame_{frame:05d}.npz", pstate, frame
            )

    def run(
        self,
        images_gray: Sequence[np.ndarray],
        images_bgr: Optional[Sequence[np.ndarray]] = None,
        seed: int = 0,
        resume_state: Optional[PipelineState] = None,
        resume_frame: int = 0,
        batch_detect: int = 0,
    ) -> MapState:
        """Reconstruct from an ordered image sequence.

        images_gray: list of (H, W) float32 in [0, 1].
        images_bgr: optional matching list of (H, W, 3) color images for
        point-cloud colors; grayscale is replicated when absent.
        resume_state/resume_frame: continue a checkpointed run — frames
        up to and including `resume_frame` are skipped.
        batch_detect: if > 0, pre-detect features in vmapped batches of
        this size (shards across the data axis on a multi-chip mesh)
        before the sequential registration loop.
        """
        import time as _time

        cfg = self.config
        K = jnp.asarray(cfg.intrinsic_matrix())
        if images_bgr is None:
            images_bgr = [
                np.repeat((g * 255.0)[..., None], 3, axis=-1) for g in images_gray
            ]

        pre_feats: Optional[list] = None
        if batch_detect > 0:
            from sfm_mvs_tpu.parallel import frontend as par_frontend

            pre_feats = []
            for s in range(0, len(images_gray), batch_detect):
                chunk = images_gray[s : s + batch_detect]
                pad = batch_detect - len(chunk)
                batch = np.stack(list(chunk) + [chunk[-1]] * pad)
                fb = par_frontend.detect_batch(jnp.asarray(batch), cfg.frontend)
                for j in range(len(chunk)):
                    pre_feats.append(
                        jax.tree_util.tree_map(lambda a: a[j], fb)
                    )

        def get_feats(i):
            if pre_feats is not None:
                f = pre_feats[i]
            else:
                f = sift.detect_and_compute(
                    jnp.asarray(images_gray[i]), cfg.frontend
                )
            # Undistort ONCE at detection time so the stored per-camera
            # features (loop closure, densify sweep) and the map agree.
            return _undistort_features(f, K, cfg)

        key = jax.random.PRNGKey(seed)
        # Per REGISTERED camera (rejected frames excluded): features,
        # images, and feature-slot -> point-id track vectors — kept for
        # the finalize densification sweep and loop-closure injection.
        self._cam_feats: list = []
        self._cam_bgr: list = []
        self._cam_gray: list = []
        self._cam_tracks: list = []
        if cfg.bootstrap == "auto" and resume_state is None:
            if self.checkpoint_dir and self.checkpoint_every:
                import warnings

                warnings.warn(
                    "bootstrap=auto registers frames out of order; periodic "
                    "checkpoints are not written (resume would fall back to "
                    "the sequential driver). Run without --checkpoint-every "
                    "or with --bootstrap seq."
                )
            return self._run_auto(images_gray, images_bgr, seed, get_feats)
        if resume_state is not None and cfg.bootstrap == "auto":
            import warnings

            warnings.warn(
                "resuming with bootstrap=auto: continuing with the "
                "SEQUENTIAL driver from the checkpointed state"
            )
        if resume_state is not None:
            pstate = resume_state
            start = resume_frame + 1
            for _ in range(start):
                key, _ = jax.random.split(key)
        else:
            feats = [get_feats(0), get_feats(1)]
            key, k0 = jax.random.split(key)
            pstate, st, track0 = init_from_bootstrap(
                k0, feats[0], feats[1], jnp.asarray(images_bgr[1]), K, cfg,
                return_track0=True,
            )
            self._record(1, st, 0.0)
            self._cam_feats += feats
            self._cam_bgr += [images_bgr[0], images_bgr[1]]
            self._cam_gray += [images_gray[0], images_gray[1]]
            self._cam_tracks += [track0, pstate.prev_track]
            start = 2
        for i in range(start, len(images_gray)):
            t0 = _time.time()
            f = get_feats(i)
            key, ki = jax.random.split(key)
            pstate, st = register_frame(
                ki, pstate, f, jnp.asarray(images_bgr[i]), cfg
            )
            pstate = self._maybe_ba(pstate, i)
            jax.block_until_ready(pstate.map.points)
            self._record(i, st, _time.time() - t0)
            if bool(st.accepted):
                self._cam_feats.append(f)
                self._cam_bgr.append(images_bgr[i])
                self._cam_gray.append(images_gray[i])
                self._cam_tracks.append(pstate.prev_track)
            self._maybe_checkpoint(pstate, i)
        self.state = pstate
        return pstate.map

    def _run_auto(self, images_gray, images_bgr, seed, get_feats) -> MapState:
        """View-graph-driven registration: bootstrap on the strongest
        sufficient-parallax pair (the completed isfm.py, consumed), then
        register the remaining frames walking outward from it. Cameras are
        re-permuted into frame order at the end, so all downstream
        consumers (export, evaluation, sweep) see the usual layout."""
        import time as _time

        import numpy as _np

        from sfm_mvs_tpu.models import exhaustive, map_store as ms

        cfg = self.config
        K = jnp.asarray(cfg.intrinsic_matrix())
        N = len(images_gray)
        feats = [get_feats(i) for i in range(N)]
        graph = exhaustive.build_view_graph(
            images_gray, cfg, seed=seed, feats=feats,
            window=cfg.view_graph_window,
        )
        a, b = exhaustive.best_bootstrap_pair(graph)
        if a > b:
            a, b = b, a
        if self.metrics is not None:
            self.metrics.log(event="bootstrap_auto", pair=[a, b])
        key = jax.random.PRNGKey(seed)
        key, k0 = jax.random.split(key)
        pstate, st, track_a = init_from_bootstrap(
            k0, feats[a], feats[b], jnp.asarray(images_bgr[b]), K, cfg,
            return_track0=True,
        )
        self._record(b, st, 0.0)
        state = pstate.map
        tracks = {a: track_a, b: pstate.prev_track}
        cam_of_frame = {a: 0, b: 1}
        frame_of_cam = [a, b]

        # Walks: forward past b, backward before a, and the a..b interior.
        walks = [
            (range(b + 1, N), b),
            (range(a - 1, -1, -1), a),
            (range(a + 1, b), a),
        ]
        step = 1
        for frames, anchor in walks:
            for f in frames:
                t0 = _time.time()
                key, ki = jax.random.split(key)
                pstate_f = PipelineState(
                    map=state,
                    prev_feats=feats[anchor],
                    prev_track=tracks[anchor],
                )
                new_pstate, st = register_frame(
                    ki, pstate_f, feats[f], jnp.asarray(images_bgr[f]), cfg,
                    anchor_cam=jnp.asarray(cam_of_frame[anchor], jnp.int32),
                )
                new_pstate = self._maybe_ba(new_pstate, step)
                jax.block_until_ready(new_pstate.map.points)
                self._record(f, st, _time.time() - t0)
                if bool(st.accepted):
                    state = new_pstate.map
                    tracks[f] = new_pstate.prev_track
                    cam_of_frame[f] = len(frame_of_cam)
                    frame_of_cam.append(f)
                    anchor = f
                step += 1

        # Restore frame order for export/evaluation/sweep.
        perm = _np.argsort(frame_of_cam)
        state = ms.reorder_cameras(state, perm)
        frames_sorted = sorted(frame_of_cam)
        self._cam_feats = [feats[f] for f in frames_sorted]
        self._cam_bgr = [images_bgr[f] for f in frames_sorted]
        self._cam_gray = [images_gray[f] for f in frames_sorted]
        self._cam_tracks = [tracks[f] for f in frames_sorted]
        self.bootstrap_pair = (a, b)
        last = frames_sorted[-1]
        self.state = PipelineState(
            map=state, prev_feats=feats[last], prev_track=tracks[last]
        )
        return state

    def finalize(
        self,
        cull_px: float = 4.0,
        compact: bool = True,
        ba_iterations: int = 0,
    ) -> MapState:
        """Final polish: optional loop-closure injection, capacity
        right-sizing, cull + global BA, optional shared-intrinsics
        refinement, then the optional densification sweep
        (cfg.sweep.enabled) that restores reference-level cloud density.
        Updates and returns the map.

        compact: BA cost on the dense grid is capacity-proportional, so
        the map is compacted and shrunk to ~1.25x its live point count
        before the global solves (external track ids are remapped)."""
        from sfm_mvs_tpu.models.refine import finalize_map

        if ba_iterations <= 0:
            ba_iterations = 20  # historical finalize_map default
        state = self.state.map
        if compact:
            state, remap = map_store.compact_points(state)
            live = int(state.num_points)
            cap = 1024
            while cap < int(1.25 * live):
                cap *= 2
            state = map_store.shrink_map(state, cap)
            P_new = state.points.shape[0]

            def _remap(t):
                safe = jnp.clip(t, 0, remap.shape[0] - 1)
                new = jnp.where(t >= 0, remap[safe], -1)
                return jnp.where(new < P_new, new, -1)

            self._cam_tracks = [_remap(t) for t in self._cam_tracks]
            self.state = self.state._replace(
                map=state, prev_track=_remap(self.state.prev_track)
            )
        n_closed = 0
        if (
            self.config.loop_close_pairs > 0
            and len(self._cam_tracks) == int(state.num_cams)
        ):
            from sfm_mvs_tpu.models import exhaustive

            # Camera-aligned view graph (full O(C^2)) -> strongest
            # non-adjacent pairs -> re-observation injection BOTH ways.
            graph = exhaustive.build_view_graph(
                self._cam_gray, self.config, feats=self._cam_feats
            )
            pairs = exhaustive.strongest_loop_pairs(
                graph, self.config.loop_close_pairs
            )
            # Epipolar-verified with a loose map gate: on a drifted map
            # the default map-agreement gate rejects exactly the matches
            # that localize the drift (see inject_reobservations doc).
            ckey = jax.random.PRNGKey(int(state.num_cams))
            for i, j in pairs:
                ckey, k1, k2 = jax.random.split(ckey, 3)
                state, n1 = exhaustive.inject_reobservations(
                    state, jnp.asarray(i), jnp.asarray(j),
                    self._cam_feats[i], self._cam_feats[j],
                    self._cam_tracks[i], self.config,
                    key=k1, max_err_px=self.config.map.stitch_gate_px,
                    epipolar_verify=True,
                )
                state, n2 = exhaustive.inject_reobservations(
                    state, jnp.asarray(j), jnp.asarray(i),
                    self._cam_feats[j], self._cam_feats[i],
                    self._cam_tracks[j], self.config,
                    key=k2, max_err_px=self.config.map.stitch_gate_px,
                    epipolar_verify=True,
                )
                n_closed += int(n1) + int(n2)
            self.state = self.state._replace(map=state)

        # Loop closures can re-associate a landmark that exists as two
        # track chains; merge duplicates within ~2px-at-median-depth once
        # the robust phase has straightened them into agreement.
        merge_eps = 0.0
        if n_closed:
            z = np.asarray(
                jnp.einsum(
                    "pj,j->p", state.points, state.poses[0][2, :3]
                ) + state.poses[0][2, 3]
            )
            z_med = float(np.median(z[np.asarray(state.point_valid)]))
            merge_eps = 2.0 * max(z_med, 1e-3) / float(state.K[0, 0])
        state, info = finalize_map(
            state, max_iterations=ba_iterations, cull_px=cull_px,
            # Loop-closure observations may carry large (drift-revealing)
            # errors; relax robustly before the cull can delete them.
            robust_iterations=30 if n_closed else 0,
            merge_eps_3d=merge_eps,
        )
        if n_closed:
            info["loop_closure_obs"] = n_closed
        merge_remap = info.pop("point_remap", None)
        if merge_remap is not None:
            # Duplicate-landmark merging re-pointed some track ids at
            # their surviving twins; keep the driver's track vectors in
            # step (they feed the densify sweep below and any resumed
            # registration — advisor r4).
            def _remap_merged(t):
                safe = jnp.clip(t, 0, merge_remap.shape[0] - 1)
                return jnp.where(t >= 0, merge_remap[safe], -1)

            self._cam_tracks = [_remap_merged(t) for t in self._cam_tracks]
            self.state = self.state._replace(
                prev_track=_remap_merged(self.state.prev_track)
            )
        aligned = len(self._cam_feats) == int(state.num_cams)
        if self.config.sweep.enabled and not aligned:
            # Resumed runs don't retain pre-resume frames; the sweep
            # needs a feature list aligned with camera ids.
            import warnings

            warnings.warn(
                "densification sweep skipped: stored per-camera features "
                "do not cover all registered cameras (resumed run?)"
            )
        if self.config.sweep.enabled and aligned:
            from sfm_mvs_tpu.models import densify

            state, sweep_info = densify.finalize_with_sweep(
                state, self._cam_feats, self._cam_bgr, self.config,
                cull_px=cull_px, images_gray=self._cam_gray,
            )
            info.update(sweep_info)
        if (
            self.config.ba.refine_intrinsics
            or self.config.ba.refine_intrinsics_per_camera
        ):
            # Run LAST so the recovered [f_scale, k1, k2] describes the
            # exported map: the sweep's pinhole-only solves would otherwise
            # drop k1/k2 and partially undo the refinement (advisor r2).
            from sfm_mvs_tpu.models import ba as ba_mod

            if self.config.ba.refine_intrinsics_per_camera:
                state, ba_stats, intr = (
                    ba_mod.bundle_adjust_map_percam_intrinsics(
                        state, max_iterations=ba_iterations
                    )
                )
                n = int(state.num_cams)
                info["intrinsics_per_camera"] = [
                    [float(x) for x in row] for row in np.asarray(intr[:n])
                ]
            else:
                state, ba_stats, intr = ba_mod.bundle_adjust_map_intrinsics(
                    state, max_iterations=ba_iterations
                )
                info["intrinsics"] = [float(x) for x in intr]
            info["final_cost"] = float(ba_stats.final_cost)
        if self.metrics is not None:
            self.metrics.log(event="finalize", **info)
        self.finalize_info = info
        self.state = self.state._replace(map=state)
        return state

    def _record(self, frame: int, st: FrameStats, wall_s: float) -> None:
        d = self._stat_dict(frame, st)
        d["wall_s"] = wall_s
        self.stats.append(d)
        if self.metrics is not None:
            self.metrics.log(event="frame", **d)

    @staticmethod
    def _stat_dict(frame: int, st: FrameStats) -> dict:
        return {
            "frame": frame,
            "matches": int(st.num_matches),
            "tracked": int(st.num_tracked),
            "pnp_inliers": int(st.num_pnp_inliers),
            "new_points": int(st.num_new_points),
            "reproj_error": float(st.reproj_error),
            "accepted": bool(st.accepted),
        }
