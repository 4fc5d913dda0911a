"""The full SLAM engine: VO + global feature map + bundle adjustment.

Batched replacement for the reference's orchestrator and thread pipeline
(reference: src/PUTSLAM/PUTSLAM.cpp:677-930 front-end loop — VO, map pose
read, covisible-feature fetch, guided matching with retry :788-798,
pose-pose vs pose-feature edge policy :814-838, feature provisioning
:845-891; the background optimization thread featuresMap.cpp:881-1026 runs
here as a synchronous, deterministic BA every N frames — OPTTHREAD_ATEND
style determinism with OPTTHREAD_ON cadence).

The entire per-frame step — including the (conditionally executed) Schur
BA — is one jitted ``lax.scan`` body carrying a ``SlamState`` value. The
"pose read = optimized prefix ∘ odometry suffix" contract
(featuresMap.cpp:610-627) appears as re-anchoring the live pose on the
last keyframe after each BA.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from putslam_tpu.backend import graph as graph_mod
from putslam_tpu.backend import optimize as opt_mod
from putslam_tpu.config import SlamConfig
from putslam_tpu.frontend import ransac as ransac_mod
from putslam_tpu.frontend.detector import Features, detect_and_describe
from putslam_tpu.geometry import se3
from putslam_tpu.geometry import uncertainty as uncertainty_mod
from putslam_tpu.loopclosure import bow
from putslam_tpu.loopclosure import verify as lc_verify
from putslam_tpu.models import vo as vo_mod
from putslam_tpu.motion import ekf as ekf_mod
from putslam_tpu.slam_map import features_map as fm


class SlamState(NamedTuple):
    map: fm.MapState
    graph: graph_mod.GraphState
    prev_feat: Features
    pose: jnp.ndarray        # (7,) current camera→world
    # smoothed OUTPUT pose chain (cfg.pose_blend_alpha): follows `pose`
    # with a first-order lag that suppresses the per-frame re-draw of the
    # absolute map-RANSAC noise; internal logic (matching, keyframes, BA)
    # always uses the full-snap `pose`, so accuracy/drift control is
    # untouched — only the emitted trajectory is low-passed
    pose_smooth: jnp.ndarray  # (7,)
    last_kf_idx: jnp.ndarray # () int32 ring index of the last keyframe
    last_kf_pose: jnp.ndarray  # (7,) its pose at creation (for re-anchoring)
    frames_since_kf: jnp.ndarray  # () int32
    frame_idx: jnp.ndarray   # () int32
    key: jax.Array
    # --- loop closure (populated only when cfg.loop_closure.enabled) ------
    kf_sig: jnp.ndarray      # (K, V) BoW signatures per keyframe ring slot
    sig_valid: jnp.ndarray   # (K,) bool
    lc_queue: bow.LCQueue    # candidate priority buffer
    n_lc_edges: jnp.ndarray  # () int32 accepted loop closures
    # sticky degraded-mode health: EMA of the strict first-pass map inlier
    # ratio (cfg.matcher.degraded_health_ratio gates the recovery ladder)
    health: jnp.ndarray      # () float32 in [0, 1]
    # consecutive frames on which the map RANSAC FOUND a fix that the
    # distance gate rejected — the deadlock signature that grows the
    # correction sanity gate (cfg.map_correction_growth)
    frames_since_map_ok: jnp.ndarray  # () int32
    # --- decaying-velocity EKF (predict/correct only when
    # cfg.motion_model.enabled; otherwise carried through untouched) -------
    ekf: ekf_mod.EKFState


class SlamOutputs(NamedTuple):
    pose: jnp.ndarray
    vo_ok: jnp.ndarray
    map_ok: jnp.ndarray
    n_map_matches: jnp.ndarray
    n_map_inliers: jnp.ndarray
    is_keyframe: jnp.ndarray
    ba_ran: jnp.ndarray
    chi2: jnp.ndarray
    n_landmarks: jnp.ndarray
    # --- anchoring record for end-of-run trajectory repair ----------------
    # the frame's pose is kf-anchored (pose = kf ∘ suffix); after the final
    # full-graph BA the exported trajectory is rebuilt from the *optimized*
    # keyframe poses (updateCamTrajectory, featuresMap.cpp:1273-1295)
    anchor_ring: jnp.ndarray   # () int32 — keyframe ring slot anchoring this frame
    anchor_seq: jnp.ndarray    # () int32 — that keyframe's sequential number
    anchor_pose: jnp.ndarray   # (7,) — the anchor keyframe pose at emit time


@functools.partial(jax.jit, static_argnums=(0, 4))
def slam_init(cfg: SlamConfig, gray, depth, init_pose=None,
              seed: int = 0) -> SlamState:
    """First frame (processFirstFrame, PUTSLAM.cpp:315-333): detect, create
    keyframe 0, provision initial landmarks. Jitted as one program, so
    the first frame costs one compile instead of one per small op."""
    if init_pose is None:
        init_pose = se3.identity()
    init_pose = jnp.asarray(init_pose)
    feat = detect_and_describe(cfg, jnp.asarray(gray), jnp.asarray(depth))
    m = fm.init_map(cfg)
    m, kf_idx = fm.add_keyframe(cfg, m, init_pose, jnp.float32(1.0))
    m = fm.add_landmarks(cfg, m, init_pose, feat,
                         jnp.zeros((feat.capacity,), bool), jnp.int32(0))
    g = graph_mod.init_graph(cfg.backend.max_observations,
                             cfg.backend.max_pose_pose_edges)
    # anchor observations of the initial landmarks to keyframe 0 (only
    # features that actually became landmarks — the provisioning cap may
    # have dropped some)
    lm_idx, lm_dist = _landmark_indices_for(m, init_pose, feat)
    g = graph_mod.add_observations(
        g, jnp.full((feat.capacity,), kf_idx, jnp.int32),
        lm_idx,
        feat.xyz, jnp.full((feat.capacity,), _obs_info(cfg)),
        feat.has_depth & (lm_dist < 1e-4),
        gen=m.lm_gen[lm_idx],
        kf_gen=jnp.full((feat.capacity,), m.kf_gen[kf_idx], jnp.int32),
        info=_full_obs_info(cfg, feat.uv_undist, feat.xyz,
                            _obs_dirs(cfg, jnp.asarray(gray),
                                      jnp.asarray(depth), feat)))
    K = cfg.map.max_keyframes
    V = cfg.loop_closure.vocab_size
    vocab = bow.make_vocab(V)
    sig0 = bow.signature(vocab, feat.desc, feat.valid)
    return SlamState(
        map=m, graph=g, prev_feat=feat, pose=init_pose,
        pose_smooth=init_pose,
        last_kf_idx=kf_idx, last_kf_pose=init_pose,
        frames_since_kf=jnp.int32(0), frame_idx=jnp.int32(1),
        key=jax.random.PRNGKey(seed),
        kf_sig=jnp.zeros((K, V), jnp.float32).at[kf_idx].set(sig0),
        sig_valid=jnp.zeros((K,), bool).at[kf_idx].set(True),
        lc_queue=bow.init_queue(cfg.loop_closure.queue_capacity),
        n_lc_edges=jnp.int32(0),
        health=jnp.float32(1.0),
        frames_since_map_ok=jnp.int32(0),
        ekf=ekf_mod.init(cfg.motion_model, init_pose),
    )


def _obs_info(cfg: SlamConfig) -> float:
    """Scalar information weight for 3D observations: 1/σ² with σ matched to
    the front-end inlier gate (the reference's useUncertainty=false mode uses
    identity information, graph weights; we normalize so chi² per good edge
    is O(1) and Cauchy δ=1 behaves like g2o's)."""
    sigma = cfg.ransac.inlier_threshold_euclidean / 2.0
    return 1.0 / (sigma * sigma)


def _full_obs_info(cfg: SlamConfig, uv, xyz, dirs=None):
    """Per-observation 3×3 information matrices from the depth-sensor noise
    model (useUncertainty mode, depthSensorModel.cpp:28-59) — None when the
    engine runs with scalar weights (add_observations stores zeros).

    ``dirs``: optional (N,3) anisotropy directions (surface normals or
    image-gradient directions, per cfg.map.uncertainty_model) — the
    covariance is shrunk along them before inversion
    (depthSensorModel.cpp:62-95). Zero rows leave the sensor model as-is."""
    if not cfg.map.use_uncertainty:
        return None
    z = jnp.maximum(xyz[..., 2], cfg.camera.min_depth)
    cov = uncertainty_mod.point_covariance(cfg.camera, uv, z)
    if dirs is not None:
        model = cfg.map.uncertainty_model
        scale = (cfg.map.scale_uncertainty_normal if model == "normal"
                 else cfg.map.scale_uncertainty_gradient)
        shaped = (
            uncertainty_mod.normal_scaled_covariance(cov, dirs, scale)
            if model == "normal"
            else uncertainty_mod.gradient_scaled_covariance(cov, dirs, scale))
        have = jnp.linalg.norm(dirs, axis=-1) > 1e-6
        cov = jnp.where(have[:, None, None], shaped, cov)
    return uncertainty_mod.inv3x3(cov)


def _obs_dirs(cfg: SlamConfig, gray, depth, feat: Features):
    """(N,3) anisotropy directions for the configured uncertainty model
    (None for the plain sensor model): surface normals sampled at the
    feature pixels, or lifted image-gradient directions
    (ops/rgbd.surface_normals / gradient_directions_3d ←
    depthSensorModel.cpp:62-95, RGBD.cpp:101-187)."""
    from putslam_tpu.ops import rgbd

    model = cfg.map.uncertainty_model
    if not cfg.map.use_uncertainty or model == "sensor":
        return None
    if model == "normal":
        nm = rgbd.surface_normals(cfg.camera, depth)            # (H, W, 3)
        iu = jnp.clip(jnp.round(feat.uv[:, 0]).astype(jnp.int32), 0,
                      cfg.camera.width - 1)
        iv = jnp.clip(jnp.round(feat.uv[:, 1]).astype(jnp.int32), 0,
                      cfg.camera.height - 1)
        return nm[iv, iu]
    if model == "gradient":
        z = jnp.maximum(feat.xyz[..., 2], cfg.camera.min_depth)
        return rgbd.gradient_directions_3d(cfg.camera, gray, feat.uv, z)
    raise ValueError(model)


def _landmark_indices_for(m: fm.MapState, pose, feat: Features):
    """After provisioning, find for each feature the landmark slot whose
    world position equals its lifted position (used only at init).
    Returns (indices (N,), distances (N,))."""
    xyz_w = se3.apply(pose, feat.xyz)
    d = jnp.linalg.norm(xyz_w[:, None, :] - m.lm_pos[None, :, :], axis=-1)
    d = jnp.where(m.lm_valid[None, :], d, jnp.inf)
    return jnp.argmin(d, axis=1).astype(jnp.int32), jnp.min(d, axis=1)


@functools.partial(jax.jit, static_argnums=(0, 5))
def slam_step(cfg: SlamConfig, state: SlamState, gray, depth,
              gt_pose=None, playback: bool = False
              ) -> Tuple[SlamState, SlamOutputs]:
    key, k_vo, k_map = jax.random.split(state.key, 3)
    feat = detect_and_describe(cfg, gray, depth)
    # anisotropy directions for the observation-uncertainty model (None
    # unless use_uncertainty with a normal/gradient model)
    obs_dirs = _obs_dirs(cfg, gray, depth, feat)

    # ---- 1. frame-to-frame VO prediction --------------------------------
    # playback mode = the reference's "inverse SLAM problem" (startPlaying,
    # PUTSLAM.cpp:336-393): a known trajectory drives the map/backend with
    # no visual odometry in the loop.
    if playback:
        degraded = jnp.asarray(False)
        vo_res = vo_mod.VOStepResult(
            se3.identity(), jnp.int32(0), jnp.int32(0), jnp.float32(1.0),
            jnp.asarray(True))
        pose_pred = gt_pose
        ekf_pred = state.ekf
    else:
        degraded = state.health < cfg.matcher.degraded_health_ratio
        vo_res = vo_mod.vo_step(cfg, k_vo, state.prev_feat, feat,
                                force_retry=degraded)
        pose_pred = se3.compose(state.pose, vo_res.rel_pose)
        ekf_pred = state.ekf
        if cfg.motion_model.enabled:
            # decaying-velocity prior (decayingVelocityModel.cpp:28-40,
            # wiring point PUTSLAM.cpp:329-332): when frame-to-frame VO
            # fails (identity fallback), the EKF's constant-velocity
            # prediction replaces the dead-stop prior — guided matching
            # then searches around where the camera most likely IS
            ekf_pred = ekf_mod.predict(cfg.motion_model, state.ekf, 1.0)
            prior = ekf_mod.predicted_pose(ekf_pred)
            pose_pred = jnp.where(vo_res.ok, pose_pred, prior)

    # ---- 2. guided map matching (matchXYZ) + absolute pose RANSAC -------
    # retry ladder (PUTSLAM.cpp:788-798): when the map RANSAC comes back
    # with a poor inlier ratio, re-run the guided match with a widened
    # search sphere (statically unrolled; each widening is lax.cond-gated so
    # the extra L×N matmul is only paid on the degraded frames)
    def run_guided(scale, key, hamming_slack=0.0, thr_scale=1.0):
        # degraded-frame recovery: retries also widen the RANSAC inlier
        # gate — under heavy depth noise the TRUE pair-error norm can
        # exceed the clean-data threshold (config.retry_threshold_growth)
        rcfg = cfg.ransac if thr_scale == 1.0 else dataclasses.replace(
            cfg.ransac,
            inlier_threshold_euclidean=(
                cfg.ransac.inlier_threshold_euclidean * thr_scale),
            inlier_threshold_reprojection=(
                cfg.ransac.inlier_threshold_reprojection * thr_scale),
            inlier_threshold_mahalanobis=(
                cfg.ransac.inlier_threshold_mahalanobis * thr_scale))
        if cfg.matcher.max_mates > 1:
            # multi-mate band acceptance (matcher.cpp:734-747): every
            # landmark contributes up to max_mates candidate pairs and
            # RANSAC arbitrates — repetitive texture that aliases the
            # single best mate still yields the right correspondence
            L = state.map.capacity
            pr = fm.guided_match_pairs(cfg, state.map, pose_pred, feat,
                                       radius_scale=scale,
                                       hamming_slack=hamming_slack)
            p_s = feat.xyz[pr.feat_idx]                           # (P, 3)
            q_s = state.map.lm_pos[pr.lm_idx]
            info_s = _full_obs_info(
                cfg, feat.uv_undist[pr.feat_idx], p_s,
                None if obs_dirs is None else obs_dirs[pr.feat_idx])
            res_c = ransac_mod.estimate(
                rcfg, cfg.camera, key, p_s, q_s, pr.valid, info=info_s)
            inl = res_c.inliers & pr.valid
            inliers_L = jnp.zeros((L,), bool).at[pr.lm_idx].max(inl)
            # representative mate per landmark = best-distance inlier pair
            bestd = jnp.full((L,), jnp.inf).at[pr.lm_idx].min(
                jnp.where(inl, pr.dist, jnp.inf))
            rep = inl & (pr.dist == bestd[pr.lm_idx])
            fidx_L = jnp.full((L,), -1, jnp.int32).at[pr.lm_idx].max(
                jnp.where(rep, pr.feat_idx, -1))
            valid_L = jnp.zeros((L,), bool).at[pr.lm_idx].max(pr.valid)
            gm_s = fm.GuidedMatchResult(fidx_L, bestd, valid_L,
                                        pr.n_candidates)
            return gm_s, res_c._replace(inliers=inliers_L)
        gm_s = fm.guided_match(cfg, state.map, pose_pred, feat,
                               radius_scale=scale,
                               hamming_slack=hamming_slack)
        # compact the matched pairs to the feature capacity before RANSAC:
        # at most N features can be matched, so the (hypotheses × pairs)
        # error evaluations shrink L→N (16× at fr1 capacities)
        L = state.map.capacity
        N = feat.capacity
        sel = jnp.nonzero(gm_s.valid, size=N, fill_value=-1)[0]   # (N,)
        on = sel >= 0
        safe_lm_i = jnp.maximum(sel, 0)
        idx_s = jnp.clip(gm_s.feat_idx[safe_lm_i], 0, N - 1)
        p_s = feat.xyz[idx_s]                                     # (N, 3)
        q_s = state.map.lm_pos[safe_lm_i]                         # (N, 3)
        # useUncertainty: per-match sensor information feeds the Mahalanobis
        # error model (error_version=3) — None compiles the plain models
        info_s = _full_obs_info(
            cfg, feat.uv_undist[idx_s], p_s,
            None if obs_dirs is None else obs_dirs[idx_s])
        res_c = ransac_mod.estimate(
            rcfg, cfg.camera, key, p_s, q_s, on, info=info_s)
        # scatter the inlier verdicts back onto the landmark axis
        inliers_L = jnp.zeros((L,), bool).at[safe_lm_i].max(
            res_c.inliers & on)
        return gm_s, res_c._replace(inliers=inliers_L)

    gm, res_map = run_guided(1.0, k_map)
    first_pass_ratio = res_map.inlier_ratio
    scale = 1.0
    for attempt in range(cfg.matcher.retries):
        scale *= cfg.matcher.retry_radius_growth
        # degraded-frame recovery (round-4 finding, now automatic): each
        # widening also relaxes the Hamming gate — under heavy blur/dropout
        # the descriptor gate, not the optimizer, is the binding constraint
        slack = (attempt + 1) * cfg.matcher.retry_hamming_slack
        tscale = cfg.matcher.retry_threshold_growth ** (attempt + 1)
        key, k_retry = jax.random.split(key)
        need_retry = (~res_map.ok) | degraded | \
            (res_map.inlier_ratio < cfg.matcher.retry_inlier_ratio)

        def try_wider(k, _gm=gm, _res=res_map):
            # RESCUE-ONLY ladder: the widened-gate result replaces the
            # strict one only when the strict pass FAILED outright.
            # Inlier-count comparisons across different thresholds are
            # meaningless (wider gates inflate counts with junk — measured:
            # count-based adoption cost 2.3x in-loop ATE on the 30-frame
            # orbit; unconditional adoption collapsed the hard preset)
            gm2, res2 = run_guided(scale, k, hamming_slack=slack,
                                   thr_scale=tscale)
            better = res2.ok & ~_res.ok
            gm_out = jax.tree.map(
                lambda a, b: jnp.where(better, a, b), gm2, _gm)
            res_out = jax.tree.map(
                lambda a, b: jnp.where(better, a, b), res2, _res)
            return gm_out, res_out

        gm, res_map = jax.lax.cond(
            need_retry,
            try_wider,
            lambda _k, _gm=gm, _res=res_map: (_gm, _res),
            k_retry)
    p_cam = feat.xyz[jnp.clip(gm.feat_idx, 0, feat.capacity - 1)]
    # res_map.pose maps camera points to world = absolute pose of the frame.
    # Sanity gate: a confident-but-wrong pose from junk guided matches must
    # not displace the VO prediction (analog of the VO gate PUTSLAM.cpp:735).
    correction = jnp.linalg.norm(
        se3.translation(res_map.pose) - se3.translation(pose_pred))
    # drift-budget gate: a fixed gate deadlocks under degradation (every
    # fix rejected once VO drifts past it — measured 0.35 m ATE on hard vs
    # 0.035 m with the budget growth); grows per frame since the last
    # accepted correction, resets on acceptance
    corr_gate = jnp.minimum(
        cfg.max_map_correction
        + cfg.map_correction_growth
        * state.frames_since_map_ok.astype(jnp.float32),
        cfg.max_map_correction_cap)
    # corrections beyond the BASE gate need strong RANSAC evidence — a
    # weakly-supported large fix on a sparse/noisy map yanks the pose to
    # junk (measured: unconditional budget acceptance cost 2.3x in-loop
    # ATE on the 30-frame orbit while rescuing hard)
    strong = (res_map.inlier_ratio >= 0.3) &         (res_map.n_inliers >= 2 * cfg.ransac.minimal_num_matches)
    map_ok = res_map.ok & ((correction < cfg.max_map_correction)
                           | ((correction < corr_gate) & strong))
    pose_new = jnp.where(map_ok, res_map.pose, pose_pred)
    matched_lm = gm.valid & res_map.inliers & map_ok

    # ---- 3. keyframe decision (covisibility, featuresMap.cpp:292-333) ---
    covis = fm.covisibility_ratio(gm._replace(valid=matched_lm), state.map,
                                  state.map.n_kf - 1)
    n_matched = jnp.sum(matched_lm)
    is_kf = (
        (covis < cfg.map.covisibility_keyframe)
        | (n_matched < cfg.map.min_keyframe_matches)
    ) & (state.frames_since_kf >= cfg.map.min_frames_between_keyframes) \
        & (vo_res.ok | map_ok)  # never keyframe a fully-failed step

    # ---- 4. keyframe bookkeeping (lax.cond-gated: the map/graph update
    # machinery — slot allocation, descriptor-slot management, provisioning,
    # edge appends — only runs on keyframe steps; non-keyframe frames pass
    # the state through untouched, which on keyframe-sparse sequences is
    # most frames) ---------------------------------------------------------
    kf_seq_new = state.map.n_kf           # sequential number of the new kf
    kf_idx_new = jnp.mod(state.map.n_kf, state.map.kf_pose.shape[0])

    def do_bookkeeping(operand):
        m, g = operand
        m2, _ = fm.add_keyframe(cfg, m, pose_new, covis)
        m2 = fm.update_matched_landmarks(
            cfg, m2, pose_new, feat,
            gm._replace(valid=matched_lm), kf_seq_new)
        feat_matched_mask = jnp.zeros((feat.capacity,), bool).at[
            jnp.clip(gm.feat_idx, 0, feat.capacity - 1)].max(matched_lm)
        # provisioning policy (PUTSLAM.cpp:845-891): add features only when
        # the visible map or the measurement count is getting thin
        want_provision = (
            (gm.n_candidates < cfg.map.add_features_when_map_size_less_than)
            | (n_matched < cfg.map.add_features_when_measurements_less_than)
        ) & (jnp.sum(m2.lm_valid)
             < cfg.map.add_no_features_when_map_size_greater_than)
        m2 = fm.add_landmarks(cfg, m2, pose_new, feat,
                              feat_matched_mask | ~want_provision,
                              kf_seq_new)

        # pose-feature measurements (featuresMap addMeasurements analog):
        # the measurement is the observed 3D point in the camera frame.
        # Reclaim dead slots first (stale-generation edges from recycled
        # landmark/keyframe slots) so a wrapped store reuses them instead of
        # overwriting live active-window edges.
        g = graph_mod.reclaim_observation_slots(g, m2.lm_gen, m2.kf_gen)
        fidx_safe = jnp.clip(gm.feat_idx, 0, feat.capacity - 1)
        g = graph_mod.add_observations(
            g, jnp.full((m.capacity,), kf_idx_new, jnp.int32),
            jnp.arange(m.capacity, dtype=jnp.int32),
            p_cam,
            jnp.full((m.capacity,), _obs_info(cfg)),
            matched_lm,
            gen=m2.lm_gen,
            kf_gen=jnp.full((m.capacity,), m2.kf_gen[kf_idx_new], jnp.int32),
            info=_full_obs_info(
                cfg, feat.uv_undist[fidx_safe], p_cam,
                None if obs_dirs is None else obs_dirs[fidx_safe]))
        # pose-pose odometry edge between consecutive keyframes
        rel_kf = se3.relative(state.last_kf_pose, pose_new)
        add_pp = (n_matched < cfg.map.max_measurements_pose_to_pose) \
            if cfg.map.add_pose_to_pose_edges else jnp.asarray(False)
        prev_ring = jnp.mod(state.last_kf_idx, m.kf_pose.shape[0])
        g = graph_mod.add_pose_pose(
            g, prev_ring, kf_idx_new,
            rel_kf, jnp.float32(100.0), add_pp,
            gen_i=m2.kf_gen[prev_ring], gen_j=m2.kf_gen[kf_idx_new])
        return m2, g

    m, g = jax.lax.cond(is_kf, do_bookkeeping, lambda op: op,
                        (state.map, state.graph))

    # ---- 5. periodic bundle adjustment ----------------------------------
    n_kf = m.n_kf
    do_ba = is_kf & (jnp.mod(n_kf, cfg.backend.optimize_every_n_frames) == 0) \
        & (n_kf > 2)

    def run_ba(operand):
        m_in, g_in = operand
        # gauge: oldest in-window keyframe; plus freeze everything beyond
        # the active window (map compression, featuresMap.cpp:1056-1104).
        # The window is additionally clamped to the solver's compaction
        # capacity so the compact gather never overflows (older keyframes
        # would be silently frozen by the solver anyway).
        window = cfg.map.max_frames_window
        if 0 < cfg.backend.ba_window < cfg.map.max_keyframes:
            if cfg.backend.ba_window < window:
                import warnings
                warnings.warn(
                    f"backend.ba_window={cfg.backend.ba_window} clamps the "
                    f"configured map.max_frames_window={window}: keyframes "
                    f"beyond the solver's compaction capacity are frozen "
                    f"in-loop (the reference would keep maxFramesNo free). "
                    f"Raise backend.ba_window for full parity.",
                    stacklevel=2)
            window = min(window, cfg.backend.ba_window)
        fixed = fm.active_window_fixed(m_in, window)
        fixed = fixed.at[0].set(True)
        res = opt_mod.optimize_graph(
            cfg.backend, m_in.kf_pose, m_in.kf_valid,
            m_in.lm_pos, m_in.lm_valid, g_in, fixed,
            lm_gen=m_in.lm_gen, kf_gen=m_in.kf_gen, cam=cfg.camera)
        # chi²-outlier edge pruning (optimizeAndPrune, graph_g2o.cpp:1394)
        drop = res.obs_sq_err > cfg.backend.chi2_prune_threshold
        return res.kf_pose, res.lm_pos, res.chi2, drop

    def skip_ba(operand):
        m_in, g_in = operand
        return (m_in.kf_pose, m_in.lm_pos,
                jnp.zeros((cfg.backend.gn_iterations,), jnp.float32),
                jnp.zeros_like(g_in.obs_valid))

    # ---- 4b. loop closure (static flag: compiled out when disabled) ------
    kf_sig = state.kf_sig
    sig_valid = state.sig_valid
    lc_queue = state.lc_queue
    n_lc = state.n_lc_edges
    if cfg.loop_closure.enabled:
        key, k_lc = jax.random.split(key)
        vocab = bow.make_vocab(cfg.loop_closure.vocab_size)
        sig = bow.signature(vocab, feat.desc, feat.valid)
        # the slot this keyframe would recycle still holds the *evicted*
        # keyframe's signature — exclude it from scoring (and the idf
        # document statistics) rather than letting a stale document bias
        # the tf-idf weights
        scores = bow.score_against(kf_sig, sig,
                                   sig_valid.at[kf_idx_new].set(False))
        lc_queue2 = bow.push_candidates(
            lc_queue, kf_idx_new, scores, m.kf_seq, m.n_kf,
            cfg.loop_closure.tail_skip, cfg.loop_closure.min_probability)
        lc_queue = jax.tree.map(
            lambda a, b: jnp.where(is_kf, b, a), lc_queue, lc_queue2)
        kf_sig = kf_sig.at[kf_idx_new].set(
            jnp.where(is_kf, sig, kf_sig[kf_idx_new]))
        sig_valid = sig_valid.at[kf_idx_new].set(
            sig_valid[kf_idx_new] | is_kf)

        # pop + verify one candidate per frame (the PQ-pop contract of the
        # reference's LC verification thread, featuresMap.cpp:733-873)
        cand_a, cand_b, cand_p, lc_queue = bow.pop_best(lc_queue)
        have = jnp.isfinite(cand_p)

        def do_verify(operand):
            m_in, g_in, ka, kb, k = operand
            return lc_verify.verify_candidate(cfg, m_in, g_in, ka, kb, k)

        def no_verify(operand):
            return lc_verify.LCVerifyResult(
                jnp.asarray(False), se3.identity(),
                jnp.float32(0.0), jnp.int32(0))

        vres = jax.lax.cond(have, do_verify, no_verify,
                            (m, g, jnp.maximum(cand_a, 0),
                             jnp.maximum(cand_b, 0), k_lc))
        # accepted: pose-pose correction edge A→B with measured rel pose
        ca, cb = jnp.maximum(cand_a, 0), jnp.maximum(cand_b, 0)
        g = graph_mod.add_pose_pose(
            g, ca, cb, vres.rel_pose, jnp.float32(200.0), vres.ok,
            gen_i=m.kf_gen[ca], gen_j=m.kf_gen[cb])
        n_lc = n_lc + vres.ok.astype(jnp.int32)

    kf_pose_opt, lm_pos_opt, chi2, drop_obs = jax.lax.cond(
        do_ba, run_ba, skip_ba, (m, g))
    m = m._replace(kf_pose=kf_pose_opt, lm_pos=lm_pos_opt)
    g = graph_mod.prune_observations(g, drop_obs)
    # marginalize weak out-of-window landmarks on keyframe steps
    m_compressed = fm.compress_map(cfg, m, cfg.map.max_frames_window)
    m = m._replace(lm_valid=jnp.where(is_kf, m_compressed.lm_valid,
                                      m.lm_valid))

    # re-anchor the live pose on the (possibly moved) last keyframe:
    # pose = kf_new ∘ (kf_old⁻¹ ∘ pose)  (featuresMap.cpp:610-627 contract)
    kf_ring = jnp.where(is_kf, kf_idx_new, jnp.mod(state.last_kf_idx,
                                                   m.kf_pose.shape[0]))
    kf_pose_before = jnp.where(is_kf, pose_new, state.last_kf_pose)
    kf_pose_after = m.kf_pose[kf_ring]
    pose_out = se3.compose(kf_pose_after,
                           se3.compose(se3.inverse(kf_pose_before), pose_new))

    # ---- smoothed output trajectory (cfg.pose_blend_alpha) --------------
    # The absolute map-RANSAC pose re-draws its Kabsch noise every frame;
    # emitting it raw costs 2× RPE vs the reference's VO-smooth trajectory
    # (BASELINE.md r4). The output chain advances by the same VO increment
    # and the same BA/re-anchor correction as the internal pose, then pulls
    # toward the internal estimate at rate α — white noise is suppressed by
    # α while drift is tracked with a ~1/α-frame time constant; internal
    # logic (matching, keyframes, BA) uses the full-snap pose throughout.
    if playback or cfg.pose_blend_alpha >= 1.0:
        pose_smooth_out = pose_out
    else:
        smooth_pred = se3.compose(state.pose_smooth, vo_res.rel_pose)
        delta_s = se3.boxminus(pose_out, smooth_pred)
        mag = jnp.linalg.norm(delta_s[:3])
        alpha = jnp.where(mag > cfg.pose_blend_snap, 1.0,
                          jnp.float32(cfg.pose_blend_alpha))
        pose_smooth_out = se3.retract(smooth_pred, alpha * delta_s)

    # EKF measurement update with the accepted frame pose (correct,
    # decayingVelocityModel.cpp:43-121); a fully-failed frame keeps the
    # prediction so velocity coasts instead of being yanked to a junk pose
    ekf_new = ekf_pred
    if cfg.motion_model.enabled and not playback:
        accepted = vo_res.ok | map_ok
        ekf_corr = ekf_mod.correct(cfg.motion_model, ekf_pred, pose_out)
        ekf_new = jax.tree.map(
            lambda a, b: jnp.where(accepted, a, b), ekf_corr, ekf_pred)

    state_new = SlamState(
        map=m, graph=g, prev_feat=feat, pose=pose_out,
        pose_smooth=pose_smooth_out,
        last_kf_idx=jnp.where(is_kf, kf_idx_new, state.last_kf_idx),
        last_kf_pose=jnp.where(is_kf, kf_pose_after, state.last_kf_pose),
        frames_since_kf=jnp.where(is_kf, 0, state.frames_since_kf + 1),
        frame_idx=state.frame_idx + 1,
        key=key,
        kf_sig=kf_sig, sig_valid=sig_valid, lc_queue=lc_queue,
        n_lc_edges=n_lc,
        health=(cfg.matcher.degraded_ema_decay * state.health
                + (1.0 - cfg.matcher.degraded_ema_decay) * first_pass_ratio),
        frames_since_map_ok=jnp.where(
            map_ok, 0,
            jnp.where(res_map.ok, state.frames_since_map_ok + 1,
                      state.frames_since_map_ok)),
        ekf=ekf_new,
    )
    outs = SlamOutputs(
        pose=pose_smooth_out, vo_ok=vo_res.ok, map_ok=map_ok,
        n_map_matches=gm.n_candidates, n_map_inliers=n_matched.astype(jnp.int32),
        is_keyframe=is_kf, ba_ran=do_ba, chi2=chi2,
        n_landmarks=jnp.sum(m.lm_valid).astype(jnp.int32),
        anchor_ring=kf_ring.astype(jnp.int32),
        anchor_seq=m.kf_seq[kf_ring],
        anchor_pose=kf_pose_after,
    )
    return state_new, outs


@functools.partial(jax.jit, static_argnums=(0,))
def slam_sequence(cfg: SlamConfig, state: SlamState, grays, depths):
    """Run the full SLAM loop over stacked frames under one lax.scan."""

    def body(s, frame):
        return slam_step(cfg, s, frame[0], frame[1])

    return jax.lax.scan(body, state, (grays, depths))


@functools.partial(jax.jit, static_argnums=(0,))
def slam_sequence_playback(cfg: SlamConfig, state: SlamState, grays, depths,
                           gt_poses):
    """Playback (inverse-SLAM) scan: GT poses drive the map/backend."""

    def body(s, frame):
        return slam_step(cfg, s, frame[0], frame[1], frame[2], True)

    return jax.lax.scan(body, state, (grays, depths, gt_poses))


def run_playback(cfg: SlamConfig, grays, depths, gt_poses, seed: int = 0):
    """Host wrapper for the playback mode; returns (poses, outs, state)."""
    import numpy as np

    g = jnp.asarray(grays)
    d = jnp.asarray(depths)
    gt = jnp.asarray(gt_poses)
    state = slam_init(cfg, g[0], d[0], gt[0], seed)
    state, outs = slam_sequence_playback(cfg, state, g[1:], d[1:], gt[1:])
    poses = np.concatenate([np.asarray(gt[0])[None], np.asarray(outs.pose)],
                           axis=0)
    return poses, jax.tree.map(np.asarray, outs), state


def _to_device_float(cfg: SlamConfig, g, d):
    """Upload a frame block; integer wire formats (uint8 gray / uint16 depth
    — the exact on-disk PNG payloads) are cast to float on the DEVICE, so a
    long sequence ships at 1/4 the bytes through the host↔device link."""
    g = jnp.asarray(g)
    if g.dtype == jnp.uint8:
        g = g.astype(jnp.float32) / 255.0
    d = jnp.asarray(d)
    if d.dtype == jnp.uint16:
        d = d.astype(jnp.float32) / cfg.camera.depth_image_scale
    return g, d


def run_slam(cfg: SlamConfig, grays, depths, init_pose=None, seed: int = 0,
             chunk_size: int = 0, archive=None, timer=None):
    """Host wrapper: returns (poses (T,7) numpy, outputs, final_state).

    ``chunk_size`` > 0 streams the sequence through the jitted scan in
    fixed-size blocks (one compiled program; the tail block is padded with
    copies of the last frame and the padded steps trimmed from the outputs
    — static frames produce identity VO and no keyframes, so the map state
    is not perturbed). This is how full-length (≥600-frame) file-played
    sequences run without staging the whole image stack on the device.

    ``archive``: optional ``slam_map.archive.MapArchive`` absorbed at every
    chunk boundary (and at the end) — preserves ring-evicted history for
    the offline global bundle adjustment. Chunk size must keep per-chunk
    appends below the ring capacities (64-frame chunks comfortably do at
    the fr1 operating point).

    ``timer``: optional ``utils.timing.StageTimer``; each chunk's scan,
    from upload to the outputs on the host, is one ``slam_chunk`` sample
    (the first one includes compilation), with the chunk's real frames,
    padding excluded, as its item count."""
    import numpy as np

    from putslam_tpu.utils.timing import StageTimer

    timer = timer if timer is not None else StageTimer()
    T = len(grays)
    if not chunk_size or T - 1 <= chunk_size:
        g, d = _to_device_float(cfg, grays, depths)
        state = slam_init(cfg, g[0], d[0], init_pose, seed)
        state, outs = slam_sequence(cfg, state, g[1:], d[1:])
        poses = np.concatenate([
            np.asarray(init_pose if init_pose is not None
                       else se3.identity())[None],
            np.asarray(outs.pose)], axis=0)
        if archive is not None:
            archive.absorb(state)
        return poses, jax.tree.map(np.asarray, outs), state

    g0, d0 = _to_device_float(cfg, grays[0], depths[0])
    state = slam_init(cfg, g0, d0, init_pose, seed)
    outs_chunks = []
    for s in range(1, T, chunk_size):
        e = min(s + chunk_size, T)
        gc = np.asarray(grays[s:e])
        dc = np.asarray(depths[s:e])
        if e - s < chunk_size:
            pad = chunk_size - (e - s)
            gc = np.concatenate([gc, np.repeat(gc[-1:], pad, axis=0)])
            dc = np.concatenate([dc, np.repeat(dc[-1:], pad, axis=0)])
        with timer.stage("slam_chunk", items=e - s):
            gj, dj = _to_device_float(cfg, gc, dc)
            state, outs = slam_sequence(cfg, state, gj, dj)
            outs_chunks.append(jax.tree.map(np.asarray, outs))
        if archive is not None:
            archive.absorb(state)
    outs_all = jax.tree.map(lambda *xs: np.concatenate(xs)[:T - 1],
                            *outs_chunks)
    poses = np.concatenate([
        np.asarray(init_pose if init_pose is not None
                   else se3.identity())[None],
        outs_all.pose], axis=0)
    return poses, outs_all, state


# ---------------------------------------------------------------------------
# End-of-run final optimization (featuresMap.cpp:980-1025: on finish the
# reference releases the fixed vertices, removes weak features, prunes
# outlier edges, and runs one full-graph optimization before exporting).
# ---------------------------------------------------------------------------


def finalize_dist(cfg: SlamConfig, state: SlamState, mesh) -> SlamState:
    """ENGINE-INTEGRATED distributed finalize: the same release → BA →
    chi²-prune → BA contract as ``finalize`` (featuresMap.cpp:980-1025),
    with both Gauss-Newton solves executed by the landmark-sharded
    distributed Schur solver over ``mesh`` (parallel/dist_ba.py) — the
    scaling path for maps whose landmark store exceeds one device. Host
    wrapper (finalize runs at sequence end — a host sync point already).

    If the owner partition would drop edges (skewed landmark ownership),
    falls back to the single-device ``finalize`` for correctness."""
    import dataclasses
    import warnings

    from putslam_tpu.parallel import dist_ba

    m, g = state.map, state.graph
    bcfg = dataclasses.replace(cfg.backend,
                               gn_iterations=cfg.backend.final_gn_iterations,
                               ba_window=0)
    lm_valid = m.lm_valid & (m.lm_n_obs >= cfg.backend.final_min_obs)
    seqs = jnp.where(m.kf_valid, m.kf_seq, jnp.iinfo(jnp.int32).max)
    gauge = jnp.argmin(seqs)
    fixed = jnp.zeros_like(m.kf_valid).at[gauge].set(True)

    kf1, lm1, _, overflow = dist_ba.dist_gauss_newton(
        bcfg, mesh, m.kf_pose, m.kf_valid, m.lm_pos, lm_valid, g, fixed,
        m.lm_gen, m.kf_gen, cam=cfg.camera)
    if int(overflow) > 0:
        warnings.warn(
            f"dist finalize: owner partition dropped {int(overflow)} edges "
            f"(skewed landmark ownership) — falling back to the "
            f"single-device finalize.", stacklevel=2)
        return finalize(cfg, state)

    # chi²-outlier pruning on the polished estimate (optimizeAndPrune):
    # final per-edge errors from the production assembly path
    sq = _final_obs_errors(bcfg, kf1, lm1, lm_valid, g, m.lm_gen, m.kf_gen,
                           cam=cfg.camera)
    drop = sq > cfg.backend.chi2_prune_threshold
    g = graph_mod.prune_observations(g, drop)
    kf2, lm2, _, overflow2 = dist_ba.dist_gauss_newton(
        bcfg, mesh, kf1, m.kf_valid, lm1, lm_valid, g, fixed,
        m.lm_gen, m.kf_gen, cam=cfg.camera)
    if int(overflow2) > 0:
        warnings.warn("dist finalize second pass overflowed — single-device "
                      "fallback.", stacklevel=2)
        return finalize(cfg, state._replace(graph=g))

    m = m._replace(kf_pose=kf2, lm_pos=lm2, lm_valid=lm_valid)
    kf_repaired, _ = check_trajectory(cfg, m, g)
    m = m._replace(kf_pose=kf_repaired)
    return state._replace(map=m, graph=g)


@functools.partial(jax.jit, static_argnums=(0,), static_argnames=("cam",))
def _final_obs_errors(bcfg, kf_pose, lm_pos, lm_valid, g, lm_gen, kf_gen,
                      cam):
    """Final per-observation weighted squared errors (the prune signal the
    single-device BAResult carries as obs_sq_err)."""
    return opt_mod._final_sq_errors(
        bcfg, kf_pose, lm_pos, lm_valid, g, lm_gen, kf_gen, cam)


@functools.partial(jax.jit, static_argnums=(0,))
def finalize(cfg: SlamConfig, state: SlamState) -> SlamState:
    """Full-graph polish: release the window-fixed keyframes (only the oldest
    surviving keyframe stays fixed for gauge), drop weak landmarks
    (``removeWeakFeatures`` analog: observation count below
    ``final_min_obs``), run a long robust BA, chi²-prune outlier edges, and
    run a second BA on the cleaned graph."""
    import dataclasses

    m, g = state.map, state.graph
    # full-graph pass: every keyframe is free, so the active-window
    # compaction must be off (ba_window=0 → full-K camera system)
    bcfg = dataclasses.replace(cfg.backend,
                               gn_iterations=cfg.backend.final_gn_iterations,
                               ba_window=0)

    # removeWeakFeatures (graph_g2o.cpp:1440): landmarks observed fewer than
    # final_min_obs times carry no triangulation redundancy — drop them
    lm_valid = m.lm_valid & (m.lm_n_obs >= cfg.backend.final_min_obs)

    # release fixed vertices (restoreFrames, featuresMap.cpp:1624-1643):
    # gauge = the oldest valid keyframe only
    seqs = jnp.where(m.kf_valid, m.kf_seq, jnp.iinfo(jnp.int32).max)
    gauge = jnp.argmin(seqs)
    fixed = jnp.zeros_like(m.kf_valid).at[gauge].set(True)

    res1 = opt_mod.optimize_graph(
        bcfg, m.kf_pose, m.kf_valid, m.lm_pos, lm_valid, g, fixed,
        lm_gen=m.lm_gen, kf_gen=m.kf_gen, cam=cfg.camera)
    # chi²-outlier pruning on the polished estimate (optimizeAndPrune)
    drop = res1.obs_sq_err > cfg.backend.chi2_prune_threshold
    g = graph_mod.prune_observations(g, drop)
    res2 = opt_mod.optimize_graph(
        bcfg, res1.kf_pose, m.kf_valid, res1.lm_pos, lm_valid, g, fixed,
        lm_gen=m.lm_gen, kf_gen=m.kf_gen, cam=cfg.camera)

    m = m._replace(kf_pose=res2.kf_pose, lm_pos=res2.lm_pos,
                   lm_valid=lm_valid)
    # trajectory sanity repair on the polished keyframes (cleanCamTrajectory)
    kf_repaired, _ = check_trajectory(cfg, m, g)
    m = m._replace(kf_pose=kf_repaired)
    return state._replace(map=m, graph=g)


@functools.partial(jax.jit, static_argnums=(0,))
def check_trajectory(cfg: SlamConfig, m: fm.MapState,
                     g: graph_mod.GraphState):
    """Trajectory sanity repair (``checkTrajectory``/``cleanCamTrajectory``,
    graph_g2o.cpp:1026-1080, featuresMap.cpp:1224-1270): walk the keyframes
    in sequence order; wherever the optimized relative motion to the
    previous keyframe contradicts the stored odometry edge by more than
    ``trajectory_repair_threshold`` metres, re-compose that keyframe from
    odometry instead — a diverged BA segment is replaced by dead reckoning,
    and everything downstream shifts rigidly with it.

    Returns (kf_pose', n_repaired)."""
    K = m.kf_pose.shape[0]
    thr = cfg.backend.trajectory_repair_threshold
    if thr <= 0:
        return m.kf_pose, jnp.int32(0)

    # odometry edges between seq-consecutive keyframes, keyed by successor.
    # Non-odometry rows scatter into a sacrificial row K that is dropped —
    # routing them to a real slot would race genuine writes there (XLA
    # duplicate-index set has an unspecified winner). When several valid
    # odometry edges share a successor (same consecutive pair re-appended),
    # only the *newest* by ring append order writes: slot age relative to
    # the write cursor is a bijection over slots, so the min-age winner per
    # successor is unique and the duplicate-index set never races.
    E = g.pp_capacity
    is_odo = (g.pp_valid
              & (m.kf_seq[g.pp_j] == m.kf_seq[g.pp_i] + 1)
              & (g.pp_gen_i == m.kf_gen[g.pp_i])
              & (g.pp_gen_j == m.kf_gen[g.pp_j]))
    age = jnp.mod(g.n_pp - 1 - jnp.arange(E, dtype=jnp.int32), E)
    key_j = jnp.where(is_odo, g.pp_j, K)
    best_age = jnp.full((K + 1,), E, jnp.int32).at[key_j].min(
        jnp.where(is_odo, age, E))
    winner = is_odo & (age == best_age[key_j])
    safe_j = jnp.where(winner, g.pp_j, K)
    odo_rel = jnp.tile(se3.identity(), (K + 1, 1))
    odo_rel = odo_rel.at[safe_j].set(g.pp_rel)[:K]
    has_odo = jnp.zeros((K + 1,), bool).at[safe_j].max(winner)[:K]

    order = jnp.argsort(jnp.where(m.kf_valid, m.kf_seq,
                                  jnp.iinfo(jnp.int32).max))

    def body(carry, idx):
        prev_corr, prev_opt, started = carry
        T_opt = m.kf_pose[idx]
        valid = m.kf_valid[idx]
        rel_opt = se3.relative(prev_opt, T_opt)
        bad = valid & started & has_odo[idx] & (jnp.linalg.norm(
            se3.translation(rel_opt) - se3.translation(odo_rel[idx])) > thr)
        rel_use = jnp.where(bad, odo_rel[idx], rel_opt)
        T_corr = se3.compose(prev_corr, rel_use)
        first = valid & ~started
        T_corr = jnp.where(first, T_opt, T_corr)
        carry = (jnp.where(valid, T_corr, prev_corr),
                 jnp.where(valid, T_opt, prev_opt),
                 started | valid)
        return carry, (T_corr, bad)

    init = (se3.identity(), se3.identity(), jnp.asarray(False))
    _, (corr, bad) = jax.lax.scan(body, init, order)
    kf_pose = m.kf_pose.at[order].set(
        jnp.where(m.kf_valid[order][:, None], corr, m.kf_pose[order]))
    return kf_pose, jnp.sum(bad).astype(jnp.int32)


def reanchor_trajectory(state: SlamState, outs: SlamOutputs):
    """Rebuild the per-frame trajectory from the final optimized keyframes
    (updateCamTrajectory, featuresMap.cpp:1273-1295): each frame's pose was
    emitted as anchor_kf ∘ suffix; replay the suffix on the *optimized*
    anchor pose. Frames whose anchor slot was recycled since (generation
    mismatch via kf_seq) keep their original pose. Returns (T, 7)."""
    ring = outs.anchor_ring                                    # (T,)
    kf_now = state.map.kf_pose[ring]                           # (T, 7)
    still_same = state.map.kf_seq[ring] == outs.anchor_seq     # (T,)
    suffix = se3.compose(se3.inverse(outs.anchor_pose), outs.pose)
    corrected = se3.compose(kf_now, suffix)
    return jnp.where(still_same[:, None], corrected, outs.pose)


def run_slam_global(cfg: SlamConfig, grays, depths, init_pose=None,
                    seed: int = 0, chunk_size: int = 64, timer=None,
                    **gba_kw):
    """run_slam + host map archive + OFFLINE GLOBAL bundle adjustment over
    the full archived graph (the reference's end-of-run restoreFrames +
    full optimization, featuresMap.cpp:980-1025 — but over ALL history,
    surviving device-ring evictions on long sequences).

    Returns (poses_before (T,7), poses_after (T,7), outputs, final_state,
    archive)."""
    import numpy as np

    from putslam_tpu.slam_map.archive import MapArchive, global_bundle_adjust

    archive = MapArchive()
    poses_before, outs, state = run_slam(cfg, grays, depths, init_pose, seed,
                                         chunk_size=chunk_size,
                                         archive=archive, timer=timer)
    kf_polished = global_bundle_adjust(cfg, archive, **gba_kw)
    # rebuild the per-frame trajectory on the polished keyframes:
    # pose = polished(anchor_seq) ∘ (anchor_pose⁻¹ ∘ pose)
    seqs = np.asarray(outs.anchor_seq)
    good = (seqs >= 0) & (seqs < len(kf_polished))
    kf_new = jnp.asarray(kf_polished[np.clip(seqs, 0,
                                             max(len(kf_polished) - 1, 0))])
    suffix = se3.compose(se3.inverse(jnp.asarray(outs.anchor_pose)),
                         jnp.asarray(outs.pose))
    corrected = np.asarray(se3.compose(kf_new, suffix))
    poses_after = np.where(good[:, None], corrected, np.asarray(outs.pose))
    poses_after = np.concatenate([poses_before[:1], poses_after], axis=0)
    return poses_before, poses_after, outs, state, archive


def run_slam_final(cfg: SlamConfig, grays, depths, init_pose=None,
                   seed: int = 0, chunk_size: int = 0, timer=None):
    """run_slam + end-of-run final optimization + trajectory repair.

    Returns (poses_before (T,7), poses_after (T,7), outputs, final_state) —
    the before/after pair is what the reference's VOAte-vs-g2oAte comparison
    measures (PUTSLAM.cpp:1222-1233)."""
    import numpy as np

    poses_before, outs, state = run_slam(cfg, grays, depths, init_pose, seed,
                                         chunk_size=chunk_size, timer=timer)
    state = finalize(cfg, state)
    first = poses_before[:1]
    poses_after = np.concatenate(
        [first, np.asarray(reanchor_trajectory(
            state, jax.tree.map(jnp.asarray, outs)))], axis=0)
    return poses_before, poses_after, outs, state
