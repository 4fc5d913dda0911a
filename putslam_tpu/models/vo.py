"""Frame-to-frame visual odometry — the minimum end-to-end SLAM slice.

Batched replacement for the reference's matching-based VO
(reference: src/Matcher/matcher.cpp:67-94 ``runVO`` dispatch and :452-516
``match``: detect → describe → BF cross-check match → lift to 3D → RANSAC;
driver loop src/PUTSLAM/PUTSLAM.cpp:677-930 with the 0.1 m translation
sanity gate :735-737 and TUM trajectory output :1006-1016. This is the
``onlyVO=1`` operating mode of the reference.)

The whole per-frame step — detection, description, Hamming matmul matching,
1024-hypothesis RANSAC — is one jitted function; a full sequence runs under
``lax.scan`` so the device never returns to the host between frames.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from putslam_tpu.config import SlamConfig
from putslam_tpu.frontend import ransac as ransac_mod
from putslam_tpu.frontend.detector import Features, detect_and_describe
from putslam_tpu.geometry import camera as camera_mod
from putslam_tpu.geometry import se3
from putslam_tpu.ops import matching


class VOStepResult(NamedTuple):
    rel_pose: jnp.ndarray      # (7,) T with x_prev ≈ T · x_curr
    n_matches: jnp.ndarray     # () int32 — valid cross-checked matches
    n_inliers: jnp.ndarray     # () int32 — RANSAC inliers
    inlier_ratio: jnp.ndarray  # () float32
    ok: jnp.ndarray            # () bool — RANSAC accepted (no identity fallback)


@functools.partial(jax.jit, static_argnums=(0,))
def vo_step(cfg: SlamConfig, key: jax.Array, prev: Features, curr: Features,
            force_retry=False) -> VOStepResult:
    """Relative pose of the current frame w.r.t. the previous one.

    Correspondences: cross-checked Hamming matches (prev_i ↔ curr_j) with
    both endpoints depth-valid; estimate T minimizing ‖T·xyz_curr − xyz_prev‖
    (so new_pose = prev_pose ∘ T)."""
    dist = matching.hamming_matrix(prev.desc, curr.desc, prev.valid, curr.valid)

    def match_and_estimate(k, max_hamming, rcfg):
        m = matching.mutual_nn(dist, max_hamming)
        p = curr.xyz[m.idx_b]             # points in current frame
        q = prev.xyz                      # corresponding points in prev frame
        valid = m.valid & prev.has_depth & curr.has_depth[m.idx_b]
        res = ransac_mod.estimate(rcfg, cfg.camera, k, p, q, valid)
        return jnp.sum(valid).astype(jnp.int32), res

    # split only when the rescue branch is compiled in — keeps the RNG
    # stream identical to the no-rescue configuration otherwise
    if cfg.matcher.retry_hamming_slack > 0:
        key, k2 = jax.random.split(key)
    n_matches, res = match_and_estimate(key, cfg.matcher.max_hamming,
                                        cfg.ransac)

    # degraded-frame recovery (mirrors the map-matching retry ladder,
    # PUTSLAM.cpp:791-798 contract): a failed or starved VO match re-runs
    # once with a relaxed Hamming gate — lax.cond, so the second RANSAC is
    # only paid on degraded frames; clean sequences never take the branch
    if cfg.matcher.retry_hamming_slack > 0:
        import dataclasses as _dc

        g = cfg.matcher.retry_threshold_growth
        rcfg2 = _dc.replace(
            cfg.ransac,
            inlier_threshold_euclidean=cfg.ransac.inlier_threshold_euclidean
            * g,
            inlier_threshold_reprojection=(
                cfg.ransac.inlier_threshold_reprojection * g),
            inlier_threshold_mahalanobis=(
                cfg.ransac.inlier_threshold_mahalanobis * g))
        starved = (~res.ok) | jnp.asarray(force_retry) | \
            (res.inlier_ratio < cfg.matcher.retry_inlier_ratio)

        def try_wider(k, _n=n_matches, _r=res):
            # rescue-only: adopt the widened-gate retry only when the
            # strict pass failed outright (see the ladder note in slam.py)
            n2, r2 = match_and_estimate(
                k, cfg.matcher.max_hamming + cfg.matcher.retry_hamming_slack,
                rcfg2)
            better = r2.ok & ~_r.ok
            return (jnp.where(better, n2, _n),
                    jax.tree.map(lambda a, b: jnp.where(better, a, b),
                                 r2, _r))

        n_matches, res = jax.lax.cond(
            starved,
            try_wider,
            lambda _k, _n=n_matches, _r=res: (_n, _r),
            k2)

    # VO increment sanity gate (PUTSLAM.cpp:735-737): implausible jumps → identity
    too_far = jnp.linalg.norm(se3.translation(res.pose)) > cfg.max_vo_translation
    rel = jnp.where(too_far, se3.identity(dtype=res.pose.dtype), res.pose)
    ok = res.ok & ~too_far
    return VOStepResult(rel, n_matches,
                        res.n_inliers, res.inlier_ratio, ok)


DETECT_CHUNK = 4  # frames detected per vmapped map step (bounds the live
                  # device memory of a batched detection)


@functools.partial(jax.jit, static_argnums=(0,))
def detect_sequence(cfg: SlamConfig, grays: jnp.ndarray, depths: jnp.ndarray
                    ) -> Features:
    """Detect + describe every frame of a stacked (T, H, W) sequence.

    Per-frame detection has no cross-frame dependency, so it runs *batched*
    (vmap over DETECT_CHUNK-frame blocks under ``lax.map``) instead of the
    reference's one-frame-at-a-time loop."""
    return jax.lax.map(
        lambda fr: detect_and_describe(cfg, fr[0], fr[1]),
        (grays, depths), batch_size=min(DETECT_CHUNK, grays.shape[0]))


@functools.partial(jax.jit, static_argnums=(0,))
def vo_sequence(cfg: SlamConfig, grays: jnp.ndarray, depths: jnp.ndarray,
                key: jax.Array, init_pose=None
                ) -> Tuple[jnp.ndarray, VOStepResult]:
    """Run VO over a whole stacked sequence, frame-parallel.

    grays/depths: (T, H, W). Returns (poses (T, 7) world←camera, per-step
    stats stacked over T−1 steps). The first pose is ``init_pose`` (default
    identity — the reference takes it from the dataset's initialPosition,
    fileGrabber.cpp:223-237).

    Structure: the only *inherently sequential* part of
    frame-to-frame VO is composing the relative poses — an associative
    product. Everything else (detection, matching, RANSAC between
    consecutive pairs) is independent per frame pair, so it runs as one
    batched computation, and the pose chain is a ``lax.associative_scan``
    (log-depth) instead of the reference's serial frame loop
    (PUTSLAM.cpp:687-922)."""
    if init_pose is None:
        init_pose = se3.identity(dtype=grays.dtype)
    T = grays.shape[0]
    feats = detect_sequence(cfg, grays, depths)
    prev = jax.tree.map(lambda x: x[:-1], feats)
    curr = jax.tree.map(lambda x: x[1:], feats)
    keys = jax.random.split(key, T - 1)
    stats = jax.vmap(lambda k, a, b: vo_step(cfg, k, a, b))(keys, prev, curr)

    chain = jnp.concatenate([init_pose[None], stats.rel_pose], axis=0)
    all_poses = jax.lax.associative_scan(se3.compose, chain)
    # renormalize quaternions (compose does not; drift is O(T·eps))
    all_poses = se3.make_pose(se3.translation(all_poses),
                              se3.quat_normalize(se3.rotation_quat(all_poses)))
    return all_poses, stats


# ---------------------------------------------------------------------------
# Tracking-mode VO (VOVersion=1): pyramidal KLT instead of detect+match
# (reference: matcher.cpp:133-449 ``trackKLT`` — track, RANSAC, refill
# features when fewer than minimalTrackedFeatures survive :214-279).
# ---------------------------------------------------------------------------


class TrackState(NamedTuple):
    uv: jnp.ndarray      # (N, 2) tracked feature positions in ``gray``
    xyz: jnp.ndarray     # (N, 3) camera-frame 3D (at detection frame's depth)
    valid: jnp.ndarray   # (N,) bool
    gray: jnp.ndarray    # (H, W) previous frame image


def _detect_for_tracking(cfg: SlamConfig, gray, depth):
    from putslam_tpu.ops import fast as fast_mod

    det = cfg.detector
    uv, resp, valid = fast_mod.detect(
        gray, det.fast_threshold, det.nms_radius,
        det.grid_rows, det.grid_cols, det.max_features,
        grid_policy=det.grid_policy)
    z = camera_mod.sample_depth(depth, uv)
    uv_und = camera_mod.undistort_pixels(cfg.camera, uv)
    xyz = camera_mod.unproject(cfg.camera, uv_und, z)
    valid = valid & camera_mod.depth_valid_mask(cfg.camera, z)
    return uv, xyz, valid


def init_tracking(cfg: SlamConfig, gray, depth) -> TrackState:
    gray = jnp.asarray(gray)
    uv, xyz, valid = _detect_for_tracking(cfg, gray, jnp.asarray(depth))
    return TrackState(uv, xyz, valid, gray)


@functools.partial(jax.jit, static_argnums=(0,))
def vo_step_tracking(cfg: SlamConfig, key: jax.Array, ts: TrackState,
                     gray, depth) -> Tuple[TrackState, VOStepResult]:
    from putslam_tpu.ops import klt

    tr = klt.track(cfg.tracker, ts.gray, gray, ts.uv, ts.valid)
    if cfg.tracker.patch_refine:
        # patch-alignment polish (MatchingOnPatches optimizeLocation): one
        # single-level GN pass with a widened window on the pyramid result
        import dataclasses as _dc

        wide = _dc.replace(cfg.tracker, win_size=cfg.tracker.patch_refine_win)
        tr2 = klt.refine_patch_alignment(wide, ts.gray, gray, ts.uv, tr.pts,
                                         tr.valid)
        # keep the pyramid result wherever the polish diverged
        tr = tr._replace(pts=jnp.where(tr2.valid[:, None], tr2.pts, tr.pts))
    z = camera_mod.sample_depth(depth, tr.pts)
    uv_und = camera_mod.undistort_pixels(cfg.camera, tr.pts)
    xyz_new = camera_mod.unproject(cfg.camera, uv_und, z)
    valid = tr.valid & camera_mod.depth_valid_mask(cfg.camera, z)

    # T: xyz_prev ≈ T · xyz_new (same convention as matching VO)
    res = ransac_mod.estimate(cfg.ransac, cfg.camera, key, xyz_new, ts.xyz,
                              valid)
    too_far = jnp.linalg.norm(se3.translation(res.pose)) > cfg.max_vo_translation
    rel = jnp.where(too_far, se3.identity(dtype=res.pose.dtype), res.pose)
    ok = res.ok & ~too_far

    # refill lost tracks when below the minimum (matcher.cpp:214-279)
    n_tracked = jnp.sum(valid)
    need = n_tracked < cfg.tracker.min_tracked_features
    uv_d, xyz_d, v_d = _detect_for_tracking(cfg, gray, depth)
    # don't duplicate surviving tracks: drop detections within the NMS radius
    d2 = jnp.sum((uv_d[:, None, :] - tr.pts[None, :, :]) ** 2, axis=-1)
    near = jnp.any((d2 < float(cfg.detector.nms_radius * 2) ** 2)
                   & valid[None, :], axis=1)
    want = v_d & ~near & need
    free_idx = jnp.nonzero(~valid, size=uv_d.shape[0], fill_value=-1)[0]
    cand_idx = jnp.nonzero(want, size=uv_d.shape[0], fill_value=-1)[0]
    okm = (free_idx >= 0) & (cand_idx >= 0)
    fslot = jnp.maximum(free_idx, 0)
    cidx = jnp.maximum(cand_idx, 0)
    uv_out = tr.pts.at[fslot].set(
        jnp.where(okm[:, None], uv_d[cidx], tr.pts[fslot]))
    xyz_out = xyz_new.at[fslot].set(
        jnp.where(okm[:, None], xyz_d[cidx], xyz_new[fslot]))
    valid_out = valid.at[fslot].set(jnp.where(okm, True, valid[fslot]))

    ts_new = TrackState(uv_out, xyz_out, valid_out, gray)
    return ts_new, VOStepResult(rel, n_tracked.astype(jnp.int32),
                                res.n_inliers, res.inlier_ratio, ok)


@functools.partial(jax.jit, static_argnums=(0,))
def vo_sequence_tracking(cfg: SlamConfig, grays, depths, key, init_pose=None):
    if init_pose is None:
        init_pose = se3.identity(dtype=grays.dtype)
    ts0 = init_tracking(cfg, grays[0], depths[0])

    def step(carry, frame):
        ts, pose, k = carry
        k, sub = jax.random.split(k)
        ts, res = vo_step_tracking(cfg, sub, ts, frame[0], frame[1])
        pose_new = se3.compose(pose, res.rel_pose)
        return (ts, pose_new, k), (pose_new, res)

    (_, _, _), (poses, stats) = jax.lax.scan(
        step, (ts0, init_pose, key), (grays[1:], depths[1:]))
    return jnp.concatenate([init_pose[None], poses], axis=0), stats


def run_vo(cfg: SlamConfig, grays, depths, seed: int = 0, init_pose=None):
    """Host-facing wrapper: numpy in, numpy out. Dispatches on
    cfg.vo_version (0 = matching, 1 = KLT tracking — the VOVersion switch,
    matcher.cpp:67-94)."""
    import numpy as np

    key = jax.random.PRNGKey(seed)
    g = jnp.asarray(grays)
    d = jnp.asarray(depths)
    ip = None if init_pose is None else jnp.asarray(init_pose)
    if cfg.vo_version == 1:
        poses, stats = vo_sequence_tracking(cfg, g, d, key, ip)
    else:
        poses, stats = vo_sequence(cfg, g, d, key, ip)
    return np.asarray(poses), jax.tree.map(np.asarray, stats)
