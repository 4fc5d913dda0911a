"""Geometric verification of loop-closure candidates.

Batched replacement for the reference's LC verification thread
(reference: src/Map/featuresMap.cpp:733-873 ``loopClosure`` — gather
MapFeatures observed in both frames (> minNumberOfFeaturesLC = 35),
descriptor matching via ``matchFeatureLoopClosure`` matcher.cpp:802-861,
RANSAC, acceptance when matching ratio > matchingRatioThresholdLC = 0.4,
then measurement merge).

Fixed-shape version: each keyframe's observation set is gathered from the
edge store (bounded to LC_SET), descriptors matched with one matmul,
and the relative transform estimated by the hypothesis-parallel RANSAC on
the *camera-frame measured points* of both keyframes — independent of the
drifted world positions, exactly what the correction edge must encode.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from putslam_tpu.backend.graph import GraphState
from putslam_tpu.config import SlamConfig
from putslam_tpu.frontend import ransac as ransac_mod
from putslam_tpu.geometry import se3
from putslam_tpu.ops import matching
from putslam_tpu.slam_map.features_map import MapState

LC_SET = 128  # max landmarks gathered per keyframe for verification


class LCVerifyResult(NamedTuple):
    ok: jnp.ndarray        # () bool — candidate geometrically confirmed
    rel_pose: jnp.ndarray  # (7,) T with z_a ≈ T · z_b  (edge A→B measurement)
    ratio: jnp.ndarray     # () float32 — matched fraction (gate: > 0.4)
    n_inliers: jnp.ndarray # () int32


def _gather_kf_set(m: MapState, g: GraphState, kf: jnp.ndarray):
    """Landmark observations of one keyframe from the edge store:
    (lm_idx (P,), z_cam (P,3), desc (P,256), valid (P,)).

    Descriptor selection is *view-aware* (matchFeatureLoopClosure matches the
    frame-specific descriptors of the candidate frames, matcher.cpp:802-861;
    findNearestFrame picks the nearest-view descriptor featuresMap.cpp:528-563):
    of the landmark's multi-view slots, the one whose stored viewing direction
    best matches the direction from *this* keyframe's camera to the landmark
    is used — a revisit from a new viewpoint gets that view's descriptor, not
    an arbitrary slot."""
    sel = (g.obs_kf == kf) & g.obs_valid & \
        (g.obs_gen == m.lm_gen[g.obs_lm]) & m.lm_valid[g.obs_lm] & \
        (g.obs_kfgen == m.kf_gen[kf])
    idx = jnp.nonzero(sel, size=LC_SET, fill_value=-1)[0]
    ok = idx >= 0
    safe = jnp.maximum(idx, 0)
    lm = g.obs_lm[safe]
    z = g.obs_xyz[safe]
    # viewing direction keyframe→landmark in the world frame
    cam_t = se3.translation(m.kf_pose[kf])                       # (3,)
    vd = m.lm_pos[lm] - cam_t[None, :]
    vd = vd / jnp.maximum(jnp.linalg.norm(vd, axis=-1, keepdims=True), 1e-9)
    cosang = jnp.einsum("pdk,pk->pd", m.lm_view_dir[lm], vd)     # (P, D)
    cosang = jnp.where(m.lm_slot_used[lm], cosang, -jnp.inf)
    slot = jnp.argmax(cosang, axis=-1)                           # (P,)
    desc = m.lm_desc[lm, slot]
    return lm, z, jnp.where(ok[:, None], desc, jnp.int8(0)), ok


@functools.partial(jax.jit, static_argnums=(0,))
def verify_candidate(cfg: SlamConfig, m: MapState, g: GraphState,
                     kf_a: jnp.ndarray, kf_b: jnp.ndarray,
                     key: jax.Array) -> LCVerifyResult:
    """Check candidate pair (kf_a ↔ kf_b) and estimate the correction edge."""
    lc = cfg.loop_closure
    lm_a, z_a, d_a, ok_a = _gather_kf_set(m, g, kf_a)
    lm_b, z_b, d_b, ok_b = _gather_kf_set(m, g, kf_b)

    dist = matching.hamming_matrix(d_a, d_b, ok_a, ok_b)
    mm = matching.mutual_nn(dist, cfg.matcher.max_hamming)
    pair_valid = mm.valid & ok_a & ok_b[mm.idx_b]

    # T: z_a ≈ T · z_b  → relative pose of B's camera in A's frame
    p = z_b[mm.idx_b]
    res = ransac_mod.estimate(cfg.ransac, cfg.camera, key, p, z_a, pair_valid)

    n_a = jnp.sum(ok_a)
    n_b = jnp.sum(ok_b)
    enough = (n_a >= lc.min_features_lc) & (n_b >= lc.min_features_lc)
    ratio = res.n_inliers / jnp.maximum(jnp.minimum(n_a, n_b), 1)
    ok = enough & res.ok & (ratio > lc.matching_ratio_threshold)
    return LCVerifyResult(ok, res.pose, ratio.astype(jnp.float32),
                          res.n_inliers)
