"""Fixed-capacity global feature map with keyframes and covisibility.

Batched replacement for the reference's ``FeaturesMap``
(reference: src/Map/featuresMap.cpp — feature store ``map<int,MapFeature>``
with ids from 100000 featuresMap.h:23; camera trajectory + keyframe decision
by covisibility :292-333; covisibility ``WeightedGraph``
src/PoseGraph/weightedGraph.h:30-97; multi-descriptor management with 30°
view-angle gating :1172-1213; feature ``lifeValue`` aging :474-516; the
triple-buffered thread views are unnecessary here — the map is a pure value
threaded through the jitted SLAM step).

Everything is a fixed-capacity array + mask: landmarks never move in memory;
allocation scatters into invalid slots; deletion just clears the mask.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from putslam_tpu.config import SlamConfig
from putslam_tpu.frontend.detector import Features
from putslam_tpu.geometry import se3

DESC_BITS = 256


class MapState(NamedTuple):
    """The SLAM map: landmarks + keyframes + covisibility."""

    # --- landmarks -------------------------------------------------------
    lm_pos: jnp.ndarray        # (L, 3) world positions
    lm_desc: jnp.ndarray       # (L, D, 256) int8 ±1 multi-view descriptors
    lm_view_dir: jnp.ndarray   # (L, D, 3) unit camera→landmark dir per slot (world)
    lm_slot_used: jnp.ndarray  # (L, D) bool
    lm_octave: jnp.ndarray     # (L,) int32 octave at first detection
    lm_life: jnp.ndarray       # (L,) float32 lifeValue
    lm_n_obs: jnp.ndarray      # (L,) int32 measurement count
    lm_last_kf: jnp.ndarray    # (L,) int32 last keyframe that observed it
    lm_valid: jnp.ndarray      # (L,) bool
    lm_gen: jnp.ndarray        # (L,) int32 slot generation — bumped on reuse so
                               # stale graph observations of a recycled slot
                               # can be detected (no pointer-lifetime bugs)
    # --- keyframes -------------------------------------------------------
    kf_pose: jnp.ndarray       # (K, 7) camera→world
    kf_valid: jnp.ndarray      # (K,) bool
    kf_seq: jnp.ndarray        # (K,) int32 sequential keyframe number per slot
    kf_gen: jnp.ndarray        # (K,) int32 slot generation — bumped on ring
                               # reuse so graph edges referencing the old
                               # occupant are masked out of BA (the keyframe
                               # analog of lm_gen)
    n_kf: jnp.ndarray          # () int32 — total keyframes ever created
    covis: jnp.ndarray         # (K, K) float32 covisibility weights

    @property
    def capacity(self) -> int:
        return self.lm_pos.shape[0]


def init_map(cfg: SlamConfig, dtype=jnp.float32) -> MapState:
    L = cfg.map.max_landmarks
    D = cfg.map.descriptor_views
    K = cfg.map.max_keyframes
    return MapState(
        lm_pos=jnp.zeros((L, 3), dtype),
        lm_desc=jnp.zeros((L, D, DESC_BITS), jnp.int8),
        lm_view_dir=jnp.zeros((L, D, 3), dtype),
        lm_slot_used=jnp.zeros((L, D), bool),
        lm_octave=jnp.zeros((L,), jnp.int32),
        lm_life=jnp.zeros((L,), dtype),
        lm_n_obs=jnp.zeros((L,), jnp.int32),
        lm_last_kf=jnp.full((L,), -1, jnp.int32),
        lm_valid=jnp.zeros((L,), bool),
        lm_gen=jnp.zeros((L,), jnp.int32),
        kf_pose=jnp.tile(se3.identity(dtype=dtype), (K, 1)),
        kf_valid=jnp.zeros((K,), bool),
        kf_seq=jnp.full((K,), -1, jnp.int32),
        kf_gen=jnp.zeros((K,), jnp.int32),
        n_kf=jnp.int32(0),
        covis=jnp.zeros((K, K), dtype),
    )


class GuidedMatchResult(NamedTuple):
    """matchXYZ output: per-landmark correspondence into the current frame."""

    feat_idx: jnp.ndarray    # (L,) int32 — matched frame-feature index
    dist: jnp.ndarray        # (L,) float32 — descriptor distance
    valid: jnp.ndarray       # (L,) bool — gated + accepted
    n_candidates: jnp.ndarray  # () int32 — landmarks that had any candidate


def _guided_distances(cfg: SlamConfig, m: MapState, pose_guess: jnp.ndarray,
                      feat: Features, radius_scale: float) -> jnp.ndarray:
    """The (L, N) gated descriptor-distance matrix shared by the
    best-per-landmark and multi-mate guided matchers: 3D sphere gate +
    octave ±window gate + multi-view-slot Hamming via one matmul
    (matcher.cpp:606-798 semantics). inf where gated out."""
    mc = cfg.matcher
    L, D, _ = m.lm_desc.shape
    N = feat.capacity
    lm_cam = se3.apply(se3.inverse(pose_guess), m.lm_pos)            # (L, 3)
    d3 = jnp.linalg.norm(lm_cam[:, None, :] - feat.xyz[None, :, :], axis=-1)
    radius = mc.matching_xyz_sphere_radius * radius_scale
    gate = (d3 < radius) & m.lm_valid[:, None] & feat.has_depth[None, :]
    d_oct = jnp.abs(m.lm_octave[:, None] - feat.octave[None, :])
    gate &= d_oct <= mc.octave_window
    dots = jax.lax.dot_general(
        feat.desc.astype(jnp.bfloat16),
        m.lm_desc.reshape(L * D, DESC_BITS).astype(jnp.bfloat16),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    ).reshape(N, L, D)
    ham = 0.5 * (DESC_BITS - dots)
    ham = jnp.where(m.lm_slot_used[None, :, :], ham, jnp.inf)
    desc_dist = jnp.min(ham, axis=-1).T                              # (L, N)
    return jnp.where(gate, desc_dist, jnp.inf)


class GuidedMatchPairs(NamedTuple):
    """Multi-mate matchXYZ output: a flat (landmark, feature) pair list."""

    lm_idx: jnp.ndarray     # (P,) int32
    feat_idx: jnp.ndarray   # (P,) int32
    dist: jnp.ndarray       # (P,) float32
    valid: jnp.ndarray      # (P,) bool
    n_candidates: jnp.ndarray  # () int32 landmarks with any candidate


def guided_match_pairs(cfg: SlamConfig, m: MapState, pose_guess: jnp.ndarray,
                       feat: Features, radius_scale: float = 1.0,
                       hamming_slack: float = 0.0) -> GuidedMatchPairs:
    """Band-acceptance multi-mate guided matching (matcher.cpp:734-747: the
    reference accepts EVERY candidate with ratio·dist ≤ best per map
    feature, handing RANSAC a richer correspondence set). Per landmark the
    best ``cfg.matcher.max_mates`` candidates inside the band (and under
    the absolute Hamming gate) become pairs; the flat pair list is
    compacted to ``2 × feat.capacity`` entries for the absolute-pose
    RANSAC."""
    mc = cfg.matcher
    L = m.capacity
    N = feat.capacity
    k = max(int(mc.max_mates), 1)
    dist = _guided_distances(cfg, m, pose_guess, feat, radius_scale)
    finite = jnp.isfinite(dist)
    best = jnp.min(jnp.where(finite, dist, 1e9), axis=1, keepdims=True)
    band = finite & (mc.matching_xyz_acceptance_ratio * dist <= best) \
        & (dist <= mc.max_hamming + hamming_slack)
    negd = jnp.where(band, -dist, -jnp.inf)
    vals, idxs = jax.lax.top_k(negd, k)                              # (L, k)
    pair_ok = jnp.isfinite(vals).reshape(-1)                         # (L·k,)
    pair_lm = jnp.repeat(jnp.arange(L, dtype=jnp.int32), k)
    pair_feat = idxs.reshape(-1).astype(jnp.int32)
    pair_dist = (-vals).reshape(-1)
    P = 2 * N
    # compact the flat pair list to P survivors BY MATCH QUALITY (top_k on
    # -dist), not landmark-index order — on dense revisits with max_mates>1
    # index-order truncation silently drops superior high-index pairs
    sel_negd = jnp.where(pair_ok, -pair_dist, -jnp.inf)
    top_vals, sel = jax.lax.top_k(sel_negd, min(P, sel_negd.shape[0]))
    if sel.shape[0] < P:
        sel = jnp.pad(sel, (0, P - sel.shape[0]))
        top_vals = jnp.pad(top_vals, (0, P - top_vals.shape[0]),
                           constant_values=-jnp.inf)
    on = jnp.isfinite(top_vals)
    safe = jnp.maximum(sel, 0)
    return GuidedMatchPairs(
        lm_idx=jnp.where(on, pair_lm[safe], 0),
        feat_idx=jnp.where(on, pair_feat[safe], 0),
        dist=jnp.where(on, -top_vals, jnp.inf),
        valid=on,
        n_candidates=jnp.sum(jnp.any(finite, axis=1)).astype(jnp.int32))


def guided_match(cfg: SlamConfig, m: MapState, pose_guess: jnp.ndarray,
                 feat: Features, radius_scale: float = 1.0,
                 hamming_slack: float = 0.0) -> GuidedMatchResult:
    """Scale-aware guided map→frame matching (``matchXYZ``,
    matcher.cpp:606-798): for each visible landmark, candidate frame features
    are gated by a 3D sphere (|Δxyz| < matchingXYZSphereRadius, :699-711) and
    an octave window (±1), then the best Hamming distance wins and is
    accepted together with everything within ratio-of-best — here we keep
    the best candidate per landmark (the extra ratio-mates add little once
    RANSAC re-filters; the acceptance gate below mirrors the ratio test).

    All L×N pair distances come from one matmul over the multi-view
    descriptor slots (min over slots ≈ the nearest-view descriptor selection
    of findNearestFrame, featuresMap.cpp:528-563).
    """
    mc = cfg.matcher
    dist = _guided_distances(cfg, m, pose_guess, feat, radius_scale)  # (L, N)
    best_idx = jnp.argmin(dist, axis=1).astype(jnp.int32)            # (L,)
    if mc.acceptance == "ratio":
        # ratio-of-best (matcher.cpp:734-747): the winner must beat the
        # second-best candidate by the acceptance ratio — repetitive texture
        # that aliases across candidates is rejected instead of admitted
        two = -jax.lax.top_k(-jnp.where(jnp.isfinite(dist), dist, 1e9),
                             2)[0]                                   # (L, 2)
        best, second = two[:, 0], two[:, 1]
        distinct = (best <= mc.matching_xyz_acceptance_ratio * second) \
            | (second >= 1e9)  # a single candidate is trivially distinct
        ok = (best < 1e9) & (best <= mc.max_hamming + hamming_slack) & distinct
        best = jnp.where(best < 1e9, best, jnp.inf)
    else:
        best = jnp.min(dist, axis=1)
        # acceptance: absolute Hamming gate (documented deviation from the
        # reference's band acceptance; selectable via mc.acceptance)
        ok = jnp.isfinite(best) & (best <= mc.max_hamming + hamming_slack)
    n_cand = jnp.sum(jnp.any(jnp.isfinite(dist), axis=1)).astype(jnp.int32)
    return GuidedMatchResult(best_idx, jnp.where(ok, best, jnp.inf), ok, n_cand)


def _allocate_slots(free_mask: jnp.ndarray, want: jnp.ndarray,
                    max_add: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pair the first ``max_add`` wanted candidates with free slots.

    Returns (cand_idx, slot_idx), both (max_add,) int32; -1 marks unused
    entries (no more candidates or map full)."""
    slot_free_idx = jnp.nonzero(free_mask, size=max_add, fill_value=-1)[0]
    cand_idx = jnp.nonzero(want, size=max_add, fill_value=-1)[0]
    ok = (cand_idx >= 0) & (slot_free_idx >= 0)
    return (jnp.where(ok, cand_idx, -1).astype(jnp.int32),
            jnp.where(ok, slot_free_idx, -1).astype(jnp.int32))


def add_landmarks(cfg: SlamConfig, m: MapState, pose: jnp.ndarray,
                  feat: Features, already_matched: jnp.ndarray,
                  kf_idx: jnp.ndarray) -> MapState:
    """Provision new landmarks from unmatched depth-valid features
    (``chooseFeaturesToAddToMap``, PUTSLAM.cpp:98-178): depth gate 0.8–6 m
    behavior via has_depth, skip features matched to the map, skip features
    too close to an existing landmark (minEuclideanDistanceOfFeatures
    :117-178 / O(n²) dedup matcher.cpp:886-974), cap maxOnceFeatureAdd."""
    mp = cfg.map
    L = m.capacity

    xyz_w = se3.apply(pose, feat.xyz)                               # (N, 3)
    # proximity gate against existing landmarks (masked full distance matrix)
    d = jnp.linalg.norm(xyz_w[:, None, :] - m.lm_pos[None, :, :], axis=-1)
    d = jnp.where(m.lm_valid[None, :], d, jnp.inf)
    too_close = jnp.min(d, axis=1) < mp.min_euclidean_distance_of_features

    want = feat.has_depth & ~already_matched & ~too_close
    cand_idx, slot_idx = _allocate_slots(~m.lm_valid, want, mp.max_once_feature_add)
    ok = slot_idx >= 0
    safe_cand = jnp.maximum(cand_idx, 0)
    # masked-off lanes scatter to the out-of-bounds index L and are DROPPED
    # (JAX .at set semantics) — no where(ok, new, old) read-back needed
    # (the old form gathered every store field per provisioning call)
    safe_slot = jnp.where(ok, slot_idx, L).astype(jnp.int32)

    view_dir = xyz_w[safe_cand] - se3.translation(pose)[None, :]
    view_dir = view_dir / jnp.maximum(
        jnp.linalg.norm(view_dir, axis=-1, keepdims=True), 1e-9)

    lm_pos = m.lm_pos.at[safe_slot].set(xyz_w[safe_cand])
    lm_desc = m.lm_desc.at[safe_slot, 0].set(feat.desc[safe_cand])
    lm_view_dir = m.lm_view_dir.at[safe_slot, 0].set(view_dir)
    lm_slot_used = m.lm_slot_used.at[safe_slot, 0].set(True)
    lm_octave = m.lm_octave.at[safe_slot].set(feat.octave[safe_cand])
    lm_life = m.lm_life.at[safe_slot].set(mp.life_value_init)
    lm_n_obs = m.lm_n_obs.at[safe_slot].set(1)
    lm_last_kf = m.lm_last_kf.at[safe_slot].set(kf_idx)
    lm_valid = m.lm_valid.at[safe_slot].set(True)
    lm_gen = m.lm_gen.at[safe_slot].add(1)
    # clear descriptor slots beyond 0 for the recycled landmark
    lm_slot_used = lm_slot_used.at[safe_slot, 1:].set(False)
    return m._replace(
        lm_pos=lm_pos, lm_desc=lm_desc, lm_view_dir=lm_view_dir,
        lm_slot_used=lm_slot_used, lm_octave=lm_octave, lm_life=lm_life,
        lm_n_obs=lm_n_obs, lm_last_kf=lm_last_kf, lm_valid=lm_valid,
        lm_gen=lm_gen,
    )


def update_matched_landmarks(cfg: SlamConfig, m: MapState, pose: jnp.ndarray,
                             feat: Features, gm: GuidedMatchResult,
                             kf_idx: jnp.ndarray) -> MapState:
    """Bookkeeping for matched landmarks: life bonus (+5 on measurement,
    featuresMap.cpp:1212), observation counts, and a new descriptor slot if
    the view angle differs by > view_angle_new_descriptor from every stored
    slot (30° gate, featuresMap.cpp:1172-1213)."""
    mp = cfg.map
    L, D, _ = m.lm_desc.shape
    matched = gm.valid                                              # (L,)
    fidx = jnp.clip(gm.feat_idx, 0, feat.capacity - 1)

    lm_life = jnp.where(matched, m.lm_life + mp.life_value_measurement_bonus,
                        m.lm_life - mp.life_value_decay * m.lm_valid)
    lm_n_obs = m.lm_n_obs + matched.astype(jnp.int32)
    lm_last_kf = jnp.where(matched, kf_idx, m.lm_last_kf)

    # view direction now (world frame)
    vd = m.lm_pos - se3.translation(pose)[None, :]
    vd = vd / jnp.maximum(jnp.linalg.norm(vd, axis=-1, keepdims=True), 1e-9)
    cosang = jnp.einsum("ldk,lk->ld", m.lm_view_dir, vd)            # (L, D)
    cosang = jnp.where(m.lm_slot_used, cosang, -1.0)
    novel = jnp.max(cosang, axis=-1) < jnp.cos(mp.view_angle_new_descriptor)
    free_slot = jnp.argmin(m.lm_slot_used.astype(jnp.int32), axis=-1)
    can_store = ~jnp.all(m.lm_slot_used, axis=-1)
    store = matched & novel & can_store

    lidx = jnp.arange(L)
    new_desc = feat.desc[fidx]                                      # (L, 256)
    # rows not storing scatter to the out-of-bounds slot index D and are
    # dropped — no read-back gathers of the (L, D, 256) descriptor store
    D = m.lm_slot_used.shape[1]
    safe_free = jnp.where(store, free_slot, D)
    lm_desc = m.lm_desc.at[lidx, safe_free].set(new_desc)
    lm_view_dir = m.lm_view_dir.at[lidx, safe_free].set(vd)
    lm_slot_used = m.lm_slot_used.at[lidx, safe_free].set(True)

    # landmark death: life exhausted (weak-feature removal analog)
    lm_valid = m.lm_valid & (lm_life > 0.0)
    return m._replace(lm_desc=lm_desc, lm_view_dir=lm_view_dir,
                      lm_slot_used=lm_slot_used, lm_life=lm_life,
                      lm_n_obs=lm_n_obs, lm_last_kf=lm_last_kf,
                      lm_valid=lm_valid)


def add_keyframe(cfg: SlamConfig, m: MapState, pose: jnp.ndarray,
                 covis_with_prev: jnp.ndarray) -> Tuple[MapState, jnp.ndarray]:
    """Append a keyframe (bounded ring: indices mod K) and record the
    covisibility edge to the previous keyframe (weightedGraph.h:30-97).

    When the ring wraps (n_kf ≥ K) the recycled slot's generation is bumped —
    graph edges stamped with the old generation are masked out of BA — and
    the slot's covisibility row/column is cleared, so the new occupant never
    inherits the evicted keyframe's graph connectivity (the reference keeps
    its graph sound through marginalization, featuresMap.cpp:1056-1104)."""
    K = m.kf_pose.shape[0]
    idx = jnp.mod(m.n_kf, K)
    prev = jnp.mod(m.n_kf - 1, K)
    recycled = m.kf_valid[idx]
    kf_pose = m.kf_pose.at[idx].set(pose)
    kf_valid = m.kf_valid.at[idx].set(True)
    kf_seq = m.kf_seq.at[idx].set(m.n_kf)
    kf_gen = m.kf_gen.at[idx].add(recycled.astype(jnp.int32))
    covis = m.covis.at[idx, :].set(0.0)
    covis = covis.at[:, idx].set(0.0)
    covis = covis.at[idx, prev].set(covis_with_prev)
    covis = covis.at[prev, idx].set(covis_with_prev)
    return m._replace(kf_pose=kf_pose, kf_valid=kf_valid, kf_seq=kf_seq,
                      kf_gen=kf_gen, n_kf=m.n_kf + 1, covis=covis), idx


def covisibility_ratio(gm: GuidedMatchResult, m: MapState,
                       last_kf_seq: jnp.ndarray) -> jnp.ndarray:
    """Fraction of currently-matched landmarks that were already observed at
    the last keyframe — the keyframe trigger (featuresMap.cpp:292-333).
    ``last_kf_seq``: sequential number of the previous keyframe."""
    seen_before = m.lm_last_kf == last_kf_seq
    both = jnp.sum((gm.valid & seen_before).astype(jnp.float32))
    now = jnp.maximum(jnp.sum(gm.valid.astype(jnp.float32)), 1.0)
    return both / now


def active_window_fixed(m: MapState, window: int) -> jnp.ndarray:
    """(K,) bool: keyframes older than the active optimization window —
    these are frozen in BA (``fixMeasurementsFromPose`` + full-marginalization
    fixing, featuresMap.cpp:1043-1053, :1056-1104). Slot 0 of the window is
    always fixed by the caller for gauge."""
    age = m.n_kf - 1 - m.kf_seq
    return m.kf_valid & (age >= window)


def compress_map(cfg: SlamConfig, m: MapState, window: int) -> MapState:
    """Marginalize weak, out-of-window landmarks (featuresMap.cpp:1056-1104:
    features not connected to keyframes are removed when covisibility is low
    / the window overflows). A reclaimed slot's generation makes any stale
    graph edges vanish from the next BA automatically."""
    out_of_window = m.lm_last_kf < (m.n_kf - window)
    weak = m.lm_n_obs < 2
    drop = m.lm_valid & out_of_window & weak
    return m._replace(lm_valid=m.lm_valid & ~drop)
