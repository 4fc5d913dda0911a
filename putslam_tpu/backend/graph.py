"""Fixed-capacity factor-graph storage.

Batched replacement for the reference's g2o graph wrapper
(reference: src/PoseGraph/graph_g2o.cpp — vertex/edge insertion through
factory strings :162-364, buffered async insertion :595-677, first-vertex
gauge fix :184-186). Vertices live in ``MapState`` (keyframe poses) and the
landmark arrays; this module holds the *edges* as flat arrays with masks:

* pose→landmark observations (``EDGE_SE3_TRACKXYZ`` / Edge3D — a measured
  3D point in the observing camera's frame, featuresMap.cpp:281-282),
* pose→pose relative-motion edges (``EDGE_SE3:QUAT``, PUTSLAM.cpp:814-821).

Appending is a masked scatter; capacity exhaustion saturates (oldest edges
are retained — compaction/marginalization handles reclamation).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class GraphState(NamedTuple):
    # --- pose-landmark observations -------------------------------------
    obs_kf: jnp.ndarray     # (M,) int32 keyframe index
    obs_lm: jnp.ndarray     # (M,) int32 landmark index
    obs_xyz: jnp.ndarray    # (M, 3) measured point, observing-camera frame
    obs_w: jnp.ndarray      # (M,) float32 scalar information weight
    obs_gen: jnp.ndarray    # (M,) int32 landmark-slot generation at insert time
    obs_kfgen: jnp.ndarray  # (M,) int32 keyframe-slot generation at insert time
    obs_seq: jnp.ndarray    # (M,) int32 append sequence number (age ordering)
    obs_valid: jnp.ndarray  # (M,) bool
    n_obs: jnp.ndarray      # () int32 total ever appended (append counter)
    # --- full 3×3 information matrices (use_uncertainty path; all-zero and
    # ignored when the engine runs with scalar weights) ---------------------
    obs_info: jnp.ndarray   # (M, 3, 3) float32
    # --- pose-pose edges -------------------------------------------------
    pp_i: jnp.ndarray       # (E,) int32
    pp_j: jnp.ndarray       # (E,) int32
    pp_rel: jnp.ndarray     # (E, 7) measured T_i⁻¹∘T_j
    pp_w: jnp.ndarray       # (E,) float32
    pp_gen_i: jnp.ndarray   # (E,) int32 keyframe-slot generation of i at insert
    pp_gen_j: jnp.ndarray   # (E,) int32 keyframe-slot generation of j at insert
    pp_valid: jnp.ndarray   # (E,) bool
    n_pp: jnp.ndarray       # () int32

    @property
    def obs_capacity(self) -> int:
        return self.obs_kf.shape[0]

    @property
    def pp_capacity(self) -> int:
        return self.pp_i.shape[0]


def init_graph(max_observations: int, max_pose_pose: int,
               dtype=jnp.float32) -> GraphState:
    M, E = max_observations, max_pose_pose
    return GraphState(
        obs_kf=jnp.zeros((M,), jnp.int32),
        obs_lm=jnp.zeros((M,), jnp.int32),
        obs_xyz=jnp.zeros((M, 3), dtype),
        obs_w=jnp.zeros((M,), dtype),
        obs_gen=jnp.zeros((M,), jnp.int32),
        obs_kfgen=jnp.zeros((M,), jnp.int32),
        obs_seq=jnp.zeros((M,), jnp.int32),
        obs_valid=jnp.zeros((M,), bool),
        n_obs=jnp.int32(0),
        obs_info=jnp.zeros((M, 3, 3), dtype),
        pp_i=jnp.zeros((E,), jnp.int32),
        pp_j=jnp.zeros((E,), jnp.int32),
        pp_rel=jnp.zeros((E, 7), dtype).at[:, 3].set(1.0),
        pp_w=jnp.zeros((E,), dtype),
        pp_gen_i=jnp.zeros((E,), jnp.int32),
        pp_gen_j=jnp.zeros((E,), jnp.int32),
        pp_valid=jnp.zeros((E,), bool),
        n_pp=jnp.int32(0),
    )


def add_observations(g: GraphState, kf_idx, lm_idx, xyz, weight, mask,
                     gen=None, kf_gen=None, info=None) -> GraphState:
    """Append up to len(mask) observations (masked). Slot assignment prefers
    *dead* slots — invalid (pruned / stale-generation edges cleared by
    ``reclaim_observation_slots``) first, then the oldest valid entries in
    append order (FIFO). The reference's marginalization likewise chooses
    what dies by liveness, never blindly (featuresMap.cpp:1056-1104): a
    wrapped store must not overwrite active-window edges while recycled
    slots sit dead.

    ``gen`` / ``kf_gen``: slot generations of the referenced landmark /
    keyframe at insert time — BA masks out any edge whose referenced slot has
    since been recycled. ``info``: optional (N, 3, 3) full information
    matrices (useUncertainty mode, depthSensorModel.cpp:48-59)."""
    M = g.obs_capacity
    rank = jnp.cumsum(mask.astype(jnp.int32)) - 1
    n_new = jnp.sum(mask.astype(jnp.int32))

    # Until the store has ever filled, the plain append cursor IS the
    # dead-first order (every slot at/after the cursor is unwritten), so the
    # argsort allocator — a full 8192-element sort — only runs once
    # allocation could actually overwrite something (lax.cond keeps it off
    # the hot path for the entire pre-wrap life of a run).
    def _cursor_slots(_):
        return jnp.mod(g.n_obs + rank, M).astype(jnp.int32)

    def _sorted_slots(_):
        # invalid slots first (key −1), then oldest by append sequence
        key = jnp.where(g.obs_valid, g.obs_seq, -1)
        order = jnp.argsort(key).astype(jnp.int32)            # (M,)
        return order[jnp.clip(rank, 0, M - 1)]

    slot = jax.lax.cond(g.n_obs + n_new >= M, _sorted_slots, _cursor_slots,
                        None)
    # unmasked lanes write to index M: out-of-bounds scatters are *dropped*
    # (JAX .at default mode) — clipping them to M−1 instead would race a
    # genuine masked write targeting that slot (unspecified winner)
    safe_slot = jnp.where(mask, slot, M)
    if info is None:
        info = jnp.zeros(xyz.shape[:-1] + (3, 3), g.obs_info.dtype)
    # masked-off lanes carry index M: their scatters are DROPPED outright
    # (JAX .at out-of-bounds-set semantics), so no where(mask, new, old)
    # read-back is needed — the previous form gathered every store field
    # (9 × M-row gathers) per append just to re-write unchanged values
    # (round-5 keyframe-path profiling)
    return g._replace(
        obs_kf=g.obs_kf.at[safe_slot].set(kf_idx),
        obs_lm=g.obs_lm.at[safe_slot].set(lm_idx),
        obs_xyz=g.obs_xyz.at[safe_slot].set(xyz),
        obs_w=g.obs_w.at[safe_slot].set(weight),
        obs_gen=g.obs_gen.at[safe_slot].set(
            gen if gen is not None else jnp.zeros_like(kf_idx)),
        obs_kfgen=g.obs_kfgen.at[safe_slot].set(
            kf_gen if kf_gen is not None else jnp.zeros_like(kf_idx)),
        obs_info=g.obs_info.at[safe_slot].set(info),
        obs_seq=g.obs_seq.at[safe_slot].set(g.n_obs + rank),
        obs_valid=g.obs_valid.at[safe_slot].set(True),
        n_obs=g.n_obs + jnp.sum(mask.astype(jnp.int32)),
    )


def reclaim_observation_slots(g: GraphState, lm_gen, kf_gen) -> GraphState:
    """Clear the valid bit on edges whose referenced landmark or keyframe
    slot has been recycled since insertion (stale generation). BA already
    masks these out of the normal equations every call — clearing the mask
    additionally returns their slots to the allocator, so a wrapping store
    reuses dead capacity instead of overwriting live active-window edges
    (the reference's marginalization frees graph memory the same way,
    graph_g2o.cpp:1128-1177)."""
    fresh = (g.obs_gen == lm_gen[g.obs_lm]) \
        & (g.obs_kfgen == kf_gen[g.obs_kf])
    return g._replace(obs_valid=g.obs_valid & fresh)


def add_pose_pose(g: GraphState, i, j, rel, weight, valid=True,
                  gen_i=None, gen_j=None) -> GraphState:
    """Append one pose-pose edge (VO increment; PUTSLAM.cpp:814-821).
    ``gen_i``/``gen_j``: keyframe-slot generations at insert time."""
    E = g.pp_capacity
    v = jnp.asarray(valid)
    # invalid appends scatter to the out-of-bounds slot E and are dropped —
    # no read-back of the current slot values needed
    slot = jnp.where(v, jnp.mod(g.n_pp, E), E)
    return g._replace(
        pp_i=g.pp_i.at[slot].set(i),
        pp_j=g.pp_j.at[slot].set(j),
        pp_rel=g.pp_rel.at[slot].set(rel),
        pp_w=g.pp_w.at[slot].set(weight),
        pp_gen_i=g.pp_gen_i.at[slot].set(
            gen_i if gen_i is not None else 0),
        pp_gen_j=g.pp_gen_j.at[slot].set(
            gen_j if gen_j is not None else 0),
        pp_valid=g.pp_valid.at[slot].set(True),
        n_pp=g.n_pp + v.astype(jnp.int32),
    )


def prune_observations(g: GraphState, drop_mask: jnp.ndarray) -> GraphState:
    """Disable observations (chi²-based edge pruning, graph_g2o.cpp:1394-1505
    ``optimizeAndPrune`` — implemented as a mask clear, no memory motion)."""
    return g._replace(obs_valid=g.obs_valid & ~drop_mask)
