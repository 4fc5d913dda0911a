"""Multi-session distributed mapping: joint optimization of several maps.

The BASELINE.json stretch configuration ("4+ sequences jointly optimized,
map blocks sharded across hosts") — no counterpart exists in the reference
(single process, single session). Sessions are first run independently
(optionally data-parallel across the mesh, parallel/mesh.py); their final
states are then merged into one stacked problem:

* keyframes / landmarks / edges concatenated with per-session index offsets,
* cross-session loop closures found by scoring every session-A keyframe
  BoW signature against every session-B signature (one matmul) and
  geometrically verifying the top pairs (loopclosure/verify machinery),
* the joint graph optimized by the *distributed* Schur BA
  (parallel/dist_ba.py) with the stacked landmark axis sharded over the
  mesh — inter-session consistency rides the psum'd reduced camera system.

Gauge: the first keyframe of every session is fixed until cross-session
edges exist; with edges, only session 0's anchor stays fixed and the other
anchors are released so the loop closures can pull sessions into a common
frame.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from putslam_tpu.backend import graph as graph_mod
from putslam_tpu.config import SlamConfig
from putslam_tpu.loopclosure import verify as lc_verify
from putslam_tpu.parallel import dist_ba
from putslam_tpu.slam_map import features_map as fm


class MergedProblem(NamedTuple):
    kf_pose: jnp.ndarray      # (B*K, 7)
    kf_valid: jnp.ndarray
    kf_gen: jnp.ndarray       # (B*K,) int32 keyframe slot generations
    lm_pos: jnp.ndarray       # (B*L, 3)
    lm_valid: jnp.ndarray
    lm_gen: jnp.ndarray
    graph: graph_mod.GraphState
    session_of_kf: jnp.ndarray  # (B*K,) int32
    anchors: jnp.ndarray        # (B,) int32 — first valid kf index per session
    map_states: List[fm.MapState]


def merge_sessions(cfg: SlamConfig, states) -> MergedProblem:
    """Stack the final SlamStates of B sessions into one problem."""
    B = len(states)
    K = states[0].map.kf_pose.shape[0]
    L = states[0].map.lm_pos.shape[0]
    M = states[0].graph.obs_capacity
    E = states[0].graph.pp_capacity

    kf_pose = jnp.concatenate([s.map.kf_pose for s in states])
    kf_valid = jnp.concatenate([s.map.kf_valid for s in states])
    kf_gen = jnp.concatenate([s.map.kf_gen for s in states])
    lm_pos = jnp.concatenate([s.map.lm_pos for s in states])
    lm_valid = jnp.concatenate([s.map.lm_valid for s in states])
    lm_gen = jnp.concatenate([s.map.lm_gen for s in states])
    session_of_kf = jnp.concatenate(
        [jnp.full((K,), b, jnp.int32) for b in range(B)])

    # stacked edge store: plain concatenation with index offsets
    g = graph_mod.GraphState(
        obs_kf=jnp.concatenate([s.graph.obs_kf + b * K
                                for b, s in enumerate(states)]),
        obs_lm=jnp.concatenate([s.graph.obs_lm + b * L
                                for b, s in enumerate(states)]),
        obs_xyz=jnp.concatenate([s.graph.obs_xyz for s in states]),
        obs_w=jnp.concatenate([s.graph.obs_w for s in states]),
        obs_gen=jnp.concatenate([s.graph.obs_gen for s in states]),
        obs_kfgen=jnp.concatenate([s.graph.obs_kfgen for s in states]),
        obs_seq=jnp.concatenate([s.graph.obs_seq for s in states]),
        obs_valid=jnp.concatenate([s.graph.obs_valid for s in states]),
        n_obs=sum((s.graph.n_obs for s in states), jnp.int32(0)),
        obs_info=jnp.concatenate([s.graph.obs_info for s in states]),
        pp_i=jnp.concatenate([s.graph.pp_i + b * K
                              for b, s in enumerate(states)]),
        pp_j=jnp.concatenate([s.graph.pp_j + b * K
                              for b, s in enumerate(states)]),
        pp_rel=jnp.concatenate([s.graph.pp_rel for s in states]),
        pp_w=jnp.concatenate([s.graph.pp_w for s in states]),
        pp_gen_i=jnp.concatenate([s.graph.pp_gen_i for s in states]),
        pp_gen_j=jnp.concatenate([s.graph.pp_gen_j for s in states]),
        pp_valid=jnp.concatenate([s.graph.pp_valid for s in states]),
        n_pp=sum((s.graph.n_pp for s in states), jnp.int32(0)),
    )

    anchors = []
    kfv = np.asarray(kf_valid)
    for b in range(B):
        idx = np.nonzero(kfv[b * K:(b + 1) * K])[0]
        anchors.append(b * K + (int(idx[0]) if len(idx) else 0))
    return MergedProblem(kf_pose, kf_valid, kf_gen, lm_pos, lm_valid, lm_gen,
                         g, session_of_kf, jnp.asarray(anchors, jnp.int32),
                         [s.map for s in states])


class _MapView(NamedTuple):
    """Merged MapState view for the verifier (landmark arrays stacked)."""

    lm_gen: jnp.ndarray
    lm_valid: jnp.ndarray
    lm_desc: jnp.ndarray
    lm_pos: jnp.ndarray
    lm_view_dir: jnp.ndarray
    lm_slot_used: jnp.ndarray
    kf_pose: jnp.ndarray
    kf_gen: jnp.ndarray


def find_cross_session_closures(cfg: SlamConfig, merged: MergedProblem,
                                states, key, top_per_pair: int = 3,
                                min_score: float = 0.3):
    """Score + verify inter-session keyframe pairs; returns the merged graph
    with accepted pose-pose correction edges and the number accepted.

    Fully batched: all B·(B−1)/2 session-pair similarity matrices come from
    one einsum, the per-pair top-k candidates are verified with a single
    vmapped ``verify_candidate`` call, and there is exactly one device→host
    sync for the accept decisions (the round-2 version looped on host with a
    sync per pair — serial at the 4+-session stretch config)."""
    B = len(states)
    K = states[0].map.kf_pose.shape[0]
    g = merged.graph

    map_view = _MapView(
        merged.lm_gen, merged.lm_valid,
        jnp.concatenate([s.map.lm_desc for s in states]), merged.lm_pos,
        jnp.concatenate([s.map.lm_view_dir for s in states]),
        jnp.concatenate([s.map.lm_slot_used for s in states]),
        merged.kf_pose, merged.kf_gen)

    # only keyframes that actually carry observations can be verified
    BK = merged.kf_pose.shape[0]
    obs_count = jnp.zeros((BK,), jnp.int32).at[g.obs_kf].add(
        g.obs_valid.astype(jnp.int32))
    has_obs = obs_count >= cfg.loop_closure.min_features_lc

    sigs = jnp.stack([s.kf_sig for s in states])                # (B, K, V)
    valid = jnp.stack([s.sig_valid for s in states]) \
        & has_obs.reshape(B, K)                                 # (B, K)
    # only the strict upper triangle of session pairs can close (a < b);
    # B is a trace-time constant, so enumerate the B·(B−1)/2 pairs directly
    # instead of scoring/verifying all B² ordered pairs
    pairs = [(a, b) for a in range(B) for b in range(a + 1, B)]
    S = jnp.stack([sigs[a] @ sigs[b].T for a, b in pairs])      # (P, K, K)
    mask = jnp.stack([valid[a][:, None] & valid[b][None, :]
                      for a, b in pairs])
    S = jnp.where(mask, S, -jnp.inf)

    top_v, top_i = jax.lax.top_k(S.reshape(len(pairs), K * K), top_per_pair)
    a_idx = jnp.asarray([a for a, _ in pairs], jnp.int32)[:, None]
    b_idx = jnp.asarray([b for _, b in pairs], jnp.int32)[:, None]
    ka = (a_idx * K + top_i // K).reshape(-1).astype(jnp.int32)
    kb = (b_idx * K + top_i % K).reshape(-1).astype(jnp.int32)
    cand_ok = (top_v >= min_score).reshape(-1)

    n_cand = ka.shape[0]
    keys = jax.random.split(key, n_cand)
    vres = jax.vmap(
        lambda a, b, k: lc_verify.verify_candidate(cfg, map_view, g, a, b, k)
    )(jnp.maximum(ka, 0), jnp.maximum(kb, 0), keys)

    accept = np.asarray(vres.ok & cand_ok)                      # one sync
    rel = np.asarray(vres.rel_pose)
    ka_h, kb_h = np.asarray(ka), np.asarray(kb)
    n_accepted = 0
    for t in np.nonzero(accept)[0]:
        # stamp the current keyframe-slot generations: without them, joint
        # BA would mask these edges out for any session whose ring wrapped
        g = graph_mod.add_pose_pose(
            g, jnp.int32(ka_h[t]), jnp.int32(kb_h[t]), jnp.asarray(rel[t]),
            jnp.float32(200.0), True,
            gen_i=merged.kf_gen[ka_h[t]], gen_j=merged.kf_gen[kb_h[t]])
        n_accepted += 1
    return g, n_accepted


def joint_optimize(cfg: SlamConfig, mesh, merged: MergedProblem,
                   g: graph_mod.GraphState, n_cross_edges: int):
    """Distributed BA over the merged problem. Returns (kf_pose, lm_pos,
    chi2).

    Merged multi-session graphs are exactly the case where landmark ids may
    be skewed across the devices, so the dist solver's owner-partition
    overflow is checked: if any edges would be dropped by the 2×-slack
    partition, the solve falls back to the single-device full solver
    (correctness over scaling) with a warning."""
    BK = merged.kf_pose.shape[0]
    fixed = jnp.zeros((BK,), bool)
    if n_cross_edges > 0:
        fixed = fixed.at[merged.anchors[0]].set(True)
    else:
        fixed = fixed.at[merged.anchors].set(True)
    kf_out, lm_out, chi2, overflow = dist_ba.dist_gauss_newton(
        cfg.backend, mesh, merged.kf_pose, merged.kf_valid,
        merged.lm_pos, merged.lm_valid, g, fixed, merged.lm_gen,
        merged.kf_gen, cam=cfg.camera)
    if int(overflow) > 0:
        import warnings

        from putslam_tpu.backend import optimize as opt_mod

        warnings.warn(
            f"dist-BA owner partition dropped {int(overflow)} edges on the "
            f"merged graph (skewed landmark ownership); re-solving on one "
            f"device for correctness. Rebalance landmark ids across devices "
            f"to restore the sharded path.", stacklevel=2)
        res = opt_mod.gauss_newton_mm(
            cfg.backend, merged.kf_pose, merged.kf_valid, merged.lm_pos,
            merged.lm_valid, g, fixed, merged.lm_gen, merged.kf_gen,
            cam=cfg.camera)
        return res.kf_pose, res.lm_pos, res.chi2
    return kf_out, lm_out, chi2
