"""Round-4 features: BA active-window compaction, obs-slot reclamation,
motion-model wiring, disk-based TUM pipeline pieces."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from putslam_tpu.backend import graph, optimize
from putslam_tpu.config import BackendConfig
from putslam_tpu.geometry import se3

from test_backend import build_problem


def _mm_cfg(**kw):
    base = dict(gn_iterations=6, robust_kernel="none", damping=1e-5,
                solver="dense_schur_mm", chi2_ratio_termination=1.0)
    base.update(kw)
    return BackendConfig(**base)


def test_windowed_mm_matches_full_when_window_covers_free(rng):
    """With every free keyframe inside the compaction window, the windowed
    solver must reproduce the full-K dense_schur_mm solution bit-for-bit in
    spirit (same frozen set, same reduced system up to row permutation)."""
    K = 12
    kf_true, lm_true, kf_init, lm_init, g = build_problem(
        rng, K=K, L=96, obs_per_kf=48, noise=0.002)
    kf_valid = jnp.ones((K,), bool)
    lm_valid = jnp.ones((lm_init.shape[0],), bool)
    # freeze the oldest 4 (window fixing) + gauge
    fixed = jnp.zeros((K,), bool).at[jnp.arange(4)].set(True)

    res_full = optimize.gauss_newton_mm(
        _mm_cfg(ba_window=0), jnp.asarray(kf_init), kf_valid,
        jnp.asarray(lm_init), lm_valid, g, fixed)
    res_win = optimize.gauss_newton_mm(
        _mm_cfg(ba_window=8), jnp.asarray(kf_init), kf_valid,
        jnp.asarray(lm_init), lm_valid, g, fixed)

    np.testing.assert_allclose(np.asarray(res_win.kf_pose),
                               np.asarray(res_full.kf_pose), atol=2e-5)
    np.testing.assert_allclose(np.asarray(res_win.lm_pos),
                               np.asarray(res_full.lm_pos), atol=2e-5)
    np.testing.assert_allclose(np.asarray(res_win.chi2),
                               np.asarray(res_full.chi2), rtol=1e-3)
    # frozen poses untouched
    np.testing.assert_array_equal(np.asarray(res_win.kf_pose)[:4],
                                  kf_init[:4])


def test_windowed_mm_converges_toward_truth(rng):
    """Windowed BA with frozen history must still pull the free keyframes
    toward ground truth (frozen observations anchor landmarks → gauge)."""
    K = 12
    kf_true, lm_true, kf_init, lm_init, g = build_problem(
        rng, K=K, L=96, obs_per_kf=48, noise=0.0, pose_noise=0.03)
    kf_valid = jnp.ones((K,), bool)
    lm_valid = jnp.ones((lm_init.shape[0],), bool)
    # freeze the first 6 at their TRUE poses (a converged prefix)
    kf_init2 = kf_init.copy()
    kf_init2[:6] = kf_true[:6]
    fixed = jnp.zeros((K,), bool).at[jnp.arange(6)].set(True)
    res = optimize.gauss_newton_mm(
        _mm_cfg(ba_window=6, gn_iterations=8), jnp.asarray(kf_init2),
        kf_valid, jnp.asarray(lm_init), lm_valid, g, fixed)
    err = np.linalg.norm(
        np.asarray(res.kf_pose)[6:, :3] - kf_true[6:, :3], axis=-1)
    init_err = np.linalg.norm(kf_init2[6:, :3] - kf_true[6:, :3], axis=-1)
    assert err.max() < 0.05 * init_err.max(), (err.max(), init_err.max())
    chi = np.asarray(res.chi2)
    assert chi[-1] < chi[0]


def test_windowed_mm_overflow_freezes_oldest_slots(rng):
    """More free keyframes than the window: the solver silently freezes the
    surplus (first-W free slots win) instead of corrupting the system."""
    K = 12
    kf_true, lm_true, kf_init, lm_init, g = build_problem(
        rng, K=K, L=96, obs_per_kf=48, noise=0.002)
    kf_valid = jnp.ones((K,), bool)
    lm_valid = jnp.ones((lm_init.shape[0],), bool)
    fixed = jnp.zeros((K,), bool).at[0].set(True)   # 11 free > window 4
    res = optimize.gauss_newton_mm(
        _mm_cfg(ba_window=4), jnp.asarray(kf_init), kf_valid,
        jnp.asarray(lm_init), lm_valid, g, fixed)
    out = np.asarray(res.kf_pose)
    assert np.all(np.isfinite(out))
    # slots 1..4 are the first four free → optimized; 5.. stay frozen
    assert np.abs(out[5:] - kf_init[5:]).max() < 1e-12
    assert np.abs(out[1:5] - kf_init[1:5]).max() > 1e-6


def test_lm_blocked_mm_matches_full(rng):
    """Landmark-axis compaction (one-hot matmul gathers) must reproduce the
    full-axis dense_schur_mm solution, including with invalid landmarks
    interleaved and a generation gate active."""
    K, L = 8, 96
    kf_true, lm_true, kf_init, lm_init, g = build_problem(
        rng, K=K, L=L, obs_per_kf=48, noise=0.002)
    kf_valid = jnp.ones((K,), bool)
    # kill every 5th landmark (its observations must gate out identically)
    lm_valid = jnp.asarray(np.arange(L) % 5 != 0)
    lm_gen = jnp.ones((L,), jnp.int32)
    g = g._replace(obs_gen=jnp.ones_like(g.obs_gen))
    fixed = jnp.zeros((K,), bool).at[0].set(True)

    res_full = optimize.gauss_newton_mm(
        _mm_cfg(ba_window=0, ba_lm_block=0), jnp.asarray(kf_init), kf_valid,
        jnp.asarray(lm_init), lm_valid, g, fixed, lm_gen=lm_gen)
    res_blk = optimize.gauss_newton_mm(
        _mm_cfg(ba_window=0, ba_lm_block=90), jnp.asarray(kf_init), kf_valid,
        jnp.asarray(lm_init), lm_valid, g, fixed, lm_gen=lm_gen)
    np.testing.assert_allclose(np.asarray(res_blk.kf_pose),
                               np.asarray(res_full.kf_pose), atol=2e-5)
    np.testing.assert_allclose(np.asarray(res_blk.lm_pos),
                               np.asarray(res_full.lm_pos), atol=2e-5)
    np.testing.assert_allclose(np.asarray(res_blk.chi2),
                               np.asarray(res_full.chi2), rtol=1e-3)
    # invalid landmarks untouched by both
    dead = ~np.asarray(lm_valid)
    np.testing.assert_array_equal(np.asarray(res_blk.lm_pos)[dead],
                                  lm_init[dead])


# ---------------------------------------------------------------------------
# observation-slot reclamation (obs-store wrap soundness)
# ---------------------------------------------------------------------------


def _add_batch(g, kf, lm_indices, xyz, gen=None, kfgen=None):
    n = len(lm_indices)
    return graph.add_observations(
        g, jnp.full((n,), kf, jnp.int32),
        jnp.asarray(lm_indices, jnp.int32), jnp.asarray(xyz, jnp.float32),
        jnp.ones((n,), jnp.float32), jnp.ones((n,), bool),
        gen=None if gen is None else jnp.asarray(gen, jnp.int32),
        kf_gen=None if kfgen is None else jnp.asarray(kfgen, jnp.int32))


def test_allocator_prefers_dead_slots_over_live_edges():
    """A wrapped store must consume invalid (pruned/stale) slots before
    overwriting valid in-window edges."""
    M = 8
    g = graph.init_graph(M, 4)
    g = _add_batch(g, 0, range(8), np.zeros((8, 3)))      # fill all 8
    # prune slots holding lm 2,5 (dead capacity)
    drop = np.zeros(M, bool)
    drop[np.isin(np.asarray(g.obs_lm), [2, 5])] = True
    g = graph.prune_observations(g, jnp.asarray(drop))
    # add 2 more → must land exactly in the two dead slots
    g2 = _add_batch(g, 1, [10, 11], np.ones((2, 3)))
    still_there = np.asarray(g2.obs_lm)[np.asarray(g.obs_valid)]
    for lm in (0, 1, 3, 4, 6, 7):
        assert lm in still_there, (lm, np.asarray(g2.obs_lm))
    assert set(np.asarray(g2.obs_lm)[~np.asarray(g.obs_valid)]) == {10, 11}
    assert bool(np.all(np.asarray(g2.obs_valid)))


def test_allocator_overflow_evicts_oldest_first():
    """With no dead slots, overwriting follows append order (FIFO)."""
    M = 8
    g = graph.init_graph(M, 4)
    g = _add_batch(g, 0, range(8), np.zeros((8, 3)))
    g = _add_batch(g, 1, [100, 101, 102], np.ones((3, 3)))
    lm = set(np.asarray(g.obs_lm).tolist())
    # oldest three (0,1,2) evicted, rest retained
    assert lm == {3, 4, 5, 6, 7, 100, 101, 102}, lm


def test_reclaim_clears_stale_generation_edges():
    M = 8
    g = graph.init_graph(M, 4)
    g = _add_batch(g, 0, range(4), np.zeros((4, 3)),
                   gen=[1, 1, 2, 1], kfgen=[0, 0, 0, 0])
    lm_gen = jnp.asarray([1, 1, 1, 1, 1, 1, 1, 1], jnp.int32)  # lm 2 recycled
    kf_gen = jnp.zeros((4,), jnp.int32)
    g2 = graph.reclaim_observation_slots(g, lm_gen, kf_gen)
    v = np.asarray(g2.obs_valid)
    assert v.sum() == 3
    assert not v[np.asarray(g.obs_lm)[:4].tolist().index(2)]


@pytest.mark.slow
def test_slam_survives_obs_ring_wrap():
    """Full engine on a tiny obs store that wraps mid-run: active-window
    edges must survive (BA stays finite and the map stays consistent)."""
    from putslam_tpu.config import tiny_test_config
    from putslam_tpu.io import synthetic
    from putslam_tpu.models import slam as slam_mod
    from putslam_tpu.eval import ate
    import dataclasses as dc

    cfg = tiny_test_config()
    cfg = cfg.replace(
        backend=dc.replace(cfg.backend, max_observations=160,
                           optimize_every_n_frames=3),
        map=dc.replace(cfg.map, covisibility_keyframe=2.0))  # keyframe every frame
    poses = synthetic.orbit_trajectory(24, radius=0.06, yaw_amp=0.08)
    grays, depths = synthetic.render_sequence(cfg.camera, poses)
    est, outs, st = slam_mod.run_slam(cfg, grays, depths,
                                      init_pose=jnp.asarray(poses[0]))
    # the store wrapped: more observations appended than capacity
    assert int(np.asarray(st.graph.n_obs)) > 160
    assert np.all(np.isfinite(est))
    chi = np.asarray(outs.chi2)
    assert np.all(np.isfinite(chi))
    err = ate.ate_rmse_aligned_frames(np.asarray(poses), est)
    assert float(err) < 0.15, err


# ---------------------------------------------------------------------------
# host map archive + offline global bundle adjustment
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_archive_preserves_evicted_history_and_global_ba_polishes():
    """Small rings forced to wrap: the archive must retain every keyframe
    ever created (the device ring forgets), and the offline global BA must
    return a full-length polished trajectory no worse than the online one."""
    import dataclasses as dc
    from putslam_tpu.config import tiny_test_config
    from putslam_tpu.io import synthetic
    from putslam_tpu.models import slam as slam_mod
    from putslam_tpu.eval import ate

    cfg = tiny_test_config()
    cfg = cfg.replace(
        map=dc.replace(cfg.map, max_keyframes=16, covisibility_keyframe=2.0),
        backend=dc.replace(cfg.backend, max_observations=256,
                           optimize_every_n_frames=4))
    poses = synthetic.orbit_trajectory(28, radius=0.06, yaw_amp=0.08)
    grays, depths = synthetic.render_sequence(cfg.camera, poses)
    gt = np.asarray(poses)
    pb, pa, outs, st, archive = slam_mod.run_slam_global(
        cfg, grays, depths, init_pose=jnp.asarray(poses[0]), chunk_size=8,
        window=8, kf_cap=32, lm_cap=512, obs_cap=1024, pp_cap=64,
        sweeps=2, gn_iterations=4)
    # every keyframe ever created is archived, though the 16-slot ring wrapped
    n_kf_total = int(np.asarray(st.map.n_kf))
    assert n_kf_total > 16
    assert archive.n_keyframes() == n_kf_total
    err_before = float(ate.ate_rmse_aligned_frames(gt, pb))
    err_after = float(ate.ate_rmse_aligned_frames(gt, pa))
    assert np.all(np.isfinite(pa))
    assert err_after < err_before * 1.2 + 1e-4, (err_before, err_after)
    assert err_after < 0.15, err_after


# ---------------------------------------------------------------------------
# multi-mate guided matching (band acceptance)
# ---------------------------------------------------------------------------


def _tiny_map_and_features(n_feat=8, alias=True):
    import dataclasses as dc
    from putslam_tpu.config import tiny_test_config
    from putslam_tpu.slam_map import features_map as fm
    from putslam_tpu.frontend.detector import Features

    cfg = tiny_test_config()
    cfg = cfg.replace(matcher=dc.replace(cfg.matcher, max_mates=3))
    m = fm.init_map(cfg)
    desc = jnp.ones((fm.DESC_BITS,), jnp.int8)
    m = m._replace(
        lm_pos=m.lm_pos.at[0].set(jnp.asarray([0.0, 0.0, 2.0])),
        lm_desc=m.lm_desc.at[0, 0].set(desc),
        lm_slot_used=m.lm_slot_used.at[0, 0].set(True),
        lm_valid=m.lm_valid.at[0].set(True))
    N = n_feat
    xyz = jnp.tile(jnp.asarray([[9.0, 9.0, 9.0]]), (N, 1))
    xyz = xyz.at[0].set(jnp.asarray([0.0, 0.0, 2.0]))
    descs = jnp.zeros((N, fm.DESC_BITS), jnp.int8)
    descs = descs.at[0].set(desc)
    if alias:
        # second feature: same descriptor, inside the sphere
        xyz = xyz.at[1].set(jnp.asarray([0.05, 0.0, 2.0]))
        descs = descs.at[1].set(desc)
    feat = Features(
        uv=jnp.zeros((N, 2)), uv_undist=jnp.zeros((N, 2)), xyz=xyz,
        response=jnp.ones((N,)), octave=jnp.zeros((N,), jnp.int32),
        angle=jnp.zeros((N,)), desc=descs,
        valid=jnp.ones((N,), bool), has_depth=jnp.ones((N,), bool))
    return cfg, m, feat


def test_guided_match_pairs_band_accepts_aliased_mates():
    from putslam_tpu.geometry import se3
    from putslam_tpu.slam_map import features_map as fm

    cfg, m, feat = _tiny_map_and_features(alias=True)
    pr = fm.guided_match_pairs(cfg, m, se3.identity(), feat)
    got = {(int(l), int(f)) for l, f, v in
           zip(np.asarray(pr.lm_idx), np.asarray(pr.feat_idx),
               np.asarray(pr.valid)) if v}
    # BOTH aliased features are offered as mates of landmark 0
    assert (0, 0) in got and (0, 1) in got, got
    assert len(got) == 2, got


@pytest.mark.slow
def test_engine_multi_mate_no_regression():
    import dataclasses as dc
    from putslam_tpu.config import tiny_test_config
    from putslam_tpu.io import synthetic
    from putslam_tpu.models import slam as slam_mod
    from putslam_tpu.eval import ate

    base = tiny_test_config()
    poses = synthetic.orbit_trajectory(12, radius=0.06, yaw_amp=0.08)
    grays, depths = synthetic.render_sequence(base.camera, poses)
    gt = np.asarray(poses)
    errs = {}
    for mates in (1, 2):
        cfg = base.replace(matcher=dc.replace(base.matcher, max_mates=mates))
        est, _, _ = slam_mod.run_slam(cfg, grays, depths,
                                      init_pose=jnp.asarray(poses[0]))
        errs[mates] = float(ate.ate_rmse_aligned_frames(gt, est))
    assert errs[2] < errs[1] + 0.02, errs


# ---------------------------------------------------------------------------
# grid_topk divergence: subtile policy vs the exact per-cell-top-k oracle
# ---------------------------------------------------------------------------


def test_grid_topk_subtile_vs_exact_oracle(rng):
    """Quantify the documented divergence (round-2 ADVICE): on a
    cluster-heavy response map, the subtile policy must (a) recover most of
    the oracle's detections, (b) never under-fill the budget by more than
    the clustering it deliberately suppresses, and (c) agree exactly on
    isolated (non-clustered) corners."""
    from putslam_tpu.ops import fast

    H, W = 240, 320
    score = np.zeros((H, W), np.float32)
    # isolated corners on a 20-px lattice: subtiles here are 16 px, so a
    # 20-px spacing guarantees no two isolated corners share a subtile
    lat_y, lat_x = np.meshgrid(np.arange(10, H - 10, 20),
                               np.arange(10, W - 10, 20), indexing="ij")
    lat = np.stack([lat_y.ravel(), lat_x.ravel()], -1)
    pick = rng.choice(len(lat), 90, replace=False)
    for y, x in lat[pick]:
        score[y, x] = rng.uniform(5.0, 50.0)
    # one dense cluster: 100 strong corners inside a single 24×24 patch
    cy, cx = 60, 80
    for _ in range(100):
        score[cy + rng.integers(0, 24), cx + rng.integers(0, 24)] = \
            rng.uniform(60.0, 100.0)
    sj = jnp.asarray(score)
    uv_s, r_s, v_s = fast.grid_topk(sj, 3, 4, 128)
    uv_e, r_e, v_e = fast.grid_topk_exact(sj, 3, 4, 128)
    set_s = {tuple(p) for p in np.asarray(uv_s)[np.asarray(v_s)].astype(int)}
    set_e = {tuple(p) for p in np.asarray(uv_e)[np.asarray(v_e)].astype(int)}
    # (c) outside the cluster box both policies find the same corners
    iso_e = {p for p in set_e
             if not (cx - 1 <= p[0] <= cx + 24 and cy - 1 <= p[1] <= cy + 24)}
    iso_s = {p for p in set_s
             if not (cx - 1 <= p[0] <= cx + 24 and cy - 1 <= p[1] <= cy + 24)}
    missing_iso = iso_e - iso_s
    assert len(missing_iso) <= 0.05 * len(iso_e), (len(missing_iso), len(iso_e))
    # (a) overall recall of the oracle's picks
    recall = len(set_e & set_s) / max(len(set_e), 1)
    assert recall > 0.6, recall
    # (b) the cluster: subtile keeps ≥ the number of subtiles covering it
    clus_s = len(set_s) - len(iso_s)
    assert clus_s >= 1


@pytest.mark.slow
def test_grid_policy_ate_delta_bounded():
    """Engine-level: running the tiny SLAM with the exact per-cell-top-k
    vs the subtile policy must land within a small ATE band — the committed
    bound for the documented divergence."""
    import dataclasses as dc
    from putslam_tpu.config import tiny_test_config
    from putslam_tpu.io import synthetic
    from putslam_tpu.models import slam as slam_mod
    from putslam_tpu.eval import ate

    base = tiny_test_config()
    poses = synthetic.orbit_trajectory(14, radius=0.06, yaw_amp=0.08)
    grays, depths = synthetic.render_sequence(base.camera, poses)
    gt = np.asarray(poses)
    errs = {}
    for policy in ("subtile", "exact"):
        cfg = base.replace(
            detector=dc.replace(base.detector, grid_policy=policy))
        est, _, _ = slam_mod.run_slam(cfg, grays, depths,
                                      init_pose=jnp.asarray(poses[0]))
        errs[policy] = float(ate.ate_rmse_aligned_frames(gt, est))
    assert errs["subtile"] < errs["exact"] + 0.03, errs


# ---------------------------------------------------------------------------
# anisotropic observation uncertainty wired into the loop
# ---------------------------------------------------------------------------


def test_normal_model_boosts_information_along_normal():
    """A frontal wall (normal = −z): the normal-scaled model must report
    much higher information along z than the plain sensor model, and leave
    the tangent directions alone (depthSensorModel.cpp:62-76)."""
    import dataclasses as dc
    from putslam_tpu.config import tiny_test_config
    from putslam_tpu.models.slam import _full_obs_info

    cfg = tiny_test_config()
    cfg = cfg.replace(map=dc.replace(cfg.map, use_uncertainty=True,
                                     uncertainty_model="normal",
                                     scale_uncertainty_normal=0.1))
    uv = jnp.asarray([[64.0, 48.0]])
    xyz = jnp.asarray([[0.0, 0.0, 3.0]])
    dirs = jnp.asarray([[0.0, 0.0, -1.0]])
    info_n = np.asarray(_full_obs_info(cfg, uv, xyz, dirs))[0]
    info_s = np.asarray(_full_obs_info(cfg, uv, xyz, None))[0]
    assert info_n[2, 2] > 20 * info_s[2, 2], (info_n[2, 2], info_s[2, 2])
    np.testing.assert_allclose(info_n[0, 0], info_s[0, 0], rtol=1e-3)
    np.testing.assert_allclose(info_n[1, 1], info_s[1, 1], rtol=1e-3)
    # zero direction (invalid normal) falls back to the sensor model
    info_z = np.asarray(_full_obs_info(cfg, uv, xyz, jnp.zeros((1, 3))))[0]
    np.testing.assert_allclose(info_z, info_s, rtol=1e-5)


@pytest.mark.slow
def test_engine_runs_with_anisotropic_uncertainty_no_ate_regression():
    import dataclasses as dc
    from putslam_tpu.config import tiny_test_config
    from putslam_tpu.io import synthetic
    from putslam_tpu.models import slam as slam_mod
    from putslam_tpu.eval import ate

    base = tiny_test_config()
    poses = synthetic.orbit_trajectory(14, radius=0.06, yaw_amp=0.08)
    grays, depths = synthetic.render_sequence(base.camera, poses)
    gt = np.asarray(poses)
    errs = {}
    for model in ("sensor", "normal"):
        cfg = base.replace(
            map=dc.replace(base.map, use_uncertainty=True,
                           uncertainty_model=model),
            backend=dc.replace(base.backend, use_obs_info=True))
        est, outs, st = slam_mod.run_slam(cfg, grays, depths,
                                          init_pose=jnp.asarray(poses[0]))
        errs[model] = float(ate.ate_rmse_aligned_frames(gt, est))
        # the stored information matrices are actually anisotropic
        tr = np.asarray(st.graph.obs_info)
        assert np.any(tr[:, 0, 0] > 0)
    assert errs["normal"] < 2.0 * errs["sensor"] + 1e-3, errs


# ---------------------------------------------------------------------------
# g2o interop: full information matrices
# ---------------------------------------------------------------------------


def test_g2o_full_information_roundtrip(tmp_path):
    """Hand-written reference-format file with NON-isotropic information:
    import must keep the full 3×3 (whitening BA exactly), and export must
    reproduce it (graph_g2o.cpp:685-770 reads full upper-triangular)."""
    from putslam_tpu.io import g2o as g2o_mod

    src = tmp_path / "in.g2o"
    info3 = np.array([[100.0, 0.5, 0.0], [0.5, 25.0, -1.0], [0.0, -1.0, 4.0]])
    info6 = np.diag([10.0, 10.0, 10.0, 40.0, 40.0, 40.0])
    up3 = " ".join(str(info3[i, j]) for i in range(3) for j in range(i, 3))
    up6 = " ".join(str(info6[i, j]) for i in range(6) for j in range(i, 6))
    src.write_text(
        "VERTEX_SE3:QUAT 0 0 0 0 0 0 0 1\n"
        "VERTEX_SE3:QUAT 1 0.1 0 0 0 0 0 1\n"
        "FIX 0\n"
        f"VERTEX_TRACKXYZ {g2o_mod.LANDMARK_ID_BASE} 0.5 0.2 2.0\n"
        f"EDGE_SE3:QUAT 0 1 0.1 0 0 0 0 0 1 {up6}\n"
        f"EDGE_SE3_TRACKXYZ 0 {g2o_mod.LANDMARK_ID_BASE} 0.5 0.2 2.0 {up3}\n")
    kf_pose, kf_valid, lm_pos, lm_valid, g, fixed = g2o_mod.import_graph(
        str(src), 8, 16, 32, 8)
    np.testing.assert_allclose(np.asarray(g.obs_info[0]), info3, atol=1e-5)
    assert abs(float(g.obs_w[0]) - np.trace(info3) / 3.0) < 1e-5
    assert abs(float(g.pp_w[0]) - np.trace(info6) / 6.0) < 1e-5

    out = tmp_path / "out.g2o"
    g2o_mod.export_graph(str(out), kf_pose, kf_valid, lm_pos, lm_valid, g)
    _, _, _, _, g2, _ = g2o_mod.import_graph(str(out), 8, 16, 32, 8)
    np.testing.assert_allclose(np.asarray(g2.obs_info[0]), info3, rtol=1e-4)


# ---------------------------------------------------------------------------
# motion-model (decaying-velocity EKF) wiring
# ---------------------------------------------------------------------------


def _accel_strafe(n, step0=0.01, step1=0.18):
    """Accelerating lateral strafe: per-frame steps ramp linearly from
    ``step0`` to ``step1`` — crosses the VO translation sanity gate (0.1 m)
    mid-run, so frame-to-frame VO drops to identity there."""
    steps = np.linspace(step0, step1, n - 1)
    x = np.concatenate([[0.0], np.cumsum(steps)]) - 1.4
    t = np.stack([x, np.zeros(n), np.full(n, -0.5)], -1).astype(np.float32)
    q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1))
    return np.concatenate([t, q], -1)


@pytest.mark.slow
def test_motion_model_rescues_vo_gate_failures():
    from putslam_tpu.config import tiny_test_config
    from putslam_tpu.io import synthetic
    from putslam_tpu.models import slam as slam_mod
    from putslam_tpu.eval import ate
    import dataclasses as dc

    base = tiny_test_config()
    poses = jnp.asarray(_accel_strafe(26))
    grays, depths = synthetic.render_sequence(base.camera, poses)
    gt = np.asarray(poses)

    results = {}
    for enabled in (False, True):
        cfg = base.replace(
            motion_model=dc.replace(base.motion_model, enabled=enabled))
        est, outs, _ = slam_mod.run_slam(cfg, grays, depths,
                                         init_pose=poses[0])
        results[enabled] = (ate.ate_rmse_aligned_frames(gt, est),
                            np.asarray(outs.vo_ok))
    # the gate really trips (otherwise this test proves nothing)
    assert (~results[True][1]).sum() >= 3, results[True][1]
    err_off, err_on = float(results[False][0]), float(results[True][0])
    # the EKF prior must rescue tracking: large improvement, small absolute
    assert err_on < 0.5 * err_off, (err_on, err_off)
    assert err_on < 0.25, err_on


# ---------------------------------------------------------------------------
# disk-based TUM pipeline: write → file-play → evaluate with the
# REFERENCE's own scripts
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_disk_tum_roundtrip_chunked_slam_and_reference_eval(tmp_path):
    import os
    import sys
    from putslam_tpu.config import tiny_test_config
    from putslam_tpu.io import synthetic, tum
    from putslam_tpu.models import slam as slam_mod
    from putslam_tpu.eval import ate

    cfg = tiny_test_config()
    poses = synthetic.handheld_trajectory(14, seed=1, step_t=0.02,
                                          step_r=0.012)
    grays, depths = synthetic.render_sequence(cfg.camera, poses)
    root = str(tmp_path / "seq")
    tum.write_tum_dataset(root, np.asarray(grays), np.asarray(depths),
                          gt_poses=np.asarray(poses))

    ds = tum.TumDataset(root, depth_scale=5000.0)
    assert len(ds) == 14
    f0 = ds[0]
    assert np.abs(f0.gray - np.asarray(grays[0])).max() < 1 / 255 + 1e-6
    assert np.abs(f0.depth - np.asarray(depths[0])).max() < 1.1 / 5000

    # file-played frames in wire format through the CHUNKED scan path
    # (tail chunk padded) — must match the in-memory result contract
    g_u8 = np.stack([np.clip(ds[i].gray * 255 + 0.5, 0, 255).astype(np.uint8)
                     for i in range(len(ds))])
    d_u16 = np.stack([np.clip(ds[i].depth * 5000 + 0.5, 0,
                              65535).astype(np.uint16)
                      for i in range(len(ds))])
    est, outs, st = slam_mod.run_slam(cfg, g_u8, d_u16,
                                      init_pose=jnp.asarray(poses[0]),
                                      chunk_size=5)
    assert est.shape == (14, 7)
    gt = np.asarray(poses)
    our_ate = float(ate.ate_rmse_aligned_frames(gt, est))
    assert our_ate < 0.2, our_ate

    # score the same trajectories with the reference's own scripts
    if not os.path.isdir("/root/reference/scripts"):
        pytest.skip("reference scripts not mounted")
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "tools"))
    import run_reference_eval as ref_eval

    ts = np.arange(14) / 30.0
    est_file = str(tmp_path / "est.txt")
    tum.save_trajectory(est_file, ts, est)
    ref_ate = float(ref_eval.evaluate(
        "ate", os.path.join(root, "groundtruth.txt"), est_file).strip())
    # same Horn-alignment math → the reference's number equals ours
    assert abs(ref_ate - our_ate) < 5e-4 + 0.02 * our_ate, (ref_ate, our_ate)

