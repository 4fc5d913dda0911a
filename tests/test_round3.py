"""Round-3 feature tests: keyframe ring-wrap generation guard, reprojection
BA factor, full-information (uncertainty) observations, guided-match retry
ladder, and the end-of-run final optimization.

Reference contracts exercised here: keyframe marginalization soundness
(src/Map/featuresMap.cpp:1056-1104), the custom reprojection g2o edge
(3rdParty/g2o/g2o/types/slam3d/edge_se3_pointxyz_reprojectionError.h:27-94),
useUncertainty information matrices (src/Grabber/depthSensorModel.cpp:28-59),
the matchXYZ widened-radius retry (src/PUTSLAM/PUTSLAM.cpp:788-798), and the
final full-graph optimization before export (src/Map/featuresMap.cpp:980-1025).
"""

import dataclasses
import pytest

import jax
import jax.numpy as jnp
import numpy as np

from putslam_tpu.backend import factors, graph, optimize as opt
from putslam_tpu.config import tiny_test_config
from putslam_tpu.eval import ate
from putslam_tpu.frontend.detector import detect_and_describe
from putslam_tpu.geometry import se3
from putslam_tpu.io import synthetic
from putslam_tpu.models import slam
from putslam_tpu.slam_map import features_map as fm


def small_slam_cfg():
    cfg = tiny_test_config()
    return cfg.replace(map=dataclasses.replace(
        cfg.map, add_features_when_measurements_less_than=10))


# ---------------------------------------------------------------------------
# keyframe ring-wrap generation guard
# ---------------------------------------------------------------------------


def test_keyframe_recycling_bumps_generation_and_clears_covis():
    cfg = small_slam_cfg()
    cfg = cfg.replace(map=dataclasses.replace(cfg.map, max_keyframes=4))
    m = fm.init_map(cfg)
    for i in range(4):
        p = se3.make_pose(jnp.array([0.1 * i, 0.0, 0.0]), se3.quat_identity())
        m, idx = fm.add_keyframe(cfg, m, p, jnp.float32(0.8))
    assert int(m.n_kf) == 4
    assert np.all(np.asarray(m.kf_gen) == 0)
    covis_01 = float(m.covis[1, 0])
    assert covis_01 > 0
    # 5th keyframe recycles ring slot 0 → generation bump + covis row clear
    m, idx = fm.add_keyframe(cfg, m, se3.identity(), jnp.float32(0.5))
    assert int(idx) == 0
    assert int(m.kf_gen[0]) == 1
    assert int(m.kf_seq[0]) == 4
    # the recycled slot's old covisibility (to slot 1) is gone; only the new
    # edge to the previous keyframe (slot 3) remains
    assert float(m.covis[0, 1]) == 0.0
    assert float(m.covis[1, 0]) == 0.0
    assert float(m.covis[0, 3]) > 0


def test_stale_edges_masked_after_ring_wrap():
    """Observations and pose-pose edges stamped with an old keyframe slot
    generation must contribute zero weight to BA after the slot is reused."""
    cfg = small_slam_cfg()
    cfg = cfg.replace(map=dataclasses.replace(cfg.map, max_keyframes=4))
    bcfg = cfg.backend
    m = fm.init_map(cfg)
    for i in range(4):
        p = se3.make_pose(jnp.array([0.1 * i, 0.0, 0.0]), se3.quat_identity())
        m, _ = fm.add_keyframe(cfg, m, p, jnp.float32(0.8))

    lm_pos = jnp.array([[0.0, 0.0, 2.0]] * 4)
    lm_valid = jnp.array([True] * 4)
    lm_gen = jnp.zeros((4,), jnp.int32)
    g = graph.init_graph(16, 8)
    # a GOOD observation from slot 1 (gen 0) and one from slot 3 (gen 0)
    g = graph.add_observations(
        g, jnp.array([1, 3], jnp.int32), jnp.array([0, 1], jnp.int32),
        jnp.array([[55.5, 0.0, 2.0], [0.0, 0.0, 2.0]]),  # slot-1 obs = garbage
        jnp.array([1.0, 1.0]), jnp.array([True, True]),
        gen=jnp.zeros((2,), jnp.int32),
        kf_gen=m.kf_gen[jnp.array([1, 3])])
    g = graph.add_pose_pose(g, 1, 3, se3.identity(), 10.0, True,
                            gen_i=m.kf_gen[1], gen_j=m.kf_gen[3])

    # wrap the ring twice: slots 0 and 1 recycled → slot 1 gen becomes 1
    m, _ = fm.add_keyframe(cfg, m, se3.identity(), jnp.float32(0.5))
    m, _ = fm.add_keyframe(cfg, m, se3.identity(), jnp.float32(0.5))
    assert int(m.kf_gen[1]) == 1

    r, Jp, Jl, w, sq = opt._assemble_obs(
        bcfg, m.kf_pose, lm_pos, lm_valid, g,
        lm_gen=lm_gen, kf_gen=m.kf_gen)
    w = np.asarray(w)
    assert w[0] == 0.0, "stale observation (recycled kf slot) must be masked"
    assert w[1] > 0.0, "fresh observation must survive"

    pi = m.kf_pose[g.pp_i]
    pj = m.kf_pose[g.pp_j]
    r6 = factors.pp_residual(pi, pj, g.pp_rel)
    wpp, _ = opt._pp_weights(bcfg, g, r6, m.kf_gen)
    assert float(wpp[0]) == 0.0, "stale pose-pose edge must be masked"

    # without the generation guard the garbage edge would poison BA
    res = opt.optimize_graph(bcfg, m.kf_pose, m.kf_valid, lm_pos, lm_valid,
                             g, jnp.zeros((4,), bool).at[0].set(True),
                             lm_gen=lm_gen, kf_gen=m.kf_gen)
    assert np.isfinite(np.asarray(res.kf_pose)).all()
    assert abs(float(res.lm_pos[0, 0])) < 1.0  # not dragged to x=55


@pytest.mark.slow
def test_slam_survives_keyframe_ring_wrap():
    """End-to-end: a run producing more keyframes than the ring capacity must
    stay consistent (the round-2 engine silently re-bound old edges to the
    new ring occupant)."""
    cfg = small_slam_cfg()
    cfg = cfg.replace(map=dataclasses.replace(
        cfg.map, max_keyframes=8, covisibility_keyframe=0.999,
        add_features_when_measurements_less_than=10))
    poses_gt = synthetic.orbit_trajectory(40, radius=0.15, yaw_amp=0.15)
    grays, depths = synthetic.render_sequence(cfg.camera, poses_gt)
    gt = np.asarray(poses_gt)
    est, outs, st = slam.run_slam(cfg, np.asarray(grays), np.asarray(depths),
                                  init_pose=gt[0])
    assert int(st.map.n_kf) > 8, "test must actually wrap the ring"
    assert np.isfinite(est).all()
    a = ate.ate_rmse_aligned_frames(gt, est)
    assert a < 0.15, a


# ---------------------------------------------------------------------------
# reprojection BA factor
# ---------------------------------------------------------------------------


def _toy_ba_problem(rng, n_lm=24, noise=0.0):
    """2 keyframes (first fixed), n_lm landmarks in front of both cameras."""
    K = 4
    gt_pose1 = se3.make_pose(
        jnp.array([0.12, -0.04, 0.06]),
        se3.exp(jnp.array([0, 0, 0, 0.03, -0.02, 0.04]))[3:])
    kf_pose = jnp.tile(se3.identity(), (K, 1))
    kf_pose_gt = kf_pose.at[1].set(gt_pose1)
    kf_valid = jnp.zeros((K,), bool).at[0].set(True).at[1].set(True)

    lm = jnp.asarray(rng.uniform([-1, -0.8, 1.5], [1, 0.8, 3.5], (n_lm, 3)),
                     jnp.float32)
    L = 32
    lm_pos_gt = jnp.zeros((L, 3)).at[:n_lm].set(lm)
    lm_valid = jnp.zeros((L,), bool).at[:n_lm].set(True)

    g = graph.init_graph(128, 8)
    for k in range(2):
        T = kf_pose_gt[k]
        z = se3.apply(se3.inverse(T), lm)                     # (n_lm, 3)
        if noise:
            z = z + jnp.asarray(rng.normal(0, noise, z.shape), jnp.float32)
        g = graph.add_observations(
            g, jnp.full((n_lm,), k, jnp.int32),
            jnp.arange(n_lm, dtype=jnp.int32), z,
            jnp.full((n_lm,), 100.0), jnp.ones((n_lm,), bool))

    # perturbed initialization
    pert = se3.retract(gt_pose1, jnp.array([0.05, -0.03, 0.04,
                                            0.02, 0.03, -0.02]))
    kf_pose_init = kf_pose.at[1].set(pert)
    lm_init = lm_pos_gt + jnp.asarray(
        rng.normal(0, 0.01, lm_pos_gt.shape), jnp.float32) * lm_valid[:, None]
    fixed = jnp.zeros((K,), bool).at[0].set(True)
    return (kf_pose_init, kf_pose_gt, kf_valid, lm_init, lm_pos_gt,
            lm_valid, g, fixed)


def test_reproj_jacobians_match_autodiff(rng):
    pose = se3.make_pose(jnp.array([0.2, 0.1, -0.05]),
                         se3.exp(jnp.array([0, 0, 0, 0.1, -0.2, 0.15]))[3:])
    lm = jnp.array([0.4, -0.3, 2.5])
    z = jnp.array([0.38, -0.29, 2.45])
    fu, fv = 80.0, 80.0

    Jp, Jl = factors.reproj_jacobians(pose[None], lm[None], fu, fv)

    def r_of_xi(xi):
        return factors.reproj_residual(se3.retract(pose, xi), lm, z, fu, fv)

    def r_of_dl(dl):
        return factors.reproj_residual(pose, lm + dl, z, fu, fv)

    Jp_ad = jax.jacfwd(r_of_xi)(jnp.zeros(6))
    Jl_ad = jax.jacfwd(r_of_dl)(jnp.zeros(3))
    np.testing.assert_allclose(np.asarray(Jp[0]), np.asarray(Jp_ad),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(Jl[0]), np.asarray(Jl_ad),
                               rtol=1e-4, atol=1e-4)


def test_reprojection_factor_recovers_pose(rng):
    (kf0, kf_gt, kf_valid, lm0, lm_gt, lm_valid, g, fixed) = \
        _toy_ba_problem(rng)
    cfg = tiny_test_config()
    err0 = float(jnp.linalg.norm(kf0[1, :3] - kf_gt[1, :3]))

    results = {}
    for et in (0, 1):
        bcfg = dataclasses.replace(
            cfg.backend, error_type=et, gn_iterations=8,
            robust_kernel="none", obs_pixel_sigma=1.0)
        res = opt.optimize_graph(bcfg, kf0, kf_valid, lm0, lm_valid, g,
                                 fixed, cam=cfg.camera)
        err = float(jnp.linalg.norm(res.kf_pose[1, :3] - kf_gt[1, :3]))
        results[et] = (res, err)
        assert err < 0.25 * err0, (et, err, err0)
        chi2 = np.asarray(res.chi2)
        assert chi2[-1] < chi2[0]

    # the two factor types must agree on the solution (noise-free problem)
    p3 = np.asarray(results[0][0].kf_pose[1])
    p2 = np.asarray(results[1][0].kf_pose[1])
    np.testing.assert_allclose(p3[:3], p2[:3], atol=5e-3)


def test_reprojection_weights_are_pixel_based(rng):
    """error_type=1 must weight pixel residuals by 1/obs_pixel_sigma², not
    by the stored metres⁻² obs_w (which miscalibrates the robust kernel and
    chi² pruning by orders of magnitude)."""
    (kf0, kf_gt, kf_valid, lm0, lm_gt, lm_valid, g, fixed) = \
        _toy_ba_problem(rng)
    cfg = tiny_test_config()
    bcfg = dataclasses.replace(cfg.backend, error_type=1,
                               robust_kernel="none", obs_pixel_sigma=2.0)
    r, Jp, Jl, w, sq = opt._assemble_obs(bcfg, kf0, lm0, lm_valid, g,
                                         cam=cfg.camera)
    w = np.asarray(w)
    active = w[np.asarray(g.obs_valid)]
    # stored obs_w is 100.0; pixel weighting must be 1/σ² = 0.25
    np.testing.assert_allclose(active, 0.25, atol=1e-6)
    assert r.shape[-1] == 2


def test_solvers_agree(rng):
    """The matmul-formulated dense Schur (one-hot matmuls, split-bf16
    curvature) must reproduce the scatter-based f32 path and the
    matrix-free PCG path on the same problem — same chi² trajectory, same
    solution."""
    (kf0, kf_gt, kf_valid, lm0, lm_gt, lm_valid, g, fixed) = \
        _toy_ba_problem(rng, noise=0.01)
    cfg = tiny_test_config()
    sols = {}
    for solver in ("dense_schur", "dense_schur_mm", "pcg"):
        bcfg = dataclasses.replace(cfg.backend, solver=solver,
                                   gn_iterations=6, robust_kernel="none")
        res = opt.optimize_graph(bcfg, kf0, kf_valid, lm0, lm_valid, g,
                                 fixed)
        sols[solver] = res
    ref = np.asarray(sols["dense_schur"].kf_pose[1])
    for solver in ("dense_schur_mm", "pcg"):
        got = np.asarray(sols[solver].kf_pose[1])
        np.testing.assert_allclose(got, ref, atol=2e-4)
        chi_ref = float(sols["dense_schur"].chi2[-1])
        chi = float(sols[solver].chi2[-1])
        assert abs(chi - chi_ref) < 0.02 * max(chi_ref, 1e-6), solver


def test_schur_subtrahend_mm_matches_f32(rng):
    """The matmul Schur subtrahend agrees with the same products in f32 to
    ~16 significant bits (split-bf16 operands), not the ~8 of one bf16
    pass, which stalls the solve on long keyframe chains."""
    K, L, M = 6, 40, 160
    obs_kf = jnp.asarray(rng.integers(0, K, M), jnp.int32)
    obs_lm = jnp.asarray(rng.integers(0, L, M), jnp.int32)
    F = jnp.asarray(rng.normal(size=(M, 6, 3)), jnp.float32)
    got = np.asarray(opt.schur_subtrahend_mm(obs_kf, obs_lm, F, K, L))
    G = np.zeros((K, 6, L, 3))
    np.add.at(G, (np.asarray(obs_kf), slice(None), np.asarray(obs_lm)),
              np.asarray(F, np.float64))
    G = G.reshape(K * 6, L * 3)
    want = G @ G.T
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-4, err


# ---------------------------------------------------------------------------
# full-information (useUncertainty) observations
# ---------------------------------------------------------------------------


def test_anisotropic_information_shapes_solution():
    """Two fixed cameras at the same pose observe one landmark with
    conflicting z: the observation whose information matrix distrusts z must
    lose — the landmark settles at the information-weighted mean, not the
    arithmetic mean (depthSensorModel.cpp:28-59 semantics)."""
    cfg = tiny_test_config()
    K, L = 4, 4
    kf_pose = jnp.tile(se3.identity(), (K, 1))
    kf_valid = jnp.zeros((K,), bool).at[0].set(True).at[1].set(True)
    fixed = jnp.ones((K,), bool)  # both cameras fixed → landmark-only solve
    lm_pos = jnp.zeros((L, 3)).at[0].set(jnp.array([0.0, 0.0, 2.2]))
    lm_valid = jnp.zeros((L,), bool).at[0].set(True)

    info_a = jnp.eye(3) * 100.0
    info_b = jnp.diag(jnp.array([100.0, 100.0, 1.0]))  # distrusts z
    g = graph.init_graph(16, 4)
    g = graph.add_observations(
        g, jnp.array([0, 1], jnp.int32), jnp.array([0, 0], jnp.int32),
        jnp.array([[0.0, 0.0, 2.0], [0.0, 0.0, 2.4]]),
        jnp.array([100.0, 100.0]), jnp.array([True, True]),
        info=jnp.stack([info_a, info_b]))

    # scalar weights → arithmetic mean z ≈ 2.2
    bcfg = dataclasses.replace(cfg.backend, robust_kernel="none",
                               gn_iterations=4, use_obs_info=False)
    res_s = opt.optimize_graph(bcfg, kf_pose, kf_valid, lm_pos, lm_valid,
                               g, fixed)
    assert abs(float(res_s.lm_pos[0, 2]) - 2.2) < 0.01

    # full information → z pulled to the trusted observation: (100·2+1·2.4)/101
    bcfg_i = dataclasses.replace(bcfg, use_obs_info=True)
    res_i = opt.optimize_graph(bcfg_i, kf_pose, kf_valid, lm_pos, lm_valid,
                               g, fixed)
    z = float(res_i.lm_pos[0, 2])
    assert abs(z - (100 * 2.0 + 2.4) / 101.0) < 0.01, z


@pytest.mark.slow
def test_slam_runs_with_uncertainty_enabled():
    cfg = small_slam_cfg()
    cfg = cfg.replace(
        map=dataclasses.replace(cfg.map, use_uncertainty=True),
        backend=dataclasses.replace(cfg.backend, use_obs_info=True))
    poses_gt = synthetic.orbit_trajectory(16, radius=0.15, yaw_amp=0.15)
    grays, depths = synthetic.render_sequence(cfg.camera, poses_gt)
    gt = np.asarray(poses_gt)
    est, outs, st = slam.run_slam(cfg, np.asarray(grays), np.asarray(depths),
                                  init_pose=gt[0])
    assert np.isfinite(est).all()
    a = ate.ate_rmse_aligned_frames(gt, est)
    # sanity gate only: whitened chi² under Cauchy δ=1 weighs edges more
    # aggressively than the scalar mode on this low-focal synthetic rig;
    # the *direction* of the information weighting is asserted exactly in
    # test_anisotropic_information_shapes_solution
    assert a < 0.2, a


# ---------------------------------------------------------------------------
# guided-match retry ladder
# ---------------------------------------------------------------------------


def test_guided_match_radius_scale_recovers_offset():
    cfg = small_slam_cfg()
    g0, d0 = synthetic.render_frame(cfg.camera, se3.identity())
    st = slam.slam_init(cfg, g0, d0)
    feat = detect_and_describe(cfg, g0, d0)
    # a pose guess displaced well beyond the base search sphere
    bad_guess = se3.make_pose(jnp.array([0.4, 0.0, 0.0]), se3.quat_identity())
    gm1 = fm.guided_match(cfg, st.map, bad_guess, feat, radius_scale=1.0)
    gm4 = fm.guided_match(cfg, st.map, bad_guess, feat, radius_scale=8.0)
    assert int(np.asarray(gm1.valid).sum()) == 0
    assert int(np.asarray(gm4.valid).sum()) > 20


@pytest.mark.slow
def test_retry_ladder_recovers_degraded_frame():
    """With the ladder enabled a badly predicted pose still yields a map fix
    (PUTSLAM.cpp:788-798); with retries disabled the same frame fails."""
    base = small_slam_cfg().replace(max_map_correction=1.0)
    g0, d0 = synthetic.render_frame(base.camera, se3.identity())

    results = {}
    for retries in (0, 3):
        cfg = base.replace(matcher=dataclasses.replace(
            base.matcher, retries=retries, retry_radius_growth=2.0))
        st = slam.slam_init(cfg, g0, d0)
        st = st._replace(pose=se3.make_pose(jnp.array([0.4, 0.0, 0.0]),
                                            se3.quat_identity()))
        st2, outs = slam.slam_step(cfg, st, g0, d0)
        results[retries] = outs
    assert not bool(results[0].map_ok)
    assert bool(results[3].map_ok)
    # the recovered pose must be back near the true (identity) pose
    assert float(jnp.linalg.norm(results[3].pose[:3])) < 0.05


# ---------------------------------------------------------------------------
# trajectory sanity repair (checkTrajectory / cleanCamTrajectory)
# ---------------------------------------------------------------------------


def test_check_trajectory_repairs_diverged_keyframe():
    cfg = small_slam_cfg()
    K = cfg.map.max_keyframes
    m = fm.init_map(cfg)
    g = graph.init_graph(64, 32)
    # 5 keyframes walking +x in 0.1 m steps, with odometry edges
    step = se3.make_pose(jnp.array([0.1, 0.0, 0.0]), se3.quat_identity())
    pose = se3.identity()
    prev_idx = None
    for i in range(5):
        m, idx = fm.add_keyframe(cfg, m, pose, jnp.float32(0.8))
        if prev_idx is not None:
            g = graph.add_pose_pose(g, prev_idx, idx, step, 100.0, True,
                                    gen_i=m.kf_gen[prev_idx],
                                    gen_j=m.kf_gen[idx])
        prev_idx = idx
        pose = se3.compose(pose, step)

    # a loop-closure (non-odometry) edge and an invalid edge must not leak
    # into the odometry table (regression: non-odo rows used to scatter
    # into a real ring slot, racing genuine odometry writes there)
    K = cfg.map.max_keyframes
    lc_rel = se3.make_pose(jnp.array([9.0, 9.0, 9.0]), se3.quat_identity())
    g = graph.add_pose_pose(g, 0, 3, lc_rel, 200.0, True,
                            gen_i=m.kf_gen[0], gen_j=m.kf_gen[3])
    g = graph.add_pose_pose(g, K - 1, K - 1, lc_rel, 1.0, False)

    # corrupt keyframe 2: a 1 m jump that contradicts its odometry edge
    m_bad = m._replace(kf_pose=m.kf_pose.at[2, 0].add(1.0))
    repaired, n_rep = slam.check_trajectory(cfg, m_bad, g)
    assert int(n_rep) >= 1
    got = np.asarray(repaired[:5, 0])
    # kf2 back on the odometry chain; kf3/kf4 rigid relative to kf2 again
    np.testing.assert_allclose(got, [0.0, 0.1, 0.2, 0.3, 0.4], atol=1e-5)

    # a clean trajectory passes through untouched
    same, n0 = slam.check_trajectory(cfg, m, g)
    np.testing.assert_allclose(np.asarray(same[:5]), np.asarray(m.kf_pose[:5]),
                               atol=1e-5)
    assert int(n0) == 0


# ---------------------------------------------------------------------------
# end-of-run final optimization
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_final_optimization_and_reanchoring():
    cfg = small_slam_cfg()
    poses_gt = synthetic.orbit_trajectory(30, radius=0.15, yaw_amp=0.15)
    grays, depths = synthetic.render_sequence(cfg.camera, poses_gt)
    gt = np.asarray(poses_gt)
    pb, pa, outs, st = slam.run_slam_final(
        cfg, np.asarray(grays), np.asarray(depths), init_pose=gt[0])
    a_before = ate.ate_rmse_aligned_frames(gt, pb)
    a_after = ate.ate_rmse_aligned_frames(gt, pa)
    assert np.isfinite(pa).all()
    assert a_before < 0.08
    # the polish must never make the trajectory meaningfully worse, and the
    # weak-feature removal must have pruned something on this short run
    assert a_after < a_before + 0.005, (a_before, a_after)
    assert int(st.map.lm_valid.sum()) > 0
