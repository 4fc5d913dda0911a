"""Round-5 additions: engine-integrated distributed BA, overflow
enforcement, vectorized archive, RPE gate support.

Reference contracts: featuresMap.cpp:881-1026 (continuous optimization in
the loop), featuresMap.cpp:980-1025 (final optimization)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from putslam_tpu.config import tiny_test_config
from putslam_tpu.io import synthetic
from putslam_tpu.models import slam as slam_mod
from putslam_tpu.parallel import mesh as mesh_mod


def _small_run(n_frames=6):
    cfg = tiny_test_config()
    poses = synthetic.orbit_trajectory(n_frames, radius=0.05, yaw_amp=0.05)
    grays, depths = synthetic.render_sequence(cfg.camera, poses)
    st = slam_mod.slam_init(cfg, jnp.asarray(grays[0]), jnp.asarray(depths[0]))
    st, outs = slam_mod.slam_sequence(cfg, st, jnp.asarray(grays[1:]),
                                      jnp.asarray(depths[1:]))
    return cfg, st, poses


@pytest.mark.slow
def test_finalize_dist_matches_single_device():
    """The engine-integrated distributed finalize must land where the
    single-device finalize lands (same release/prune/polish contract,
    landmark axis sharded over the 8-device mesh)."""
    cfg, st, _ = _small_run()
    mesh = mesh_mod.make_mesh(8, axis="lm")
    st_single = slam_mod.finalize(cfg, st)
    st_dist = slam_mod.finalize_dist(cfg, st, mesh)
    kv = np.asarray(st.map.kf_valid)
    a = np.asarray(st_single.map.kf_pose)[kv]
    b = np.asarray(st_dist.map.kf_pose)[kv]
    # split-bf16 Schur curvature vs f32 scatter path: direction-only drift
    np.testing.assert_allclose(a, b, atol=5e-3)


@pytest.mark.slow
def test_global_ba_mesh_path_polishes():
    """global_bundle_adjust(mesh=...) must run the sharded window solves and
    produce keyframes comparable to the single-device sweep."""
    from putslam_tpu.slam_map.archive import MapArchive, global_bundle_adjust

    cfg, st, _ = _small_run()
    arch = MapArchive()
    arch.absorb(st)
    if arch.n_keyframes() < 2 or len(arch.obs) == 0:
        pytest.skip("degenerate tiny run")
    kw = dict(window=8, kf_cap=16, lm_cap=512, obs_cap=2048, pp_cap=64,
              sweeps=1, gn_iterations=4)
    kf_single = global_bundle_adjust(cfg, arch, **kw)
    mesh = mesh_mod.make_mesh(8, axis="lm")
    kf_dist = global_bundle_adjust(cfg, arch, mesh=mesh, **kw)
    np.testing.assert_allclose(kf_single, kf_dist, atol=5e-3)


def test_archive_vectorized_absorb_equivalence():
    """The chunked-array absorb must reproduce the old per-row semantics:
    every live keyframe/landmark snapshotted, fresh valid observations
    captured exactly once across repeated absorbs."""
    from putslam_tpu.slam_map.archive import MapArchive

    cfg, st, _ = _small_run()
    a1 = MapArchive()
    a1.absorb(st)
    n1_kf, n1_obs = a1.n_keyframes(), len(a1.obs)
    # double absorb of the same state must not duplicate edges
    a1.absorb(st)
    assert a1.n_keyframes() == n1_kf
    assert len(a1.obs) == n1_obs
    kf, lm, (obs_kf, obs_lm, obs_xyz, obs_w, obs_info), _ = a1.dense()
    n_valid_kf = int(np.asarray(st.map.kf_valid).sum())
    assert n1_kf == n_valid_kf
    assert len(obs_kf) == n1_obs
    # all edges reference archived vertices
    assert (obs_kf < len(kf)).all() and (obs_lm < len(lm)).all()
    n_valid_obs = int(np.asarray(st.graph.obs_valid).sum())
    assert n1_obs <= n_valid_obs
    assert n1_obs > 0


# ---------------------------------------------------------------------------
# Closed-form SE(3) pose-pose Jacobians (round-5 BA hot-path fix: the
# vmapped-jacfwd implementation was ~60% of a GN iteration at the 1024-edge
# capacity; reference edge: g2o EDGE_SE3:QUAT linearization)
# ---------------------------------------------------------------------------


def test_pp_jacobians_closed_form_matches_autodiff(rng=None):
    from putslam_tpu.backend import factors
    from putslam_tpu.geometry import se3

    rng = np.random.default_rng(11)
    E = 64

    def rand_pose(st, sr):
        t = rng.normal(0, st, (E, 3)).astype(np.float32)
        phi = np.clip(rng.normal(0, sr, (E, 3)), -0.9, 0.9).astype(np.float32)
        q = np.asarray(jax.vmap(se3.so3_exp_quat)(jnp.asarray(phi)))
        return jnp.asarray(np.concatenate([t, q], -1))

    # the oracle runs in f64: the f32 autodiff through so3_log is itself
    # cancellation-noisy at tiny rotations (~6e-2 absolute — measured), so
    # an f32-vs-f32 comparison would test the oracle's noise, not the
    # closed form
    with jax.enable_x64(True):
        for sr in (1e-3, 0.3, 0.8):
            Ti = rand_pose(1.0, sr)
            Tj = rand_pose(1.0, sr)
            Z = rand_pose(0.5, sr * 0.5)
            Ji, Jj = factors.pp_jacobians(Ti, Tj, Z)
            Ji_ad, Jj_ad = factors.pp_jacobians_autodiff(
                jnp.asarray(np.asarray(Ti), jnp.float64),
                jnp.asarray(np.asarray(Tj), jnp.float64),
                jnp.asarray(np.asarray(Z), jnp.float64))
            np.testing.assert_allclose(np.asarray(Ji), np.asarray(Ji_ad),
                                       atol=2e-4)
            np.testing.assert_allclose(np.asarray(Jj), np.asarray(Jj_ad),
                                       atol=2e-4)


def test_se3_jacobian_inverse_identities():
    """Jr⁻¹(ξ)·Jr(ξ) = I via the autodiff Jr, and Ad(T)·ξ exponentiates to
    T·exp(ξ)·T⁻¹."""
    from putslam_tpu.geometry import se3

    rng = np.random.default_rng(5)
    xi = jnp.asarray(np.clip(rng.normal(0, 0.5, (6,)), -0.9, 0.9),
                     jnp.float32)
    f = lambda eta: se3.log(se3.compose(se3.exp(xi), se3.exp(eta)))
    Jr_ad = jax.jacfwd(f)(jnp.zeros(6))
    Jr_inv = se3.se3_right_jacobian_inv(xi)
    np.testing.assert_allclose(np.asarray(Jr_inv @ jnp.linalg.inv(Jr_ad)),
                               np.eye(6), atol=1e-3)
    T = se3.exp(jnp.asarray(np.clip(rng.normal(0, 0.4, (6,)), -0.9, 0.9),
                            jnp.float32))
    eta = jnp.asarray(rng.normal(0, 0.1, (6,)), jnp.float32)
    lhs = se3.compose(T, se3.compose(se3.exp(eta), se3.inverse(T)))
    rhs = se3.exp(se3.adjoint(T) @ eta)
    np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs), atol=1e-4)


def test_rgbdslam_roundtrip(tmp_path):
    """export2RGBDSLAM / importRGBDSLAM parity (graph_g2o.cpp:818-869):
    trajectory round-trips, import builds consecutive identity-info edges
    with the first vertex fixed."""
    from putslam_tpu.geometry import se3
    from putslam_tpu.io import rgbdslam

    rng = np.random.default_rng(2)
    K = 8
    t = rng.normal(0, 0.5, (K, 3)).astype(np.float32)
    phi = rng.normal(0, 0.2, (K, 3)).astype(np.float32)
    q = np.asarray(jax.vmap(se3.so3_exp_quat)(jnp.asarray(phi)))
    kf = jnp.asarray(np.concatenate([t, q], -1))
    valid = jnp.ones((K,), bool).at[3].set(False)
    ts = np.arange(K - 1) * 0.1 + 5.0

    p = str(tmp_path / "traj_rgbd.txt")
    n = rgbdslam.export_rgbdslam(p, kf, valid, ts)
    assert n == K - 1

    kf2, valid2, g, fixed, ts2 = rgbdslam.import_rgbdslam(p, 16, 32)
    assert int(valid2.sum()) == K - 1
    np.testing.assert_allclose(ts2, ts, atol=1e-5)
    live = np.asarray(kf)[np.asarray(valid)]
    np.testing.assert_allclose(np.asarray(kf2)[:K - 1], live, atol=1e-5)
    # consecutive edges with the stored relative motion; first vertex fixed
    assert int(np.asarray(g.pp_valid).sum()) == K - 2
    assert bool(fixed[0]) and int(np.asarray(fixed).sum()) == 1
    from putslam_tpu.backend import factors
    r = factors.pp_residual(kf2[g.pp_i[:K - 2]], kf2[g.pp_j[:K - 2]],
                            g.pp_rel[:K - 2])
    assert float(jnp.abs(r).max()) < 1e-4


def test_degraded_frame_recovery_ladder():
    """The OPT-IN widened-gate rescue (retry_hamming_slack +
    retry_threshold_growth) must recover a frame whose depth noise pushes
    true pair errors past the strict RANSAC gate — the strict-only config
    falls to the identity fallback, the rescue config recovers a pose.
    (Rescue-only adoption: the widened result is used only when the strict
    pass failed outright.)"""
    import dataclasses as dc

    from putslam_tpu.frontend.detector import detect_and_describe
    from putslam_tpu.models import vo as vo_mod

    cfg = tiny_test_config()
    # gate strict enough that the injected depth noise defeats it outright
    cfg = cfg.replace(ransac=dc.replace(cfg.ransac,
                                        inlier_threshold_euclidean=0.008),
                      matcher=dc.replace(cfg.matcher,
                                         retry_hamming_slack=16.0,
                                         retry_threshold_growth=8.0))
    poses = synthetic.orbit_trajectory(3, radius=0.04, yaw_amp=0.03)
    grays, depths = synthetic.render_sequence(cfg.camera, poses)
    rng = np.random.default_rng(0)
    noisy_depth = np.asarray(depths) + rng.normal(
        0, 0.02, np.asarray(depths).shape).astype(np.float32)
    f0 = detect_and_describe(cfg, jnp.asarray(grays[0]),
                             jnp.asarray(noisy_depth[0]))
    f1 = detect_and_describe(cfg, jnp.asarray(grays[1]),
                             jnp.asarray(noisy_depth[1]))
    key = jax.random.PRNGKey(4)

    cfg_off = cfg.replace(matcher=dc.replace(cfg.matcher,
                                             retry_hamming_slack=0.0,
                                             retry_threshold_growth=1.0))
    res_off = vo_mod.vo_step(cfg_off, key, f0, f1)
    res = vo_mod.vo_step(cfg, key, f0, f1)
    assert not bool(res_off.ok)      # strict pass genuinely fails here
    assert bool(res.ok)              # the rescue recovers a pose
    # and the recovered increment is sane (small true motion)
    assert float(jnp.linalg.norm(res.rel_pose[:3])) < 0.1


def test_affine_patch_alignment_recovers_warp():
    """The 6-DoF warped alignment (MatchingOnPatches warping option,
    MatchingOnPatches.h:37-66) must recover a known shift on a synthetic
    textured pair, at least as well as the translational refine."""
    from putslam_tpu.config import TrackerConfig
    from putslam_tpu.ops import klt

    rng = np.random.default_rng(6)
    H = W = 96
    base = rng.uniform(0, 1, (H + 8, W + 8)).astype(np.float32)
    # smooth the noise so gradients are informative
    k = np.ones((3, 3)) / 9.0
    from scipy.signal import convolve2d  # available? fall back manual
    sm = convolve2d(base, k, mode="same")
    ref = jnp.asarray(sm[4:H + 4, 4:W + 4])
    # target = ref shifted by (1.3, -0.8)
    sx, sy = 1.3, -0.8
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    u = np.clip(xx + 4 - sx, 0, W + 6.999)
    v = np.clip(yy + 4 - sy, 0, H + 6.999)
    x0 = np.floor(u).astype(int); y0 = np.floor(v).astype(int)
    du = u - x0; dv = v - y0
    tgt = (sm[y0, x0] * (1 - du) * (1 - dv) + sm[y0, x0 + 1] * du * (1 - dv)
           + sm[y0 + 1, x0] * (1 - du) * dv + sm[y0 + 1, x0 + 1] * du * dv)
    tgt = jnp.asarray(tgt.astype(np.float32))

    pts = jnp.asarray(np.array([[40.0, 40.0], [56.0, 30.0], [30.0, 60.0]],
                               np.float32))
    tcfg = TrackerConfig(win_size=9, max_iter=30, eps=1e-3,
                         error_threshold=30.0)
    res = klt.refine_patch_alignment_affine(
        tcfg, ref, tgt, pts, pts, jnp.ones((3,), bool))
    flow = np.asarray(res.pts - pts)
    assert np.all(np.abs(flow[:, 0] - sx) < 0.15), flow
    assert np.all(np.abs(flow[:, 1] - sy) < 0.15), flow


def test_se2_pose_graph_converges():
    """SE(2) planar pose-graph GN (putslam_defs.h:244-529 Vertex/EdgeSE2):
    a noisy square loop with an exact loop-closure edge must snap back to
    the ground truth."""
    from putslam_tpu.geometry import se2

    gt = jnp.asarray(np.array([
        [0, 0, 0], [1, 0, np.pi / 2], [1, 1, np.pi],
        [0, 1, -np.pi / 2]], np.float32))
    rng = np.random.default_rng(3)
    noise = np.zeros((4, 3), np.float32)
    noise[1:] = rng.normal(0, 0.08, (3, 3)).astype(np.float32)
    init = gt + jnp.asarray(noise)
    ei = jnp.asarray([0, 1, 2, 3], jnp.int32)
    ej = jnp.asarray([1, 2, 3, 0], jnp.int32)
    z = se2.relative(gt[ei], gt[ej])
    w = jnp.full((4,), 100.0)
    fixed = jnp.zeros((4,), bool).at[0].set(True)
    out, chi2 = se2.optimize_pose_graph(init, (ei, ej, z, w), fixed,
                                        iterations=15)
    assert float(chi2[-1]) < 1e-4 * max(float(chi2[0]), 1e-9) + 1e-8
    err = np.abs(np.asarray(out[:, :2]) - np.asarray(gt[:, :2]))
    assert err.max() < 1e-3, err
    # composition/inverse identities
    a = jnp.asarray([0.3, -0.2, 0.7])
    b = jnp.asarray([-0.1, 0.5, -1.2])
    np.testing.assert_allclose(
        np.asarray(se2.compose(a, se2.inverse(a))), np.zeros(3), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(se2.relative(a, se2.compose(a, b))), np.asarray(b),
        atol=1e-5)



@pytest.mark.parametrize("loop_closure", [False, True])
def test_scan_state_types_stable_across_chunks(loop_closure):
    """The state slam_sequence returns has the types it was given (dtype,
    shape and weak type of every leaf), so the next streamed chunk reuses
    the compiled scan instead of compiling it again."""
    cfg = tiny_test_config()
    cfg = cfg.replace(loop_closure=dataclasses.replace(
        cfg.loop_closure, enabled=loop_closure))
    poses = synthetic.orbit_trajectory(3, radius=0.05, yaw_amp=0.05)
    grays, depths = synthetic.render_sequence(cfg.camera, poses)
    st = slam_mod.slam_init(cfg, grays[0], depths[0], poses[0])
    st2, _ = slam_mod.slam_sequence(cfg, st, grays[1:], depths[1:])
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(st)[0],
                            jax.tree.leaves(st2)):
        assert (jax.typeof(a), a.weak_type) == (jax.typeof(b), b.weak_type), \
            jax.tree_util.keystr(path)
