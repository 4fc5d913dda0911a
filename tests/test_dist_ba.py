import pytest

pytestmark = pytest.mark.slow
import jax
import jax.numpy as jnp
import numpy as np

from putslam_tpu.backend import graph, optimize
from putslam_tpu.config import BackendConfig
from putslam_tpu.parallel import dist_ba, mesh as mesh_mod

from test_backend import build_problem


def test_dist_ba_matches_single_device(rng):
    kf_true, lm_true, kf_init, lm_init, g = build_problem(
        rng, K=6, L=64, obs_per_kf=48, noise=0.003)
    K, L = kf_init.shape[0], lm_init.shape[0]
    bcfg = BackendConfig(gn_iterations=4, robust_kernel="cauchy", damping=1e-5)
    fixed = jnp.zeros((K,), bool).at[0].set(True)
    lm_gen = jnp.zeros((L,), jnp.int32)

    res = optimize.gauss_newton(
        bcfg, jnp.asarray(kf_init), jnp.ones((K,), bool),
        jnp.asarray(lm_init), jnp.ones((L,), bool), g, fixed, lm_gen)

    m = mesh_mod.make_mesh(8, axis="lm")
    kf_d, lm_d, chi2_d, ovf = dist_ba.dist_gauss_newton(
        bcfg, m, jnp.asarray(kf_init), jnp.ones((K,), bool),
        jnp.asarray(lm_init), jnp.ones((L,), bool), g, fixed, lm_gen)

    # dist_ba builds its Schur coupling through the split-bf16 matmul path
    # (optimize.schur_subtrahend_mm) while the single-device scatter
    # reference is all-f32: curvature differs in the last bits (direction
    # only — the gradient is f32-exact in both), so the chi² descent path
    # may drift slightly
    np.testing.assert_allclose(np.asarray(res.chi2), np.asarray(chi2_d),
                               rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(res.kf_pose), np.asarray(kf_d),
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(res.lm_pos), np.asarray(lm_d),
                               atol=5e-3)
    assert int(ovf) == 0


def test_dist_ba_converges(rng):
    kf_true, lm_true, kf_init, lm_init, g = build_problem(rng, noise=0.0)
    K, L = kf_init.shape[0], lm_init.shape[0]
    bcfg = BackendConfig(gn_iterations=6, robust_kernel="none", damping=1e-5)
    fixed = jnp.zeros((K,), bool).at[0].set(True)
    m = mesh_mod.make_mesh(8, axis="lm")
    kf_d, lm_d, chi2, ovf = dist_ba.dist_gauss_newton(
        bcfg, m, jnp.asarray(kf_init), jnp.ones((K,), bool),
        jnp.asarray(lm_init), jnp.ones((L,), bool), g, fixed,
        jnp.zeros((L,), jnp.int32))
    chi = np.asarray(chi2)
    assert chi[-1] < 1e-4 * chi[0] + 1e-8
    err_t = np.abs(np.asarray(kf_d)[:, :3] - kf_true[:, :3])
    assert err_t.max() < 2e-3


def test_dist_ba_reports_partition_overflow(rng):
    """Skewed ownership: every edge lands on device 0's landmarks, so
    the 2x-slack per-device slice overflows and the solver must SAY so
    (silent edge-dropping is a correctness landmine)."""
    kf_true, lm_true, kf_init, lm_init, g = build_problem(
        rng, K=4, L=64, obs_per_kf=64, noise=0.0, cap=256)
    K, L = kf_init.shape[0], lm_init.shape[0]
    # remap ALL observations onto landmarks 0, 8, ..., 56 (device 0's on
    # an 8-way mesh): ownership count = M on device 0, slack = 2*M/8
    g = g._replace(obs_lm=(g.obs_lm % 8) * 8)
    bcfg = BackendConfig(gn_iterations=1, robust_kernel="none", damping=1e-5)
    fixed = jnp.zeros((K,), bool).at[0].set(True)
    m = mesh_mod.make_mesh(8, axis="lm")
    _, _, _, ovf = dist_ba.dist_gauss_newton(
        bcfg, m, jnp.asarray(kf_init), jnp.ones((K,), bool),
        jnp.asarray(lm_init), jnp.ones((L,), bool), g, fixed,
        jnp.zeros((L,), jnp.int32))
    M = int(np.asarray(g.obs_valid).sum())
    slack = max(8, (2 * g.obs_kf.shape[0]) // 8)
    assert int(ovf) == max(M - slack, 0) and int(ovf) > 0
    # host-side pre-check agrees with the in-jit count
    assert dist_ba.partition_overflow(g, 8) == int(ovf)


def test_young_map_spreads_over_the_mesh(rng):
    """The engine fills landmark slots from 0 upward: a map in the lowest
    L/8 slots still spreads its edges over all 8 devices, drops none, and
    solves as the single-device path does."""
    kf_true, lm_true, kf_init, lm_init, g = build_problem(
        rng, K=6, L=64, obs_per_kf=8, noise=0.003)
    K, L = kf_init.shape[0], 512
    pad = np.zeros((L - lm_init.shape[0], 3), np.float32)
    lm_init = np.concatenate([lm_init, pad])
    lm_valid = jnp.zeros((L,), bool).at[:64].set(True)
    counts = dist_ba.owner_counts(g, 8)
    assert counts.min() > 0 and dist_ba.partition_overflow(g, 8) == 0
    bcfg = BackendConfig(gn_iterations=4, robust_kernel="none", damping=1e-5)
    fixed = jnp.zeros((K,), bool).at[0].set(True)
    lm_gen = jnp.zeros((L,), jnp.int32)
    res = optimize.gauss_newton(
        bcfg, jnp.asarray(kf_init), jnp.ones((K,), bool),
        jnp.asarray(lm_init), lm_valid, g, fixed, lm_gen)
    kf_d, lm_d, _, ovf = dist_ba.dist_gauss_newton(
        bcfg, mesh_mod.make_mesh(8, axis="lm"), jnp.asarray(kf_init),
        jnp.ones((K,), bool), jnp.asarray(lm_init), lm_valid, g, fixed,
        lm_gen)
    assert int(ovf) == 0
    np.testing.assert_allclose(np.asarray(kf_d), np.asarray(res.kf_pose),
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(lm_d), np.asarray(res.lm_pos),
                               atol=5e-3)
