"""Sensor-degradation robustness + committed golden-ATE regression gates.

The reference's only robustness fixture is Gaussian noise in demoKabsch
(demos/demoKabsch.cpp:19-26); real RGB-D streams have depth holes, shot
noise, and motion blur — injected here via ``synthetic.degrade_sequence``.
The golden table (tests/golden_ate.json) pins the accuracy of the canonical
runs so silent regressions fail loudly instead of hiding behind loose
per-test thresholds.
"""

import pytest

pytestmark = pytest.mark.slow
import dataclasses
import json
import os

import numpy as np

from putslam_tpu.config import tiny_test_config
from putslam_tpu.eval import ate
from putslam_tpu.io import synthetic
from putslam_tpu.models import slam, vo

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_ate.json")


def base_cfg():
    cfg = tiny_test_config()
    return cfg.replace(map=dataclasses.replace(
        cfg.map, add_features_when_measurements_less_than=10))


def _golden():
    with open(GOLDEN) as f:
        d = json.load(f)
    return {k: v for k, v in d.items()
            if not k.startswith("_") and k != "acceptance_bounds"}


def measure():
    """Recompute every golden metric (also used to regenerate the table)."""
    cfg = base_cfg()
    out = {}
    poses = synthetic.orbit_trajectory(30, radius=0.15, yaw_amp=0.15)
    grays, depths = synthetic.render_sequence(cfg.camera, poses)
    gt = np.asarray(poses)
    est_vo, _ = vo.run_vo(cfg, grays, depths, init_pose=gt[0])
    out["orbit30_vo"] = ate.ate_rmse_aligned_frames(gt, np.asarray(est_vo))
    pb, pa, _, _ = slam.run_slam_final(cfg, np.asarray(grays),
                                       np.asarray(depths), init_pose=gt[0])
    out["orbit30_slam"] = ate.ate_rmse_aligned_frames(gt, pb)
    out["orbit30_slam_final"] = ate.ate_rmse_aligned_frames(gt, pa)

    cfg_lc = cfg.replace(
        map=dataclasses.replace(cfg.map, max_keyframes=64),
        loop_closure=dataclasses.replace(cfg.loop_closure, enabled=True,
                                         tail_skip=10))
    poses_r = synthetic.revisit_trajectory(64, sweep=1.2)
    grays_r, depths_r = synthetic.render_sequence(cfg.camera, poses_r)
    gt_r = np.asarray(poses_r)
    _, pa_r, _, _ = slam.run_slam_final(cfg_lc, np.asarray(grays_r),
                                        np.asarray(depths_r),
                                        init_pose=gt_r[0])
    out["revisit64_slam_lc_final"] = ate.ate_rmse_aligned_frames(gt_r, pa_r)

    g2, d2 = synthetic.degrade_sequence(grays, depths, seed=1,
                                        intensity_sigma=0.03,
                                        depth_dropout=0.10,
                                        depth_sigma=0.005, blur=1)
    _, pa_d, _, _ = slam.run_slam_final(cfg, np.asarray(g2), np.asarray(d2),
                                        init_pose=gt[0])
    out["orbit30_slam_degraded_final"] = ate.ate_rmse_aligned_frames(gt, pa_d)
    return out


def test_golden_ate_regression():
    golden = _golden()
    got = measure()
    failures = []
    for key, (expected, max_allowed) in golden.items():
        val = got[key]
        if not np.isfinite(val) or val > max_allowed:
            failures.append((key, val, expected, max_allowed))
    assert not failures, failures


def test_degradation_modes_individually():
    """Each degradation alone must not break the engine (finite trajectory,
    bounded ATE) — localizes which sensor defect a regression is about."""
    cfg = base_cfg()
    poses = synthetic.orbit_trajectory(20, radius=0.15, yaw_amp=0.15)
    grays, depths = synthetic.render_sequence(cfg.camera, poses)
    gt = np.asarray(poses)
    modes = {
        # gate per mode: losing a quarter of the depth map on a 128-px-wide
        # rig costs real accuracy; the others should stay near the clean run
        "noise": (dict(intensity_sigma=0.05), 0.12),
        "holes": (dict(depth_dropout=0.25), 0.16),
        "depth_noise": (dict(depth_sigma=0.01), 0.12),
        "blur": (dict(blur=2), 0.12),
    }
    for name, (kw, gate) in modes.items():
        g2, d2 = synthetic.degrade_sequence(grays, depths, seed=3, **kw)
        est, outs, _ = slam.run_slam(cfg, np.asarray(g2), np.asarray(d2),
                                     init_pose=gt[0])
        assert np.isfinite(est).all(), name
        a = ate.ate_rmse_aligned_frames(gt, est)
        assert a < gate, (name, a)


def test_depth_holes_reduce_feature_depth_coverage():
    cfg = base_cfg()
    from putslam_tpu.frontend.detector import detect_and_describe
    from putslam_tpu.geometry import se3

    g, d = synthetic.render_frame(cfg.camera, se3.identity())
    g2, d2 = synthetic.degrade_sequence(g[None], d[None], seed=0,
                                        depth_dropout=0.5)
    f_clean = detect_and_describe(cfg, g, d)
    f_holes = detect_and_describe(cfg, g2[0], d2[0])
    n_clean = int(np.asarray(f_clean.has_depth).sum())
    n_holes = int(np.asarray(f_holes.has_depth).sum())
    assert n_holes < 0.8 * n_clean, (n_holes, n_clean)


if __name__ == "__main__":
    print(json.dumps({k: round(v, 5) for k, v in measure().items()},
                     indent=1))
