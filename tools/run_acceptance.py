#!/usr/bin/env python
"""Canonical acceptance runs: the three 640-frame disk sequences through
the engine at the ACCEPTANCE operating point, scored by the REFERENCE's own
evaluate_ate.py, checked against the bounds under ``acceptance_bounds`` in
tests/golden_ate.json.

Operating point (vs the bench's reference defaults): BA every 2 keyframes ×
3 GN iterations in-loop (the fps headroom buys accuracy), host map archive +
offline global bundle adjustment over the full history (window 256 × 4
back-to-front sweeps), and the dataset's own camera.json (the synthetic
renders are pure pinhole — applying the fr1 distortion correction to them
is a model error worth ~2× the final ATE).

Exit code 0 iff every sequence lands inside its golden bound.
"""

import argparse
import dataclasses as dc
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

GBA = dict(window=256, kf_cap=512, lm_cap=6144, obs_cap=49152,
           sweeps=4, gn_iterations=10)


def apply_overrides(cfg, overrides):
    """--override a.b=v entries applied onto the frozen config tree."""
    for ov in overrides or []:
        path, _, val = ov.partition("=")
        keys = path.split(".")
        v = json.loads(val)
        node = cfg
        objs = []
        for k in keys[:-1]:
            objs.append(node)
            node = getattr(node, k)
        node = dc.replace(node, **{keys[-1]: v})
        for k, parent in zip(reversed(keys[:-1]), reversed(objs)):
            node = parent.replace(**{k: node}) if hasattr(parent, "replace") \
                else dc.replace(parent, **{k: node})
        cfg = node
    return cfg


def run_one(root: str, alpha=None, overrides=None, seed=0):
    import run_reference_eval as rev
    from putslam_tpu.config import tum_fr1_config
    from putslam_tpu.io import tum
    from putslam_tpu.models import slam
    from putslam_tpu.eval import ate as ate_mod

    cfg = tum_fr1_config()
    cfg = cfg.replace(backend=dc.replace(
        cfg.backend, optimize_every_n_frames=2, gn_iterations=3))
    if alpha is not None:
        cfg = cfg.replace(pose_blend_alpha=alpha)
    cfg = apply_overrides(cfg, overrides)
    cam_json = os.path.join(root, "camera.json")
    if os.path.exists(cam_json):
        with open(cam_json) as f:
            cfg = cfg.replace(camera=dc.replace(cfg.camera, **json.load(f)))
    ds = tum.TumDataset(root, depth_scale=cfg.camera.depth_image_scale)
    n = len(ds)
    H, W = cfg.camera.height, cfg.camera.width
    grays = np.empty((n, H, W), np.uint8)
    depths = np.empty((n, H, W), np.uint16)
    scale = cfg.camera.depth_image_scale
    for i, f in enumerate(ds):
        grays[i] = np.clip(f.gray * 255 + 0.5, 0, 255)
        depths[i] = np.clip(f.depth * scale + 0.5, 0, 65535)
    gt_ts, gt = ds.groundtruth
    t0 = time.time()
    pb, pa, outs, st, archive = slam.run_slam_global(
        cfg, grays, depths, init_pose=gt[0], chunk_size=64, seed=seed, **GBA)
    wall = time.time() - t0
    ts = np.arange(n) / 30.0
    with tempfile.TemporaryDirectory() as td:
        ef = os.path.join(td, "est.txt")
        tum.save_trajectory(ef, ts, pa)
        ref_ate = float(rev.evaluate(
            "ate", os.path.join(root, "groundtruth.txt"), ef).strip())
        ref_rpe = float(rev.evaluate(
            "rpe", os.path.join(root, "groundtruth.txt"), ef,
            extra=["--fixed_delta", "--delta", "1", "--delta_unit", "s"]
        ).strip())
    return {
        "frames": n,
        "ref_ate_rmse_g2o_m": round(ref_ate, 5),
        "ref_rpe_trans_g2o_m_per_s": round(ref_rpe, 5),
        "ref_ate_rmse_VO_m": round(float(
            ate_mod.ate_rmse_aligned_frames(gt[:n], pb)), 5),
        "our_ate_rmse_g2o_m": round(float(
            ate_mod.ate_rmse_aligned_frames(gt[:n], pa)), 5),
        "n_keyframes": archive.n_keyframes(),
        "n_obs_archived": len(archive.obs),
        "wall_s": round(wall, 1),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-root", default="data")
    ap.add_argument("--record", default=None,
                    help="write the results as JSON to this file")
    ap.add_argument("--bounds", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests", "golden_ate.json"))
    ap.add_argument("--alpha", type=float, default=None,
                    help="override cfg.pose_blend_alpha")
    ap.add_argument("--override", action="append", default=None,
                    help="config override path=jsonvalue, e.g. "
                         "matcher.retry_hamming_slack=0")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    with open(args.bounds) as f:
        bounds = json.load(f)["acceptance_bounds"]
    results = {}
    ok = True
    for name, key in (("synth_handheld_640", "clean"),
                      ("synth_handheld_640_noisy", "noisy"),
                      ("synth_handheld_640_hard", "hard")):
        root = os.path.join(args.data_root, name)
        if not os.path.isdir(root):
            print(f"SKIP {key}: {root} missing "
                  "(regenerate with tools/make_disk_dataset.py)")
            continue
        r = run_one(root, alpha=args.alpha, overrides=args.override,
                    seed=args.seed)
        results[key] = r
        bound = bounds[f"{key}_ate_max_m"]
        good = r["ref_ate_rmse_g2o_m"] <= bound
        rpe_bound = bounds.get(f"{key}_rpe_trans_max_m_per_s")
        if rpe_bound is not None:
            good &= r["ref_rpe_trans_g2o_m_per_s"] <= rpe_bound
        ok &= good
        print(f"{key}: ATE {r['ref_ate_rmse_g2o_m']} m "
              f"(bound {bound})"
              + (f" RPE {r['ref_rpe_trans_g2o_m_per_s']} (bound {rpe_bound})"
                 if rpe_bound else "")
              + f" {'OK' if good else 'FAIL'}", flush=True)
    print(json.dumps(results, indent=1))
    if args.record:
        with open(args.record, "w") as f:
            json.dump(results, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
