"""Command-line SLAM runner — the ``demoMatching`` equivalent.

Usage:
    python -m putslam_tpu.run --dataset /path/to/tum_sequence --out results/
    python -m putslam_tpu.run --synthetic 120 --out results/ --loop-closure

Replaces the reference's demo binary + batch driver
(reference: demos/demoMatching.cpp:1-13 → PUTSLAM::startProcessing;
scripts/runPUTSLAM.py:15-40 dataset iteration; outputs VO_trajectory.res /
graph_trajectory.res / fps.res / times.txt / statistics — PUTSLAM.cpp
:1006-1016, :1056-1061, :1063-1216). Evaluates ATE/RPE in-process when
ground truth is available (scripts/evaluate_ate.py semantics).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np


def load_dataset(cfg, path: str, max_frames: int = 0):
    """A TUM-layout sequence in the wire format the scan takes (uint8 gray,
    uint16 depth: the PNG payloads; the cast to float happens on the device
    per chunk), decoded by the native threaded loader where it loads.

    A dataset's own camera.json (written by tools/make_disk_dataset)
    overrides the config camera: the engine must not undistort pixels of a
    sequence rendered without distortion.

    Returns (cfg, dataset, grays (T, H, W), depths (T, H, W), timestamps
    (T,), per-frame ground truth (T, 7) when its timestamps line up with the
    frames exactly, else None)."""
    from putslam_tpu.io import tum

    cam_json = os.path.join(path, "camera.json")
    if os.path.exists(cam_json):
        with open(cam_json) as f:
            cfg = cfg.replace(camera=dataclasses.replace(
                cfg.camera, **json.load(f)))
    ds = tum.TumDataset(path, depth_scale=cfg.camera.depth_image_scale)
    n = len(ds) if not max_frames else min(len(ds), max_frames)
    grays = np.empty((n, cfg.camera.height, cfg.camera.width), np.uint8)
    depths = np.empty_like(grays, dtype=np.uint16)
    timestamps = np.empty((n,), np.float64)
    scale = cfg.camera.depth_image_scale
    for i, f in enumerate(ds):
        if i >= n:
            break
        grays[i] = np.clip(f.gray * 255.0 + 0.5, 0, 255)
        depths[i] = np.clip(f.depth * scale + 0.5, 0, 65535)
        timestamps[i] = f.timestamp
    gt_poses = None
    if ds.groundtruth is not None:
        gt_ts, gt_all = ds.groundtruth
        # per-frame GT when timestamps line up exactly (our materialized
        # synthetic sequences) — enables the frame-aligned report alongside
        # the associated-timestamp eval
        if len(gt_ts) >= n and np.allclose(gt_ts[:n], timestamps, atol=1e-6):
            gt_poses = gt_all[:n]
    return cfg, ds, grays, depths, timestamps, gt_poses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", help="TUM-format sequence directory")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="render N synthetic frames instead of a dataset")
    ap.add_argument("--out", default="results", help="output directory")
    ap.add_argument("--only-vo", action="store_true",
                    help="VO only (reference onlyVO=1)")
    ap.add_argument("--vo-version", type=int, default=0,
                    help="0=matching, 1=KLT tracking (VOVersion)")
    ap.add_argument("--loop-closure", action="store_true")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=64,
                    help="stream the sequence through the jitted scan in "
                         "blocks of this many frames (0 = all at once); "
                         "long file-played sequences must not stage the "
                         "whole image stack on the device")
    ap.add_argument("--global-ba", action="store_true",
                    help="archive the full graph across ring evictions and "
                         "polish it with the offline global bundle "
                         "adjustment (overlapping windowed sweeps) instead "
                         "of the ring-bounded final optimization")
    ap.add_argument("--reference-eval", action="store_true",
                    help="additionally score the trajectories with the "
                         "REFERENCE's own evaluate_ate/evaluate_rpe scripts "
                         "(writes VOAte.res/g2oAte.res/VORpe.res/g2oRpe.res "
                         "like scripts/runPUTSLAM.py)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reference-resources", default=None,
                    help="load the operating point from a reference-style "
                         "resources/ directory of XML configs "
                         "(putslamconfigGlobal.xml chain)")
    ap.add_argument("--dataset-name", default=None,
                    help="datasetConfig/<name>.xml to use with "
                         "--reference-resources")
    ap.add_argument("--plots", action="store_true",
                    help="write trajectory/map/stats PNGs (offline visualizer)")
    args = ap.parse_args(argv)

    import jax

    from putslam_tpu.config import tum_fr1_config
    from putslam_tpu.eval import ate as ate_mod, rpe as rpe_mod
    from putslam_tpu.io import synthetic, tum
    from putslam_tpu.models import slam, vo
    from putslam_tpu.utils import timing
    from putslam_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    os.makedirs(args.out, exist_ok=True)
    if args.reference_resources:
        from putslam_tpu.io import xml_config

        cfg = xml_config.load_reference_config(args.reference_resources,
                                               args.dataset_name)
        cfg = cfg.replace(only_vo=args.only_vo, vo_version=args.vo_version)
    else:
        cfg = tum_fr1_config(only_vo=args.only_vo, vo_version=args.vo_version)
    if args.loop_closure:
        cfg = cfg.replace(loop_closure=dataclasses.replace(
            cfg.loop_closure, enabled=True))

    timer = timing.StageTimer()
    gt_poses = None
    timestamps = None
    if args.synthetic:
        with timer.stage("dataset"):
            poses = synthetic.orbit_trajectory(args.synthetic, radius=0.12,
                                               yaw_amp=0.12)
            grays, depths = synthetic.render_sequence(cfg.camera, poses)
            grays = np.asarray(grays)
            depths = np.asarray(depths)
            gt_poses = np.asarray(poses)
            timestamps = np.arange(len(grays)) / 30.0
    elif args.dataset:
        with timer.stage("dataset"):
            cfg, ds, grays, depths, timestamps, gt_poses = load_dataset(
                cfg, args.dataset, args.max_frames)
    else:
        ap.error("need --dataset or --synthetic N")

    init_pose = gt_poses[0] if gt_poses is not None else (
        ds.starting_pose() if args.dataset else None)

    t0 = time.perf_counter()
    if args.only_vo:
        if grays.dtype == np.uint8:
            grays = grays.astype(np.float32) / 255.0
            depths = depths.astype(np.float32) / cfg.camera.depth_image_scale
        with timer.stage("vo_total"):
            est, stats = vo.run_vo(cfg, grays, depths, seed=args.seed,
                                   init_pose=init_pose)
        outs = None
    elif args.global_ba:
        with timer.stage("slam_total"):
            est_vo_anchored, est, outs, state, _archive = \
                slam.run_slam_global(cfg, grays, depths,
                                     init_pose=init_pose, seed=args.seed,
                                     chunk_size=args.chunk or 64,
                                     timer=timer)
    else:
        with timer.stage("slam_total"):
            est_vo_anchored, est, outs, state = slam.run_slam_final(
                cfg, grays, depths, init_pose=init_pose, seed=args.seed,
                chunk_size=args.chunk, timer=timer)
    total = time.perf_counter() - t0

    # --- outputs (reference file names) ----------------------------------
    ts = timestamps if timestamps is not None else np.arange(len(est)) / 30.0
    traj_name = "VO_trajectory.res" if args.only_vo else "graph_trajectory.res"
    tum.save_trajectory(os.path.join(args.out, traj_name), ts, est)
    if not args.only_vo:
        # pre-final-optimization trajectory (the reference saves both the VO
        # and the optimized-graph trajectory, PUTSLAM.cpp:1006-1016)
        tum.save_trajectory(os.path.join(args.out, "VO_trajectory.res"), ts,
                            est_vo_anchored)
    timing.write_fps(os.path.join(args.out, "fps.res"), len(grays), total)
    timer.write_times_txt(os.path.join(args.out, "times.txt"))
    if outs is not None:
        timing.write_run_statistics(os.path.join(args.out, "statistics.txt"),
                                    outs)

    if args.plots:
        from putslam_tpu.utils import viz

        viz.plot_trajectory(os.path.join(args.out, "trajectory.png"), est,
                            gt_poses)
        if outs is not None:
            viz.plot_map(os.path.join(args.out, "map.png"), state.map, est)
            viz.plot_run_stats(os.path.join(args.out, "stats.png"), outs)

    dev = jax.devices()[0]
    report = {"frames": int(len(grays)), "fps": round(len(grays) / total, 2),
              "platform": dev.platform, "device_kind": dev.device_kind}
    chunks = timer.samples.get("slam_chunk", [])
    if chunks:
        # the first chunk includes compiling the scan; the rest are steady
        report["first_chunk_s"] = chunks[0]
    if len(chunks) > 1:
        # real frames only: the tail chunk is padded to the chunk size
        report["steady_fps"] = (sum(timer.items["slam_chunk"][1:])
                                / sum(chunks[1:]))
    if gt_poses is not None:
        report["ate_rmse_m"] = round(
            ate_mod.ate_rmse_aligned_frames(gt_poses, est), 5)
        if not args.only_vo:
            # before/after the end-of-run full-graph optimization — the
            # reference's VOAte.res vs g2oAte.res pair (PUTSLAM.cpp:1222-1233)
            report["ate_before_final_m"] = round(
                ate_mod.ate_rmse_aligned_frames(gt_poses, est_vo_anchored), 5)
        tr, rot = rpe_mod.rpe(gt_poses, est)
        report["rpe_trans_m"] = round(tr, 5)
        report["rpe_rot_rad"] = round(rot, 5)
    elif args.dataset and ds.groundtruth is not None:
        gt_ts, gt_all = ds.groundtruth
        report["ate_rmse_m"] = round(
            ate_mod.ate_rmse(gt_ts, gt_all, ts, est), 5)

    # --- score with the REFERENCE's own eval scripts ----------------------
    # (scripts/evaluate_ate.py:47-133 / evaluate_rpe.py, the runPUTSLAM.py
    # acceptance loop; output names VOAte/g2oAte/VORpe/g2oRpe.res match)
    gt_file = (os.path.join(args.dataset, "groundtruth.txt")
               if args.dataset else None)
    if args.reference_eval and gt_file and os.path.exists(gt_file):
        import sys as _sys
        _sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))), "tools"))
        import run_reference_eval as ref_eval

        pairs = [("g2o", os.path.join(args.out, "graph_trajectory.res"))]
        if not args.only_vo:
            pairs.append(("VO", os.path.join(args.out, "VO_trajectory.res")))
        else:
            pairs = [("VO", os.path.join(args.out, "VO_trajectory.res"))]
        for tag, traj in pairs:
            if not os.path.exists(traj):
                continue
            ate_out = ref_eval.evaluate("ate", gt_file, traj)
            rpe_out = ref_eval.evaluate(
                "rpe", gt_file, traj,
                extra=["--fixed_delta", "--delta", "1", "--delta_unit", "s"])
            with open(os.path.join(args.out, f"{tag}Ate.res"), "w") as f:
                f.write(ate_out)
            with open(os.path.join(args.out, f"{tag}Rpe.res"), "w") as f:
                f.write(rpe_out)
            report[f"ref_ate_rmse_{tag}_m"] = round(float(
                ate_out.strip().splitlines()[0]), 5)
            report[f"ref_rpe_trans_{tag}_m"] = round(float(
                rpe_out.strip().splitlines()[0]), 5)

    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
