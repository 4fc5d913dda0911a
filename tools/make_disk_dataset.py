#!/usr/bin/env python
"""Materialize a synthetic handheld RGB-D sequence ON DISK in TUM layout.

This closes the file-player acceptance loop without network access (no
TUM/ICL downloads exist in this sandbox): render a ≥600-frame
handheld-dynamics sequence, write it as rgb/*.png (8-bit) + depth/*.png
(16-bit, 5000 counts/m) + rgb.txt/depth.txt/groundtruth.txt — byte-for-byte
the layout prepareDatasetFreiburg.py produces and fileGrabber.cpp:40-160
consumes — then run the engine on it via ``python -m putslam_tpu.run
--dataset`` and score with the reference's own evaluate_ate/rpe scripts
(tools/run_reference_eval.py).

Degraded variants (depth holes / noise / blur) mirror a worn sensor.
Renders in chunks on JAX's default device.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

DEGRADE_PRESETS = {
    "clean": {},
    "noisy": dict(intensity_sigma=0.03, depth_sigma=0.01, depth_dropout=0.15),
    "hard": dict(intensity_sigma=0.05, depth_sigma=0.02, depth_dropout=0.30,
                 blur=1),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=640)
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--degrade", choices=sorted(DEGRADE_PRESETS), default="clean")
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--renderer", choices=("raycast", "planes"),
                    default="raycast",
                    help="planes = the INDEPENDENT numpy plane-scene "
                         "renderer (io/synthetic2.py: different scene, "
                         "texture, shading, and a division-model "
                         "distortion the pinhole camera.json does not "
                         "advertise)")
    args = ap.parse_args(argv)

    import jax.numpy as jnp

    from putslam_tpu.config import tum_fr1_config
    from putslam_tpu.io import synthetic, tum

    cfg = tum_fr1_config()
    poses = synthetic.handheld_trajectory(args.frames, seed=args.seed)
    gt = np.asarray(poses)

    os.makedirs(os.path.join(args.out, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(args.out, "depth"), exist_ok=True)
    t0 = time.time()
    all_ts = np.arange(args.frames, dtype=np.float64) / 30.0
    deg = DEGRADE_PRESETS[args.degrade]
    if args.renderer == "planes":
        from putslam_tpu.io import synthetic2
    for s in range(0, args.frames, args.chunk):
        e = min(s + args.chunk, args.frames)
        if args.renderer == "planes":
            g, d = synthetic2.render_sequence(cfg.camera, gt[s:e])
        else:
            g, d = synthetic.render_sequence(cfg.camera, jnp.asarray(gt[s:e]))
        if deg:
            g, d = synthetic.degrade_sequence(g, d, seed=args.seed + s, **deg)
        tum.write_tum_frames(args.out, np.asarray(g), np.asarray(d),
                             all_ts[s:e],
                             depth_scale=cfg.camera.depth_image_scale)
        print(f"[{e}/{args.frames}] {time.time()-t0:.0f}s", flush=True)
    # single consolidated index files + groundtruth over the whole sequence
    tum._write_index_files(args.out, all_ts)
    tum.save_trajectory(os.path.join(args.out, "groundtruth.txt"), all_ts, gt)
    # the TRUE camera model of the rendered data: pinhole, NO distortion
    # (the raycaster projects undistorted rays) — consumers must not apply
    # the fr1 distortion correction to images that were never distorted
    import json
    with open(os.path.join(args.out, "camera.json"), "w") as f:
        json.dump({"fu": cfg.camera.fu, "fv": cfg.camera.fv,
                   "cu": cfg.camera.cu, "cv": cfg.camera.cv,
                   "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0, "k3": 0.0,
                   "width": cfg.camera.width, "height": cfg.camera.height,
                   "depth_image_scale": cfg.camera.depth_image_scale}, f)
    print(f"done: {args.out} ({args.frames} frames, {time.time()-t0:.0f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
