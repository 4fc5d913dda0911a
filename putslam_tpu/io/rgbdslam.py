"""RGB-D SLAM trajectory interop.

Counterpart of the reference's trajectory exchange
(reference: src/PoseGraph/graph_g2o.cpp:818-832 ``export2RGBDSLAM`` —
one ``timestamp tx ty tz qx qy qz qw`` line per SE3 vertex — and
:835-869 ``importRGBDSLAM`` — read the trajectory back as a pose graph
whose consecutive vertices are linked by identity-information relative
edges, first vertex fixed).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax.numpy as jnp

from putslam_tpu.backend.graph import GraphState, init_graph, add_pose_pose
from putslam_tpu.geometry import se3


def export_rgbdslam(path: str, kf_pose, kf_valid,
                    timestamps: Optional[np.ndarray] = None,
                    kf_seq=None) -> int:
    """Write valid keyframes as RGB-D SLAM trajectory lines
    (``timestamp tx ty tz qx qy qz qw``), ordered by keyframe sequence
    number when ``kf_seq`` is given (ring order otherwise).

    Returns the number of lines written."""
    kf_pose = np.asarray(kf_pose)
    kf_valid = np.asarray(kf_valid)
    idx = np.nonzero(kf_valid)[0]
    if kf_seq is not None:
        seq = np.asarray(kf_seq)[idx]
        idx = idx[np.argsort(seq, kind="stable")]
    if timestamps is None:
        timestamps = np.arange(len(idx), dtype=np.float64)
    n = 0
    with open(path, "w") as f:
        for row, k in enumerate(idx):
            tx, ty, tz, qw, qx, qy, qz = [float(v) for v in kf_pose[k]]
            ts = float(timestamps[row] if row < len(timestamps) else row)
            f.write(f"{ts:.6f} {tx} {ty} {tz} {qx} {qy} {qz} {qw}\n")
            n += 1
    return n


def import_rgbdslam(path: str, max_keyframes: int, max_pose_pose: int
                    ) -> Tuple[jnp.ndarray, jnp.ndarray, GraphState,
                               jnp.ndarray, np.ndarray]:
    """Read an RGB-D SLAM trajectory into array state + a pose graph with
    consecutive relative edges (identity information, weight 1 — the
    reference builds EdgeSE3 with infoMat.setIdentity()); the first vertex
    is fixed (graph_g2o.cpp:835-869 contract).

    Returns (kf_pose (K,7), kf_valid (K,), GraphState, fixed_kf (K,),
    timestamps (n,))."""
    kf_pose = np.tile(np.array([0, 0, 0, 1, 0, 0, 0], np.float32),
                      (max_keyframes, 1))
    kf_valid = np.zeros(max_keyframes, bool)
    stamps = []
    n = 0
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            if len(tok) < 8:
                raise ValueError(
                    f"{path}: malformed RGB-D SLAM line "
                    f"(need 8 values): {line.rstrip()!r}")
            if n >= max_keyframes:
                break
            ts, tx, ty, tz, qx, qy, qz, qw = map(float, tok[:8])
            kf_pose[n] = [tx, ty, tz, qw, qx, qy, qz]
            kf_valid[n] = True
            stamps.append(ts)
            n += 1

    g = init_graph(8, max_pose_pose)
    kf_j = jnp.asarray(kf_pose)
    for i in range(1, n):
        # the reference stores trans = pose_i⁻¹ ∘ pose_{i-1}; our pp factor
        # measures rel = pose_{i-1}⁻¹ ∘ pose_i (edge i-1 → i) — same
        # constraint, our edge orientation
        rel = se3.relative(kf_j[i - 1], kf_j[i])
        g = add_pose_pose(g, i - 1, i, rel, 1.0, True)
    fixed = np.zeros(max_keyframes, bool)
    if n:
        fixed[0] = True
    return (kf_j, jnp.asarray(kf_valid), g, jnp.asarray(fixed),
            np.asarray(stamps))
