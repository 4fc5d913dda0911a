"""Multi-scale keypoint detection + description + depth lifting.

Batched replacement for the reference's detect/describe front-end
(reference: src/Matcher/matcher.cpp:17-64 ``detectInitFeatures``,
matcherOpenCV.cpp:118-196 — grid-capped FAST/ORB detection, ORB description;
octave bookkeeping matcher.cpp:283-338; depth lifting + gates
RGBD.cpp:30-45 and PUTSLAM.cpp:98-178).

One jitted call produces a fixed-capacity ``Features`` batch: a scale pyramid
is built with ``jax.image.resize``, FAST runs densely per level, per-cell
top-k caps detections, descriptors are steered-BRIEF over per-level patches,
and every keypoint is lifted to a camera-frame 3D point through the
undistortion + pinhole model with the 0.1–6 m validity gate.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from putslam_tpu.config import SlamConfig
from putslam_tpu.geometry import camera as camera_mod
from putslam_tpu.ops import brief, fast


class Features(NamedTuple):
    """Fixed-capacity per-frame feature set (the batched analog of the
    reference's parallel vectors of cv::KeyPoint + Mat descriptors +
    Eigen 3D points, matcher.h:24-120)."""

    uv: jnp.ndarray          # (N, 2) float32 — level-0 pixel coords (distorted)
    uv_undist: jnp.ndarray   # (N, 2) float32 — undistorted pixel coords
    xyz: jnp.ndarray         # (N, 3) float32 — camera-frame 3D point
    response: jnp.ndarray    # (N,)  float32 — detector response
    octave: jnp.ndarray      # (N,)  int32  — pyramid level
    angle: jnp.ndarray       # (N,)  float32 — ORB orientation (radians)
    desc: jnp.ndarray        # (N, 256) int8 ±1 — steered BRIEF
    valid: jnp.ndarray       # (N,)  bool — slot holds a detected keypoint
    has_depth: jnp.ndarray   # (N,)  bool — valid ∧ depth inside the gate

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]


def _pyramid_shapes(cfg: SlamConfig):
    H, W = cfg.camera.height, cfg.camera.width
    shapes = []
    for lvl in range(cfg.detector.n_pyramid_levels):
        s = cfg.detector.scale_factor ** lvl
        shapes.append((max(int(round(H / s)), 32), max(int(round(W / s)), 32)))
    return shapes


def _level_budgets(cfg: SlamConfig):
    """Static per-level keypoint budgets summing to max_features (geometric
    split: coarse levels hold fewer corners and descriptor extraction cost
    is per-keypoint, so budgeting beats describe-everything-per-level)."""
    N = cfg.detector.max_features
    L = cfg.detector.n_pyramid_levels
    if L == 1:
        return [N]
    coarse = [max(N // (2 ** (lvl + 1)), 32) for lvl in range(1, L)]
    total_coarse = sum(coarse)
    if total_coarse > N // 2:  # keep level 0 dominant
        scale = (N // 2) / total_coarse
        coarse = [max(int(b * scale), 16) for b in coarse]
    return [N - sum(coarse)] + coarse


@functools.partial(jax.jit, static_argnums=(0,))
def detect_and_describe(cfg: SlamConfig, gray: jnp.ndarray,
                        depth: jnp.ndarray) -> Features:
    """gray: (H, W) float32 [0,1]; depth: (H, W) float32 metres (0 invalid).

    Returns ``Features`` with capacity cfg.detector.max_features."""
    det = cfg.detector
    cam = cfg.camera
    N = det.max_features
    budgets = _level_budgets(cfg)

    all_uv0, all_resp, all_oct, all_patch, all_valid = [], [], [], [], []
    img = gray
    for lvl, (Hl, Wl) in enumerate(_pyramid_shapes(cfg)):
        if lvl > 0:
            img = jax.image.resize(gray, (Hl, Wl), method="linear")
        scale = cfg.detector.scale_factor ** lvl
        Nl = budgets[lvl]
        uv_l, resp, valid = fast.detect(
            img, det.fast_threshold, det.nms_radius,
            det.grid_rows, det.grid_cols, Nl,
            grid_policy=det.grid_policy,
        )
        # exclude border keypoints (patch must fit; reference border policy)
        b = float(max(det.border // max(int(scale), 1), brief.PATCH // 2 + 1))
        inb = (
            (uv_l[:, 0] >= b) & (uv_l[:, 0] <= Wl - 1 - b)
            & (uv_l[:, 1] >= b) & (uv_l[:, 1] <= Hl - 1 - b)
        )
        valid = valid & inb
        # raw patches: BRIEF's pre-smoothing is folded into the bank constant
        all_patch.append(brief.extract_patches(img, uv_l))
        all_uv0.append(uv_l * scale)
        all_resp.append(jnp.where(valid, resp, 0.0))
        all_oct.append(jnp.full((Nl,), lvl, jnp.int32))
        all_valid.append(valid)

    uv0 = jnp.concatenate(all_uv0)
    resp = jnp.concatenate(all_resp)
    octv = jnp.concatenate(all_oct)
    valid = jnp.concatenate(all_valid)
    # ONE fused descriptor matmul over every level's patches (the per-level
    # split above only affects the cheap blur/gather, so the matmul sees a
    # single (max_features, P²) batch instead of L small ones)
    desc, ang = brief.describe_patches(
        jnp.concatenate(all_patch), kind=det.descriptor)
    desc = jnp.where(valid[:, None], desc, jnp.int8(0))
    top_resp = resp

    # depth lift through undistortion + pinhole (RGBD.cpp:30-45, :254-314)
    z = camera_mod.sample_depth(depth, uv0)
    uv_und = camera_mod.undistort_pixels(cam, uv0)
    xyz = camera_mod.unproject(cam, uv_und, z)
    has_depth = valid & camera_mod.depth_valid_mask(cam, z)

    desc = jnp.where(valid[:, None], desc, jnp.int8(0))
    return Features(
        uv=jnp.where(valid[:, None], uv0, -1.0),
        uv_undist=jnp.where(valid[:, None], uv_und, -1.0),
        xyz=jnp.where(has_depth[:, None], xyz, 0.0),
        response=jnp.where(valid, top_resp, 0.0),
        octave=octv,
        angle=ang,
        desc=desc,
        valid=valid,
        has_depth=has_depth,
    )
