"""Batched pinhole camera model with radial-tangential distortion.

Batched replacement for the reference's per-point helpers
(reference: src/RGBD/RGBD.cpp:18-392 — ``keypoints2Dto3D``/``point3Dto2D``/
``removeImageDistortion`` via cv::undistortPoints — and
src/Grabber/depthSensorModel.cpp:4-118, the ``DepthSensorModel`` pinhole).

Everything operates on ``(..., 2)`` pixel arrays / ``(..., 3)`` point arrays at
once; no per-feature loops. Undistortion is a fixed-iteration Newton/fixed-point
inversion (compile-friendly, no data-dependent trips).
"""

from __future__ import annotations

import jax.numpy as jnp

from putslam_tpu.config import CameraConfig


def intrinsics_matrix(cam: CameraConfig, dtype=jnp.float32):
    """3x3 K ("PHCPModel" in depthSensorModel.h:17-148)."""
    return jnp.array(
        [[cam.fu, 0.0, cam.cu], [0.0, cam.fv, cam.cv], [0.0, 0.0, 1.0]], dtype
    )


def distort_normalized(cam: CameraConfig, xy):
    """Apply radial-tangential distortion to normalized coords (...,2)."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xy2 = 2.0 * x * y
    xd = x * radial + cam.p1 * xy2 + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p2 * xy2 + cam.p1 * (r2 + 2.0 * y * y)
    return jnp.stack([xd, yd], axis=-1)


def undistort_normalized(cam: CameraConfig, xy_d, iters: int = 8):
    """Invert distortion by fixed-point iteration (cv::undistortPoints
    semantics, RGBD.cpp:254-314). ``iters`` is static."""
    xy = xy_d
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        xy2 = 2.0 * x * y
        dx = cam.p1 * xy2 + cam.p2 * (r2 + 2.0 * x * x)
        dy = cam.p2 * xy2 + cam.p1 * (r2 + 2.0 * y * y)
        xy = (xy_d - jnp.stack([dx, dy], axis=-1)) / radial[..., None]
    return xy


def pixel_to_normalized(cam: CameraConfig, uv):
    return jnp.stack(
        [(uv[..., 0] - cam.cu) / cam.fu, (uv[..., 1] - cam.cv) / cam.fv], axis=-1
    )


def normalized_to_pixel(cam: CameraConfig, xy):
    return jnp.stack(
        [xy[..., 0] * cam.fu + cam.cu, xy[..., 1] * cam.fv + cam.cv], axis=-1
    )


def undistort_pixels(cam: CameraConfig, uv):
    """Distorted pixels → ideal (undistorted) pixels (...,2)."""
    return normalized_to_pixel(cam, undistort_normalized(cam, pixel_to_normalized(cam, uv)))


def unproject(cam: CameraConfig, uv, depth, undistort: bool = False):
    """(u,v,d) → camera-frame xyz (...,3). ``getPoint`` depthSensorModel.cpp:4-26
    / batched ``keypoints2Dto3D`` RGBD.cpp:30-45."""
    xy = pixel_to_normalized(cam, uv)
    if undistort:
        xy = undistort_normalized(cam, xy)
    return jnp.concatenate([xy * depth[..., None], depth[..., None]], axis=-1)


def project(cam: CameraConfig, xyz, distort: bool = False):
    """Camera-frame xyz → pixels (...,2). ``inverseModel`` depthSensorModel.cpp /
    ``point3Dto2D`` RGBD.cpp:92-98. Points behind the camera are clamped via a
    tiny-z guard; validity should be checked separately with depth gates."""
    z = jnp.where(jnp.abs(xyz[..., 2:3]) < 1e-9, 1e-9, xyz[..., 2:3])
    xy = xyz[..., 0:2] / z
    if distort:
        xy = distort_normalized(cam, xy)
    return normalized_to_pixel(cam, xy)


def depth_valid_mask(cam: CameraConfig, depth):
    """The 0.1–6 m depth validity gate (RANSAC.cpp:64-74, PUTSLAM.cpp:117)."""
    return (depth > cam.min_depth) & (depth < cam.max_depth)


def in_image_mask(cam: CameraConfig, uv, border: float = 0.0):
    return (
        (uv[..., 0] >= border)
        & (uv[..., 0] <= cam.width - 1 - border)
        & (uv[..., 1] >= border)
        & (uv[..., 1] <= cam.height - 1 - border)
    )


def bilinear_sample(image, uv):
    """Sample image (H,W) at float pixel coords uv (...,2) with clamping."""
    H, W = image.shape[-2], image.shape[-1]
    u = jnp.clip(uv[..., 0], 0.0, W - 1.0)
    v = jnp.clip(uv[..., 1], 0.0, H - 1.0)
    u0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, W - 2)
    v0 = jnp.clip(jnp.floor(v).astype(jnp.int32), 0, H - 2)
    du = u - u0
    dv = v - v0
    i00 = image[..., v0, u0]
    i01 = image[..., v0, u0 + 1]
    i10 = image[..., v0 + 1, u0]
    i11 = image[..., v0 + 1, u0 + 1]
    return (
        i00 * (1 - du) * (1 - dv)
        + i01 * du * (1 - dv)
        + i10 * (1 - du) * dv
        + i11 * du * dv
    )


def sample_depth(depth_image, uv):
    """Nearest-neighbour depth lookup at pixel coords (reference reads the raw
    depth pixel under each keypoint, RGBD.cpp:30-45)."""
    H, W = depth_image.shape[-2], depth_image.shape[-1]
    u = jnp.clip(jnp.round(uv[..., 0]).astype(jnp.int32), 0, W - 1)
    v = jnp.clip(jnp.round(uv[..., 1]).astype(jnp.int32), 0, H - 1)
    return depth_image[..., v, u]
