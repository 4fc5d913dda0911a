"""Dense RGB-D geometry utilities.

Batched replacement for the reference's RGBD helper namespace
(reference: src/RGBD/RGBD.cpp — 8-neighbour surface normals :101-144,
Scharr-like RGB gradients :147-187, colour point clouds for octomap export
:338-362, depth/distance feature filters :189-252; the 2D↔3D lifting lives
in geometry/camera.py).

Everything is whole-image: normals come from central differences of the
unprojected point map (one cross product per pixel), gradients
from two separable Scharr convolutions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from putslam_tpu.config import CameraConfig
from putslam_tpu.geometry import camera as camera_mod


def point_map(cam: CameraConfig, depth: jnp.ndarray) -> jnp.ndarray:
    """Unproject the full depth image → (H, W, 3) camera-frame points."""
    H, W = depth.shape
    uu, vv = jnp.meshgrid(jnp.arange(W, dtype=jnp.float32),
                          jnp.arange(H, dtype=jnp.float32))
    uv = jnp.stack([uu, vv], axis=-1)
    return camera_mod.unproject(cam, uv, depth)


def surface_normals(cam: CameraConfig, depth: jnp.ndarray) -> jnp.ndarray:
    """Per-pixel unit normals (H, W, 3), oriented toward the camera
    (RGBD.cpp:101-144's 8-neighbour estimate as central-difference cross
    products). Pixels with invalid depth in the stencil get a zero normal."""
    P = point_map(cam, depth)
    dx = jnp.zeros_like(P).at[:, 1:-1].set(0.5 * (P[:, 2:] - P[:, :-2]))
    dy = jnp.zeros_like(P).at[1:-1, :].set(0.5 * (P[2:, :] - P[:-2, :]))
    n = jnp.cross(dx, dy)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.maximum(norm, 1e-12)
    # orient toward camera: normal·view < 0 (view dir ≈ P)
    flip = jnp.sum(n * P, axis=-1, keepdims=True) > 0
    n = jnp.where(flip, -n, n)
    # invalidate where depth (or a stencil neighbour) is out of gate
    ok = camera_mod.depth_valid_mask(cam, depth)
    ok = ok & jnp.roll(ok, 1, 0) & jnp.roll(ok, -1, 0) \
        & jnp.roll(ok, 1, 1) & jnp.roll(ok, -1, 1)
    return jnp.where(ok[..., None], n, 0.0)


_SCHARR_X = (np.array([[-3, 0, 3], [-10, 0, 10], [-3, 0, 3]],
                                 np.float32) / 32.0)
_SCHARR_Y = (np.array([[-3, -10, -3], [0, 0, 0], [3, 10, 3]],
                                 np.float32) / 32.0)


def image_gradients(gray: jnp.ndarray):
    """Scharr gradients (RGBD.cpp:147-187): (gx (H,W), gy (H,W))."""
    x = gray[None, None]
    gx = jax.lax.conv_general_dilated(x, _SCHARR_X[None, None], (1, 1),
                                      [(1, 1), (1, 1)])[0, 0]
    gy = jax.lax.conv_general_dilated(x, _SCHARR_Y[None, None], (1, 1),
                                      [(1, 1), (1, 1)])[0, 0]
    return gx, gy


def gradient_directions_3d(cam: CameraConfig, gray: jnp.ndarray,
                           uv: jnp.ndarray, depth: jnp.ndarray) -> jnp.ndarray:
    """Per-feature 3D direction of the image intensity gradient, lifted into
    the camera frame at the feature depth (feeds the gradient-based
    uncertainty model, depthSensorModel.cpp:79-95). uv (N,2), depth (N,)."""
    gx, gy = image_gradients(gray)
    gxs = camera_mod.bilinear_sample(gx, uv)
    gys = camera_mod.bilinear_sample(gy, uv)
    # image-plane direction → 3D direction in the camera frame
    d = jnp.stack([gxs * depth / cam.fu, gys * depth / cam.fv,
                   jnp.zeros_like(gxs)], axis=-1)
    n = jnp.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.where(n > 1e-12, d / jnp.maximum(n, 1e-12), 0.0)


def colored_point_cloud(cam: CameraConfig, gray: jnp.ndarray,
                        depth: jnp.ndarray, stride: int = 1):
    """(points (M,3), intensities (M,), valid (M,)) — the octomap-export
    feed (RGBD.cpp:338-362), strided like octomapCloudStepSize."""
    P = point_map(cam, depth)[::stride, ::stride].reshape(-1, 3)
    I = gray[::stride, ::stride].reshape(-1)
    ok = camera_mod.depth_valid_mask(cam, depth)[::stride, ::stride].reshape(-1)
    return P, I, ok


def save_ply(path: str, points, intensities=None, valid=None) -> None:
    """Write an ASCII PLY point cloud (the reference exports octomap .bt;
    PLY keeps the export hook tool-agnostic)."""
    pts = np.asarray(points)
    if valid is not None:
        v = np.asarray(valid)
        pts = pts[v]
        if intensities is not None:
            intensities = np.asarray(intensities)[v]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if intensities is not None:
            f.write("property uchar gray\n")
        f.write("end_header\n")
        for i, p in enumerate(pts):
            line = f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}"
            if intensities is not None:
                line += f" {int(np.clip(intensities[i] * 255, 0, 255))}"
            f.write(line + "\n")
