"""Depth-sensor uncertainty models, batched.

Batched replacement for DepthSensorModel's covariance machinery
(reference: src/Grabber/depthSensorModel.cpp — ``computeCov`` :28-36,
``informationMatrix`` :48-59, normal-based :62-76 and RGB-gradient-based
:79-95 anisotropic scalings) and the Strasdat depth-scaled heuristic
(include/putslam/TransformEst/transformEst.h:343-356).

Covariances are produced for *all* features at once as ``(..., 3, 3)`` arrays;
information matrices come from batched 3x3 closed-form inverses (no LAPACK).
"""

from __future__ import annotations

import jax.numpy as jnp

from putslam_tpu.config import CameraConfig


def depth_sigma(cam: CameraConfig, z):
    """Depth std-dev from the cubic variance polynomial (depthSensorModel.cpp:
    the ``distVarModel`` c3*z^3+c2*z^2+c1*z+c0, fit in millimetres → metres)."""
    var_mm = ((cam.var_c3 * z + cam.var_c2) * z + cam.var_c1) * z + cam.var_c0
    return jnp.sqrt(jnp.maximum(var_mm, 0.0)) * 1e-3


def point_covariance(cam: CameraConfig, uv, depth):
    """Per-feature 3x3 covariance  J · diag(σu², σv², σd²) · Jᵀ  where
    J = ∂(x,y,z)/∂(u,v,d) of the unprojection (depthSensorModel.cpp:28-36).

    uv: (...,2) pixels, depth: (...) metres → (...,3,3).
    """
    d = depth
    x_n = (uv[..., 0] - cam.cu) / cam.fu
    y_n = (uv[..., 1] - cam.cv) / cam.fv
    zeros = jnp.zeros_like(d)
    # J rows: [d/fu, 0, x_n], [0, d/fv, y_n], [0, 0, 1]
    J = jnp.stack(
        [
            jnp.stack([d / cam.fu, zeros, x_n], axis=-1),
            jnp.stack([zeros, d / cam.fv, y_n], axis=-1),
            jnp.stack([zeros, zeros, jnp.ones_like(d)], axis=-1),
        ],
        axis=-2,
    )
    sd = depth_sigma(cam, d)
    Ruvd = jnp.stack([jnp.full_like(d, cam.sigma_u) ** 2,
                      jnp.full_like(d, cam.sigma_v) ** 2,
                      sd * sd], axis=-1)
    return jnp.einsum("...ij,...j,...kj->...ik", J, Ruvd, J)


def inv3x3(M, eps: float = 1e-30):
    """Batched closed-form 3x3 inverse via adjugate (elementwise, no LAPACK)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / jnp.where(jnp.abs(det) < eps, eps, det)
    adj = jnp.stack(
        [
            A, -(b * i - c * h), b * f - c * e,
            B, a * i - c * g, -(a * f - c * d),
            C, -(a * h - b * g), a * e - b * d,
        ],
        axis=-1,
    ).reshape(M.shape)
    return adj * inv_det[..., None, None]


def information_matrix(cam: CameraConfig, uv, depth):
    """Per-feature 3x3 information = covariance⁻¹ (depthSensorModel.cpp:48-59)."""
    return inv3x3(point_covariance(cam, uv, depth))


def chol3x3(M, eps: float = 1e-12):
    """Batched closed-form lower Cholesky factor L with M = L·Lᵀ for
    symmetric PSD 3×3 matrices (elementwise, no LAPACK). Used to *whiten*
    residuals/Jacobians against a full information matrix: with
    Info = L·Lᵀ, the whitened r' = Lᵀr, J' = LᵀJ reduce the generalized
    least squares problem to the scalar-weighted machinery."""
    a = jnp.sqrt(jnp.maximum(M[..., 0, 0], eps))
    b = M[..., 1, 0] / a
    c = M[..., 2, 0] / a
    d = jnp.sqrt(jnp.maximum(M[..., 1, 1] - b * b, eps))
    e = (M[..., 2, 1] - c * b) / d
    f = jnp.sqrt(jnp.maximum(M[..., 2, 2] - c * c - e * e, eps))
    zero = jnp.zeros_like(a)
    return jnp.stack([
        jnp.stack([a, zero, zero], axis=-1),
        jnp.stack([b, d, zero], axis=-1),
        jnp.stack([c, e, f], axis=-1),
    ], axis=-2)


def normal_scaled_covariance(cov, normals, scale: float):
    """Anisotropic rescale along the surface normal (depthSensorModel.cpp:62-76):
    shrink uncertainty in the normal direction by ``scale``.

    cov: (...,3,3); normals: (...,3) unit vectors.
    """
    n = normals / jnp.maximum(jnp.linalg.norm(normals, axis=-1, keepdims=True), 1e-9)
    P_n = jnp.einsum("...i,...j->...ij", n, n)
    eye = jnp.eye(3, dtype=cov.dtype)
    S = eye - (1.0 - scale) * P_n  # scale variance along n, keep tangent
    return jnp.einsum("...ij,...jk,...lk->...il", S, cov, S)


def gradient_scaled_covariance(cov, grad_dir, scale: float):
    """RGB-gradient-based anisotropy (depthSensorModel.cpp:79-95): confident
    across strong image gradients, uncertain along them. ``grad_dir`` is the
    in-image-plane 3D direction of the intensity gradient."""
    g = grad_dir / jnp.maximum(jnp.linalg.norm(grad_dir, axis=-1, keepdims=True), 1e-9)
    P_g = jnp.einsum("...i,...j->...ij", g, g)
    eye = jnp.eye(3, dtype=cov.dtype)
    S = eye - (1.0 - scale) * P_g
    return jnp.einsum("...ij,...jk,...lk->...il", S, cov, S)


def strasdat_information(depth, weight: float = 1.0):
    """Depth-scaled isotropic information (transformEst.h:343-356): iso weight
    ∝ 1/z⁴ (uncertainty grows quadratically with depth)."""
    w = weight / jnp.maximum(depth, 1e-3) ** 4
    return w[..., None, None] * jnp.eye(3, dtype=depth.dtype)
