"""Batched closed-form rigid alignment (weighted Kabsch/Horn), no LAPACK.

Batched replacement for the reference's per-hypothesis Umeyama call
(reference: src/TransformEst/kabschEst.cpp:24-68 — centroids, 3×3
cross-covariance, Jacobi SVD with a sign fix; Eigen::umeyama at
src/TransformEst/RANSAC.cpp:224-226).

Instead of an SVD per hypothesis, we use Horn's quaternion method: the
optimal rotation is the dominant eigenvector of a symmetric 4×4 matrix built
from the cross-covariance. The eigenvector is found with a fixed number of
shifted power iterations — pure batched matvecs, so thousands of hypotheses
solve in a single fused pass (vs the reference's sequential RANSAC loop,
RANSAC.cpp:87-150).
"""

from __future__ import annotations

import jax.numpy as jnp

from putslam_tpu.geometry import se3


def weighted_kabsch(p: jnp.ndarray, q: jnp.ndarray, w: jnp.ndarray,
                    iters: int = 30) -> jnp.ndarray:
    """Find poses T = (R, t) minimizing Σ wᵢ ‖R·pᵢ + t − qᵢ‖² per batch row.

    p, q: (..., n, 3); w: (..., n) nonnegative weights (use the inlier mask).
    Returns (..., 7) poses. Degenerate inputs (all-zero weights, collinear
    points) produce a valid unit quaternion (possibly identity) rather than
    NaN, so downstream masking decides acceptance.

    Layout note: the whole solve is written structure-of-arrays — the 4×4
    Horn matrix is carried as 10 scalar component arrays of shape (...,)
    rather than a (..., 4, 4) tensor, so every squaring is 40 elementwise
    FMAs over the hypothesis batch instead of batched 4×4 products.
    """
    wsum = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-9)
    wn = w / wsum
    p_bar = jnp.sum(wn[..., None] * p, axis=-2)
    q_bar = jnp.sum(wn[..., None] * q, axis=-2)
    pc = p - p_bar[..., None, :]
    qc = q - q_bar[..., None, :]
    # S_ij = Σ_n w pc_i qc_j — nine (...,) reductions (no (...,3,3) tensor)
    wpc = wn[..., None] * pc
    S = (jnp.sum(wpc[..., 0] * qc[..., 0], axis=-1),
         jnp.sum(wpc[..., 0] * qc[..., 1], axis=-1),
         jnp.sum(wpc[..., 0] * qc[..., 2], axis=-1),
         jnp.sum(wpc[..., 1] * qc[..., 0], axis=-1),
         jnp.sum(wpc[..., 1] * qc[..., 1], axis=-1),
         jnp.sum(wpc[..., 1] * qc[..., 2], axis=-1),
         jnp.sum(wpc[..., 2] * qc[..., 0], axis=-1),
         jnp.sum(wpc[..., 2] * qc[..., 1], axis=-1),
         jnp.sum(wpc[..., 2] * qc[..., 2], axis=-1))
    quat = _horn_quat_soa(S, iters)
    t = q_bar - se3.quat_rotate(quat, p_bar)
    return se3.make_pose(t, quat)


def kabsch_soa(px, py, pz, qx, qy, qz, iters: int = 30):
    """Uniform-weight Kabsch from component arrays with the POINT axis
    leading: px … qz are (n, ...) (n points per problem, batch trailing).

    Built for RANSAC's minimal-sample fits: with samples gathered as
    (used_pairs, H) component arrays, no tensor in the whole solve carries a
    minor dim smaller than the hypothesis batch. Returns (..., 7) poses."""
    p_bar_x, p_bar_y, p_bar_z = px.mean(0), py.mean(0), pz.mean(0)
    q_bar_x, q_bar_y, q_bar_z = qx.mean(0), qy.mean(0), qz.mean(0)
    pcx, pcy, pcz = px - p_bar_x, py - p_bar_y, pz - p_bar_z
    qcx, qcy, qcz = qx - q_bar_x, qy - q_bar_y, qz - q_bar_z
    S = (jnp.sum(pcx * qcx, 0), jnp.sum(pcx * qcy, 0), jnp.sum(pcx * qcz, 0),
         jnp.sum(pcy * qcx, 0), jnp.sum(pcy * qcy, 0), jnp.sum(pcy * qcz, 0),
         jnp.sum(pcz * qcx, 0), jnp.sum(pcz * qcy, 0), jnp.sum(pcz * qcz, 0))
    quat = _horn_quat_soa(S, iters)
    p_bar = jnp.stack([p_bar_x, p_bar_y, p_bar_z], axis=-1)
    q_bar = jnp.stack([q_bar_x, q_bar_y, q_bar_z], axis=-1)
    t = q_bar - se3.quat_rotate(quat, p_bar)
    return se3.make_pose(t, quat)


def _horn_quat_soa(S, iters: int = 30) -> jnp.ndarray:
    """Optimal rotation quaternion from the nine cross-covariance component
    arrays S = (Sxx, Sxy, …, Szz), each shaped (...,). Returns (..., 4)."""
    Sxx, Sxy, Sxz, Syx, Syy, Syz, Szx, Szy, Szz = S

    # Horn's symmetric 4×4 K; dominant eigenvector = quaternion of R (p→q).
    # Unique entries (row-major upper triangle), kept as scalars:
    k00 = Sxx + Syy + Szz
    k01 = Syz - Szy
    k02 = Szx - Sxz
    k03 = Sxy - Syx
    k11 = Sxx - Syy - Szz
    k12 = Sxy + Syx
    k13 = Szx + Sxz
    k22 = -Sxx + Syy - Szz
    k23 = Syz + Szy
    k33 = -Sxx - Syy + Szz

    # Shift to make the dominant eigenvalue the largest in magnitude and
    # positive: K + cI with c = mean row-abs-sum bound (Gershgorin-ish).
    c = (jnp.abs(k00) + jnp.abs(k11) + jnp.abs(k22) + jnp.abs(k33)
         + 2.0 * (jnp.abs(k01) + jnp.abs(k02) + jnp.abs(k03)
                  + jnp.abs(k12) + jnp.abs(k13) + jnp.abs(k23))) / 4.0 + 1e-6
    b00, b11, b22, b33 = k00 + c, k11 + c, k22 + c, k33 + c
    b01, b02, b03, b12, b13, b23 = k01, k02, k03, k12, k13, k23

    # Dominant eigenvector via repeated symmetric matrix squaring: B^(2^s)
    # amplifies the eigengap exponentially (s squarings ≈ 2^s power
    # iterations). Squaring a symmetric matrix stays symmetric → 10 outputs
    # of 4 FMAs each per step, all on (...,)-shaped arrays.
    n_sq = max(3, (iters + 5) // 6)
    for _ in range(n_sq):
        n00 = b00 * b00 + b01 * b01 + b02 * b02 + b03 * b03
        n01 = b00 * b01 + b01 * b11 + b02 * b12 + b03 * b13
        n02 = b00 * b02 + b01 * b12 + b02 * b22 + b03 * b23
        n03 = b00 * b03 + b01 * b13 + b02 * b23 + b03 * b33
        n11 = b01 * b01 + b11 * b11 + b12 * b12 + b13 * b13
        n12 = b01 * b02 + b11 * b12 + b12 * b22 + b13 * b23
        n13 = b01 * b03 + b11 * b13 + b12 * b23 + b13 * b33
        n22 = b02 * b02 + b12 * b12 + b22 * b22 + b23 * b23
        n23 = b02 * b03 + b12 * b13 + b22 * b23 + b23 * b33
        n33 = b03 * b03 + b13 * b13 + b23 * b23 + b33 * b33
        # renormalize to avoid overflow (any consistent positive scale works)
        scale = jnp.maximum(jnp.maximum(jnp.maximum(n00, n11),
                                        jnp.maximum(n22, n33)), 1e-30)
        inv = 1.0 / scale
        b00, b11, b22, b33 = n00 * inv, n11 * inv, n22 * inv, n33 * inv
        b01, b02, b03 = n01 * inv, n02 * inv, n03 * inv
        b12, b13, b23 = n12 * inv, n13 * inv, n23 * inv

    # v = B @ v0 for a fixed generic v0, then one polish step v = B @ v.
    c0, c1, c2, c3 = 1.0, 0.31, 0.17, 0.083
    v0 = b00 * c0 + b01 * c1 + b02 * c2 + b03 * c3
    v1 = b01 * c0 + b11 * c1 + b12 * c2 + b13 * c3
    v2 = b02 * c0 + b12 * c1 + b22 * c2 + b23 * c3
    v3 = b03 * c0 + b13 * c1 + b23 * c2 + b33 * c3
    nrm = jnp.maximum(jnp.sqrt(v0 * v0 + v1 * v1 + v2 * v2 + v3 * v3), 1e-20)
    v0, v1, v2, v3 = v0 / nrm, v1 / nrm, v2 / nrm, v3 / nrm
    u0 = b00 * v0 + b01 * v1 + b02 * v2 + b03 * v3
    u1 = b01 * v0 + b11 * v1 + b12 * v2 + b13 * v3
    u2 = b02 * v0 + b12 * v1 + b22 * v2 + b23 * v3
    u3 = b03 * v0 + b13 * v1 + b23 * v2 + b33 * v3
    v = jnp.stack([u0, u1, u2, u3], axis=-1)
    v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-20)

    quat = jnp.where(v[..., 0:1] < 0, -v, v)  # canonical sign, (w,x,y,z)
    return se3.quat_normalize(quat)


def alignment_residuals(T: jnp.ndarray, p: jnp.ndarray, q: jnp.ndarray
                        ) -> jnp.ndarray:
    """‖T·p − q‖ per pair, broadcasting T (..., 7) over points (..., n, 3)."""
    pred = se3.apply(T[..., None, :], p)
    return jnp.linalg.norm(pred - q, axis=-1)


def transform_covariance(T: jnp.ndarray, p: jnp.ndarray, w: jnp.ndarray,
                         point_var: float = 1.0) -> jnp.ndarray:
    """6×6 covariance of the estimated transform in the twist tangent at T.

    Gauss-Newton form of the reference's implicit-function-theorem
    propagation (include/putslam/TransformEst/transformEst.h:29-272 — Euler
    and quaternion ``ConvertUncertainty``): at the optimum,
    Cov(ξ) = σ² (Σ wᵢ JᵢᵀJᵢ)⁻¹ with Jᵢ = ∂(T·pᵢ)/∂ξ = [I | −skew(T·pᵢ)]
    (left perturbation) — the same quantity, without symbolic Jacobian
    tables. ``point_var`` is the isotropic measurement variance σ²;
    anisotropic weights can be folded into ``w``.

    p: (..., n, 3) source points; w: (..., n) weights (inlier mask).
    Returns (..., 6, 6).
    """
    tp = se3.apply(T[..., None, :], p)                       # (..., n, 3)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=p.dtype), tp.shape[:-1] + (3, 3))
    J = jnp.concatenate([eye, -se3.skew(tp)], axis=-1)       # (..., n, 3, 6)
    H = jnp.einsum("...n,...nri,...nrj->...ij", w, J, J)     # (..., 6, 6)
    # damped inverse for degenerate configurations
    H = H + 1e-9 * jnp.eye(6, dtype=p.dtype)
    return point_var * jnp.linalg.inv(H)
