"""Batched SE(3) / quaternion math.

Batched replacement for the reference's Eigen-based pose types
(reference: include/putslam/Defs/putslam_defs.h:28-40 — ``Mat34`` poses,
quaternion helpers scattered through featuresMap.cpp / transformEst.h).

Layout
------
A pose is a flat ``(..., 7)`` float array: ``[tx, ty, tz, qw, qx, qy, qz]``.
All ops broadcast over leading batch axes, are jit/vmap-safe, and avoid any
data-dependent control flow so they fuse cleanly under XLA.

The tangent (twist) parameterization used by the Gauss-Newton backend is
``[rho(3), phi(3)]`` with ``exp`` / ``log`` maps; right-composition updates
``pose' = pose ∘ exp(xi)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Quaternions: layout (w, x, y, z), Hamilton convention.
# ---------------------------------------------------------------------------


def quat_identity(batch_shape=(), dtype=jnp.float32):
    q = jnp.zeros(batch_shape + (4,), dtype).at[..., 0].set(1.0)
    return q


def quat_normalize(q):
    return q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-12)


def quat_conj(q):
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], q.dtype)


def quat_mul(a, b):
    """Hamilton product a⊗b, broadcasting over batch axes."""
    aw, ax, ay, az = jnp.moveaxis(a, -1, 0)
    bw, bx, by, bz = jnp.moveaxis(b, -1, 0)
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_rotate(q, v):
    """Rotate vectors v (...,3) by quaternions q (...,4)."""
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * jnp.cross(qv, v)
    return v + qw * t + jnp.cross(qv, t)


def quat_to_matrix(q):
    """(...,4) → (...,3,3) rotation matrices."""
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m):
    """(...,3,3) → (...,4). Branch-free Shepperd-style selection (max trace
    candidate chosen with where, so it is jit/vmap safe)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    # Four candidate quaternions (unnormalized), one per dominant component.
    qw_w = 1.0 + tr
    q_w = jnp.stack([qw_w, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx_x = 1.0 + m00 - m11 - m22
    q_x = jnp.stack([m21 - m12, qx_x, m01 + m10, m02 + m20], axis=-1)
    qy_y = 1.0 - m00 + m11 - m22
    q_y = jnp.stack([m02 - m20, m01 + m10, qy_y, m12 + m21], axis=-1)
    qz_z = 1.0 - m00 - m11 + m22
    q_z = jnp.stack([m10 - m01, m02 + m20, m12 + m21, qz_z], axis=-1)

    # Pick the numerically best candidate per element.
    mags = jnp.stack([qw_w, qx_x, qy_y, qz_z], axis=-1)
    idx = jnp.argmax(mags, axis=-1)
    cands = jnp.stack([q_w, q_x, q_y, q_z], axis=-2)  # (...,4,4)
    q = jnp.take_along_axis(cands, idx[..., None, None].astype(jnp.int32)
                            .repeat(4, axis=-1), axis=-2)[..., 0, :]
    # Canonical sign: w >= 0.
    q = jnp.where(q[..., 0:1] < 0, -q, q)
    return quat_normalize(q)


def quat_angle(q):
    """Rotation angle of quaternion(s), in radians (0..pi)."""
    w = jnp.clip(jnp.abs(q[..., 0]), 0.0, 1.0)
    return 2.0 * jnp.arccos(w)


# ---------------------------------------------------------------------------
# Poses: (...,7) = [t(3), q(4)]
# ---------------------------------------------------------------------------


def identity(batch_shape=(), dtype=jnp.float32):
    p = jnp.zeros(batch_shape + (7,), dtype).at[..., 3].set(1.0)
    return p


def make_pose(t, q):
    return jnp.concatenate([t, quat_normalize(q)], axis=-1)


def translation(p):
    return p[..., 0:3]


def rotation_quat(p):
    return p[..., 3:7]


def compose(a, b):
    """a ∘ b: apply b first, then a (i.e. T_a @ T_b)."""
    q = quat_mul(rotation_quat(a), rotation_quat(b))
    t = translation(a) + quat_rotate(rotation_quat(a), translation(b))
    return make_pose(t, q)


def inverse(p):
    qi = quat_conj(rotation_quat(p))
    ti = -quat_rotate(qi, translation(p))
    return make_pose(ti, qi)


def apply(p, pts):
    """Transform points (...,3) by poses (...,7), broadcasting."""
    return quat_rotate(rotation_quat(p), pts) + translation(p)


def apply_soa(p, px, py, pz):
    """Structure-of-arrays point transform: pose (..., 7) applied to point
    component arrays px/py/pz (each broadcastable against p[..., 0]).

    Returns (x, y, z) component arrays. Use this instead of ``apply`` when
    the broadcasted result would carry a size-3 trailing axis over a large
    batch (e.g. RANSAC's (H, N, 3) predicted points): component arrays
    keep the large batch as the minor axis."""
    qw, qx, qy, qz = p[..., 3], p[..., 4], p[..., 5], p[..., 6]
    # v' = v + 2 qw (qv × v) + 2 qv × (qv × v), expanded per component
    tx = 2.0 * (qy * pz - qz * py)
    ty = 2.0 * (qz * px - qx * pz)
    tz = 2.0 * (qx * py - qy * px)
    x = px + qw * tx + (qy * tz - qz * ty) + p[..., 0]
    y = py + qw * ty + (qz * tx - qx * tz) + p[..., 1]
    z = pz + qw * tz + (qx * ty - qy * tx) + p[..., 2]
    return x, y, z


def to_matrix(p):
    """(...,7) → (...,4,4) homogeneous matrices."""
    R = quat_to_matrix(rotation_quat(p))
    t = translation(p)
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    bottom = jnp.zeros(p.shape[:-1] + (1, 4), p.dtype).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def from_matrix(m):
    return make_pose(m[..., 0:3, 3], matrix_to_quat(m[..., 0:3, 0:3]))


def relative(a, b):
    """a⁻¹ ∘ b — the increment taking frame a to frame b."""
    return compose(inverse(a), b)


# ---------------------------------------------------------------------------
# so(3)/se(3) exp & log maps (for Gauss-Newton on twists).
# ---------------------------------------------------------------------------


def _taylor_safe(theta2, exact, taylor, eps=1e-8):
    return jnp.where(theta2 > eps, exact, taylor)


def so3_exp_quat(phi):
    """Axis-angle (...,3) → quaternion (...,4)."""
    theta2 = jnp.sum(phi * phi, axis=-1, keepdims=True)
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    half = 0.5 * theta
    w = jnp.cos(half)
    # sin(theta/2)/theta with Taylor fallback 0.5 - theta^2/48
    s = _taylor_safe(theta2, jnp.sin(half) / theta, 0.5 - theta2 / 48.0)
    return jnp.concatenate([w, s * phi], axis=-1)


def so3_log(q):
    """Quaternion (...,4) → axis-angle (...,3)."""
    q = jnp.where(q[..., 0:1] < 0, -q, q)  # shortest arc
    w = jnp.clip(q[..., 0:1], -1.0, 1.0)
    v = q[..., 1:4]
    vn2 = jnp.sum(v * v, axis=-1, keepdims=True)
    vn = jnp.sqrt(jnp.maximum(vn2, 1e-24))
    theta = 2.0 * jnp.arctan2(vn, w)
    # theta/sin(theta/2) == theta/vn scale; Taylor: 2/w ≈ 2 for small angles
    scale = _taylor_safe(vn2, theta / vn, 2.0 / jnp.maximum(w, 1e-12))
    return scale * v


def _so3_left_jacobian(phi):
    """Left Jacobian J_l of SO(3) (...,3) → (...,3,3)."""
    theta2 = jnp.sum(phi * phi, axis=-1)[..., None, None]
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    K = skew(phi)
    K2 = K @ K
    A = _taylor_safe(theta2, (1 - jnp.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    B = _taylor_safe(theta2, (theta - jnp.sin(theta)) / (theta2 * theta),
                     1.0 / 6.0 - theta2 / 120.0)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + A * K + B * K2


def skew(v):
    """(...,3) → (...,3,3) cross-product matrices."""
    x, y, z = jnp.moveaxis(v, -1, 0)
    zero = jnp.zeros_like(x)
    m = jnp.stack([zero, -z, y, z, zero, -x, -y, x, zero], axis=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def _so3_left_jacobian_inv(phi):
    """Inverse left Jacobian J_l⁻¹ of SO(3): I − ½K + c·K² with
    c = 1/θ² − (1+cosθ)/(2θ·sinθ) (Taylor 1/12 + θ²/720)."""
    theta2 = jnp.sum(phi * phi, axis=-1)[..., None, None]
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    K = skew(phi)
    K2 = K @ K
    # valid on the principal domain |φ| ≤ π (log always returns it); the
    # sign-preserving denominator clamp keeps θ > π inputs finite.
    # Wide Taylor window (θ < 0.5): the exact form differences two ~1/θ²
    # terms — catastrophic cancellation in f32 at small θ; the series
    # converges to f32 precision well past the switch point
    sin_t = jnp.sin(theta)
    den = 2.0 * theta * sin_t
    den = jnp.where(jnp.abs(den) < 1e-12, 1e-12, den)
    c = _taylor_safe(
        theta2,
        1.0 / jnp.maximum(theta2, 1e-24) - (1.0 + jnp.cos(theta)) / den,
        1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0,
        eps=0.25)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye - 0.5 * K + c * K2


def _se3_Q(xi):
    """The Q block of the SE(3) left Jacobian (Barfoot, State Estimation
    for Robotics, eq. 7.86): couples translation and rotation columns.
    xi = (...,6) [ρ, φ] → (...,3,3). Batched elementwise + 3×3 products."""
    rho, phi = xi[..., 0:3], xi[..., 3:6]
    theta2 = jnp.sum(phi * phi, axis=-1)[..., None, None]
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    Cr = skew(rho)
    Cp = skew(phi)
    Cp2 = Cp @ Cp
    # wide Taylor windows: the exact numerators are high-order differences
    # (O(θ³)/O(θ⁴)/O(θ⁵) of O(1) terms) — f32 cancellation garbage at small
    # θ; 3-term series are f32-exact out to the θ=0.5 switch
    sin_t, cos_t = jnp.sin(theta), jnp.cos(theta)
    t4 = theta2 * theta2
    m2 = _taylor_safe(theta2, (theta - sin_t) / (theta2 * theta),
                      1.0 / 6.0 - theta2 / 120.0 + t4 / 5040.0, eps=0.25)
    m3 = _taylor_safe(theta2,
                      (1.0 - 0.5 * theta2 - cos_t) / t4,
                      -1.0 / 24.0 + theta2 / 720.0 - t4 / 40320.0, eps=0.25)
    m5 = _taylor_safe(
        theta2,
        (theta - sin_t - theta2 * theta / 6.0) / (t4 * theta),
        -1.0 / 120.0 + theta2 / 5040.0 - t4 / 362880.0, eps=0.25)
    m4 = 0.5 * (m3 - 3.0 * m5)
    CpCr = Cp @ Cr
    CrCp = Cr @ Cp
    return (0.5 * Cr
            + m2 * (CpCr + CrCp + Cp @ CrCp)
            - m3 * (Cp2 @ Cr + Cr @ Cp2 - 3.0 * (Cp @ CrCp))
            - m4 * (CpCr @ Cp2 + Cp2 @ CrCp))


def se3_left_jacobian_inv_blocks(xi):
    """(X, Y) 3×3 blocks of the inverse left Jacobian of SE(3):
    Jl⁻¹(ξ) = [[X, Y], [0, X]] with X = Jl⁻¹(φ), Y = −X·Q(ξ)·X."""
    phi = xi[..., 3:6]
    X = _so3_left_jacobian_inv(phi)
    Y = -(X @ _se3_Q(xi) @ X)
    return X, Y


def _blocks_to_6x6(X, Y, Z, W):
    top = jnp.concatenate([X, Y], axis=-1)
    bot = jnp.concatenate([Z, W], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def se3_left_jacobian_inv(xi):
    """Inverse left Jacobian of SE(3) at twist xi (...,6) → (...,6,6):
    [[Jl⁻¹, −Jl⁻¹·Q·Jl⁻¹], [0, Jl⁻¹]] (closed form — no autodiff)."""
    X, Y = se3_left_jacobian_inv_blocks(xi)
    return _blocks_to_6x6(X, Y, jnp.zeros_like(X), X)


def se3_right_jacobian_inv(xi):
    """Inverse RIGHT Jacobian of SE(3): Jr⁻¹(ξ) = Jl⁻¹(−ξ)."""
    return se3_left_jacobian_inv(-xi)


def adjoint(p):
    """Adjoint of a pose (...,7) → (...,6,6) for [ρ, φ] twists:
    Ad(T)·ξ satisfies T·exp(ξ)·T⁻¹ = exp(Ad(T)·ξ);
    Ad = [[R, skew(t)·R], [0, R]]."""
    R = quat_to_matrix(rotation_quat(p))
    tR = skew(translation(p)) @ R
    zeros = jnp.zeros_like(R)
    top = jnp.concatenate([R, tR], axis=-1)
    bot = jnp.concatenate([zeros, R], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def exp(xi):
    """se(3) twist (...,6) [rho, phi] → pose (...,7)."""
    rho, phi = xi[..., 0:3], xi[..., 3:6]
    q = so3_exp_quat(phi)
    t = jnp.einsum("...ij,...j->...i", _so3_left_jacobian(phi), rho)
    return make_pose(t, q)


def log(p):
    """Pose (...,7) → twist (...,6). ρ = J_l⁻¹(φ)·t via the closed-form
    inverse left Jacobian (a batched LU solve here cost ~0.5 ms per BA
    iteration at the 1024-edge capacity — round-5 profiling)."""
    phi = so3_log(rotation_quat(p))
    Jli = _so3_left_jacobian_inv(phi)
    rho = jnp.einsum("...ij,...j->...i", Jli, translation(p))
    return jnp.concatenate([rho, phi], axis=-1)


def retract(p, xi):
    """Right-composition retraction p ∘ exp(xi) used by the GN backend."""
    return compose(p, exp(xi))


def boxminus(a, b):
    """log(b⁻¹ ∘ a): the twist from b to a (right convention)."""
    return log(compose(inverse(b), a))
