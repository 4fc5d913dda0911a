"""Batched SE(2) pose math + a planar pose-graph Gauss-Newton solver.

Counterpart of the reference's SE(2) graph types
(reference: include/putslam/Defs/putslam_defs.h:244-529 — ``VertexSE2`` /
``EdgeSE2`` declarations used by the planar variants of the pose graph;
SURVEY §7 "keep if cheap"). A pose is ``(..., 3)`` = [x, y, θ]; the whole
graph optimizes in one batched GN pass (the edge count of planar graphs is
small, so the normal equations build as dense (3K, 3K) directly).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp


def identity(batch_shape=(), dtype=jnp.float32):
    return jnp.zeros(batch_shape + (3,), dtype)


def _wrap(theta):
    return jnp.arctan2(jnp.sin(theta), jnp.cos(theta))


def compose(a, b):
    """a ∘ b (apply b then a)."""
    ca, sa = jnp.cos(a[..., 2]), jnp.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    return jnp.stack([x, y, _wrap(a[..., 2] + b[..., 2])], axis=-1)


def inverse(p):
    c, s = jnp.cos(p[..., 2]), jnp.sin(p[..., 2])
    x = -(c * p[..., 0] + s * p[..., 1])
    y = -(-s * p[..., 0] + c * p[..., 1])
    return jnp.stack([x, y, _wrap(-p[..., 2])], axis=-1)


def relative(a, b):
    """a⁻¹ ∘ b."""
    return compose(inverse(a), b)


def apply(p, pts):
    """Transform points (...,2) by poses (...,3)."""
    c, s = jnp.cos(p[..., 2:3]), jnp.sin(p[..., 2:3])
    x = c[..., 0] * pts[..., 0] - s[..., 0] * pts[..., 1] + p[..., 0]
    y = s[..., 0] * pts[..., 0] + c[..., 0] * pts[..., 1] + p[..., 1]
    return jnp.stack([x, y], axis=-1)


def _edge_residual(pi, pj, z):
    """r = z⁻¹ ∘ (pi⁻¹ ∘ pj) as a 3-vector [dx, dy, dθ]."""
    return relative(z, relative(pi, pj))


@functools.partial(jax.jit, static_argnums=(3,))
def optimize_pose_graph(poses: jnp.ndarray, edges: Tuple[jnp.ndarray, ...],
                        fixed: jnp.ndarray, iterations: int = 10
                        ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Planar pose-graph GN: ``poses`` (K, 3), ``edges`` = (i (E,), j (E,),
    z (E, 3), w (E,)), ``fixed`` (K,) bool gauge mask.

    Jacobians are numeric forward differences on the 3 tangent axes (planar
    residuals are cheap; E is small), the normal equations scatter into a
    dense (3K, 3K) system solved by Cholesky. Returns (poses', chi2 (it,))."""
    K = poses.shape[0]
    ei, ej, ez, ew = edges
    eps = 1e-5

    def residuals(p):
        return _edge_residual(p[ei], p[ej], ez)                  # (E, 3)

    def iteration(poses, _):
        r0 = residuals(poses)
        chi2 = jnp.sum(ew * jnp.sum(r0 * r0, axis=-1))
        # numeric Jacobians w.r.t. the two endpoints (E, 3, 3): perturb the
        # GATHERED endpoint poses per axis (a global-array perturbation
        # would leak into the other endpoint when vertices share edges)
        pi = poses[ei]
        pj = poses[ej]

        def jac_i(a):
            d = jnp.zeros((3,), poses.dtype).at[a].set(eps)
            return (_edge_residual(pi + d, pj, ez) - r0) / eps

        def jac_j(a):
            d = jnp.zeros((3,), poses.dtype).at[a].set(eps)
            return (_edge_residual(pi, pj + d, ez) - r0) / eps

        Ji = jnp.stack([jac_i(a) for a in range(3)], axis=-1)    # (E, 3, 3)
        Jj = jnp.stack([jac_j(a) for a in range(3)], axis=-1)
        H = jnp.zeros((K, K, 3, 3), poses.dtype)
        H = H.at[ei, ei].add(jnp.einsum("e,eri,erj->eij", ew, Ji, Ji))
        H = H.at[ej, ej].add(jnp.einsum("e,eri,erj->eij", ew, Jj, Jj))
        H = H.at[ei, ej].add(jnp.einsum("e,eri,erj->eij", ew, Ji, Jj))
        H = H.at[ej, ei].add(jnp.einsum("e,eri,erj->eij", ew, Jj, Ji))
        b = jnp.zeros((K, 3), poses.dtype)
        b = b.at[ei].add(-jnp.einsum("e,eri,er->ei", ew, Ji, r0))
        b = b.at[ej].add(-jnp.einsum("e,eri,er->ei", ew, Jj, r0))

        frozen3 = jnp.repeat(fixed, 3)
        Hd = H.transpose(0, 2, 1, 3).reshape(3 * K, 3 * K)
        Hd = jnp.where(frozen3[:, None] | frozen3[None, :], 0.0, Hd)
        Hd = Hd + jnp.diag(frozen3.astype(Hd.dtype))
        Hd = Hd + 1e-6 * jnp.eye(3 * K, dtype=Hd.dtype)
        bv = jnp.where(frozen3, 0.0, b.reshape(-1))
        dx = jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(Hd, lower=True), bv).reshape(K, 3)
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
        new = poses + jnp.where(fixed[:, None], 0.0, dx)
        new = new.at[:, 2].set(_wrap(new[:, 2]))
        return new, chi2

    # numeric Jacobians perturb the wrong endpoint rows when ei==ej is
    # possible; planar graphs never self-loop, callers keep i != j
    poses_out, chi2s = jax.lax.scan(iteration, poses, None,
                                    length=iterations)
    return poses_out, chi2s
