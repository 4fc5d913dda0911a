"""Hypothesis-parallel RANSAC for SE(3) from 3D-3D correspondences.

Batched replacement for the reference's sequential adaptive RANSAC
(reference: src/TransformEst/RANSAC.cpp:50-174 — depth-validity prefilter
:64-74, 3-pair sampling :180-205, Umeyama fit :207-244, inlier-error models
:251-436, adaptive iteration count :457-461, best-inlier refit :152-158,
identity fallback :161-164).

The sequential loop (whose iteration count adapts to the inlier ratio) is
replaced by a *fixed batch of H hypotheses evaluated at once*: sampling is a
Gumbel top-k per hypothesis, model fitting is the batched quaternion Kabsch,
and inlier counting is one (H, N) masked distance computation. H is chosen
larger than the reference's worst-case adaptive count, so this is strictly
more robust per call while mapping onto dense batched compute.

Error models mirror the reference: Euclidean (errorVersion 0), reprojection
(1), both (2), adaptive depth-scaled Euclidean (4) — RANSAC.cpp:251-436.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from putslam_tpu.config import CameraConfig, RansacConfig
from putslam_tpu.geometry import camera as camera_mod
from putslam_tpu.geometry import se3
from putslam_tpu.ops import kabsch


class RansacResult(NamedTuple):
    pose: jnp.ndarray          # (7,) best SE(3): q_b ≈ T · p_a
    inliers: jnp.ndarray       # (N,) bool
    n_inliers: jnp.ndarray     # () int32
    inlier_ratio: jnp.ndarray  # () float32 — inliers / valid matches
    ok: jnp.ndarray            # () bool — False → identity fallback applied


def _pair_errors(cfg: RansacConfig, cam: Optional[CameraConfig],
                 T, p, q, info=None):
    """Per-pair error and threshold according to the configured model.

    T: (..., 7); p, q: (N, 3); info: optional (N, 3, 3) per-pair information
    matrices (Mahalanobis model). ``info`` MUST be symmetric: the quadratic
    form below reads only the upper triangle and doubles the off-diagonal
    terms (valid for any information matrix; an asymmetric input would be
    silently symmetrized as 0.5*(info+infoᵀ)).
    Returns (err (..., N), thr (..., N)).

    Structure-of-arrays throughout: the predicted points are computed as
    (..., N) component arrays (se3.apply_soa) — never as an (..., N, 3)
    tensor with a size-3 minor dim."""
    Te = T[..., None, :]                                  # (..., 1, 7)
    x, y, z = se3.apply_soa(Te, p[..., 0], p[..., 1], p[..., 2])  # (..., N)
    dx, dy, dz = x - q[..., 0], y - q[..., 1], z - q[..., 2]

    def reproj_err():
        # pixel-space distance between projected prediction and observation
        zp = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        zo = jnp.where(jnp.abs(q[..., 2]) < 1e-9, 1e-9, q[..., 2])
        du = cam.fu * (x / zp - q[..., 0] / zo)
        dv = cam.fv * (y / zp - q[..., 1] / zo)
        return jnp.sqrt(du * du + dv * dv)

    if cfg.error_version == 0:        # Euclidean, RANSAC.cpp:251-281
        err = jnp.sqrt(dx * dx + dy * dy + dz * dz)
        thr = jnp.full_like(err, cfg.inlier_threshold_euclidean)
    elif cfg.error_version == 4:      # adaptive: threshold grows with depth
        err = jnp.sqrt(dx * dx + dy * dy + dz * dz)
        thr = cfg.inlier_threshold_euclidean * jnp.maximum(q[..., 2], 1.0)
    elif cfg.error_version == 1:      # reprojection (px), RANSAC.cpp:316-368
        err = reproj_err()
        thr = jnp.full_like(err, cfg.inlier_threshold_reprojection)
    elif cfg.error_version == 2:      # Euclidean AND reprojection
        e1 = jnp.sqrt(dx * dx + dy * dy + dz * dz)
        e2 = reproj_err()
        # normalize both to their thresholds; inlier iff both pass
        err = jnp.maximum(e1 / cfg.inlier_threshold_euclidean,
                          e2 / cfg.inlier_threshold_reprojection)
        thr = jnp.ones_like(err)
    elif cfg.error_version == 3:      # Mahalanobis (RANSAC.cpp:383-436)
        if info is None:
            err = dx * dx + dy * dy + dz * dz
        else:
            i00, i01, i02 = info[:, 0, 0], info[:, 0, 1], info[:, 0, 2]
            i11, i12, i22 = info[:, 1, 1], info[:, 1, 2], info[:, 2, 2]
            err = (i00 * dx * dx + i11 * dy * dy + i22 * dz * dz
                   + 2.0 * (i01 * dx * dy + i02 * dx * dz + i12 * dy * dz))
        thr = jnp.full_like(err, cfg.inlier_threshold_mahalanobis)
    else:
        raise ValueError(f"unsupported error_version {cfg.error_version}")
    return err, thr


@functools.partial(jax.jit, static_argnums=(0, 1))
def estimate(cfg: RansacConfig, cam: Optional[CameraConfig],
             key: jax.Array, p: jnp.ndarray, q: jnp.ndarray,
             valid: jnp.ndarray, quality: jnp.ndarray = None,
             info: jnp.ndarray = None) -> RansacResult:
    """Estimate T with q ≈ T·p from masked correspondences.

    p, q: (N, 3) matched 3D points (camera frames A and B); valid: (N,) bool
    (already includes the depth-validity prefilter, RANSAC.cpp:64-74);
    ``quality``: optional per-match distance (lower=better) enabling
    PROSAC-style biased sampling when cfg.quality_tau > 0; ``info``:
    optional (N,3,3) information matrices for the Mahalanobis model.
    """
    N = p.shape[0]
    H = cfg.n_hypotheses
    n_valid = jnp.sum(valid)

    # --- sample `used_pairs` valid indices per hypothesis -----------------
    # Weighted-over-valid via prefix-sum + binary search: O(H·k·log N),
    # cheaper than Gumbel-top-k, whose (H, N) top_k is a per-row sort. Sampling is with
    # replacement; a duplicated index yields a degenerate hypothesis that
    # simply scores ~0 inliers and loses the argmax.
    if cfg.quality_tau > 0.0 and quality is not None:
        wgt = jnp.where(valid, jnp.exp(-quality / cfg.quality_tau), 0.0)
    else:
        wgt = valid.astype(p.dtype)
    csum = jnp.cumsum(wgt)                                 # (N,)
    total = jnp.maximum(csum[-1], 1e-9)
    u = jax.random.uniform(key, (cfg.used_pairs, H), maxval=1.0)
    sample_idx = jnp.searchsorted(csum, u * total, side="left")
    sample_idx = jnp.clip(sample_idx, 0, N - 1)           # (k, H)

    # --- fit all hypotheses at once ---------------------------------------
    # Samples gathered per COMPONENT with the point axis leading ((k, H)
    # arrays): the minimal-set Kabsch then never builds an (H, k, 3) tensor
    # whose 3-wide minor dim would be tile-padded ~42× (see kabsch.kabsch_soa).
    T = kabsch.kabsch_soa(
        p[:, 0][sample_idx], p[:, 1][sample_idx], p[:, 2][sample_idx],
        q[:, 0][sample_idx], q[:, 1][sample_idx], q[:, 2][sample_idx],
    )                                                      # (H, 7)

    # --- score: masked inlier count + mean inlier error -------------------
    err, thr = _pair_errors(cfg, cam, T, p, q, info)      # (H, N)
    inl = (err < thr) & valid[None, :]
    counts = jnp.sum(inl, axis=-1)
    mean_err = jnp.sum(jnp.where(inl, err, 0.0), axis=-1) / jnp.maximum(counts, 1)
    # rank by count, tie-break by lower mean inlier error (RANSAC.cpp:438-455)
    score = counts.astype(jnp.float32) - mean_err / (
        jnp.max(mean_err) + 1e-6)
    best = jnp.argmax(score)
    T_best = T[best]
    inl_best = inl[best]

    # --- refit on inliers (RANSAC.cpp:152-158), iterated -------------------
    def refit(carry, _):
        T_c, inl_c = carry
        T_n = kabsch.weighted_kabsch(p, q, inl_c.astype(p.dtype))
        err_n, thr_n = _pair_errors(cfg, cam, T_n, p, q, info)
        inl_n = (err_n < thr_n) & valid
        # keep refit only if it does not lose inliers
        better = jnp.sum(inl_n) >= jnp.sum(inl_c)
        T_o = jnp.where(better, T_n, T_c)
        inl_o = jnp.where(better, inl_n, inl_c)
        return (T_o, inl_o), None

    (T_best, inl_best), _ = jax.lax.scan(
        refit, (T_best, inl_best), None, length=cfg.refit_iterations
    )

    n_inl = jnp.sum(inl_best)
    ratio = n_inl / jnp.maximum(n_valid, 1)
    ok = (ratio >= cfg.minimal_inlier_ratio) & (n_valid >= cfg.minimal_num_matches)

    # identity fallback (RANSAC.cpp:161-164)
    ident = se3.identity(dtype=p.dtype)
    pose = jnp.where(ok, T_best, ident)
    inliers = inl_best & ok
    return RansacResult(pose, inliers, n_inl.astype(jnp.int32),
                        ratio.astype(jnp.float32), ok)
