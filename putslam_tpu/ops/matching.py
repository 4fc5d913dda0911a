"""Descriptor matching as matmuls.

Batched replacement for the reference's BFMatcher cross-check matching
(reference: src/Matcher/matcherOpenCV.cpp:97-106 — Hamming norm for binary
descriptors, cross-check; the O(|A|·|B|) Hamming loop in ``performMatching``
:198-206).

With descriptors stored as ±1 int8 vectors, Hamming distance is an int8
matmul: dot(a, b) = (#agree − #disagree) = 256 − 2·hamming, so
hamming = (256 − a·b) / 2. One (N, 256) × (256, M) product scores
every pair at once; cross-check is two argmins over the distance matrix.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

INVALID_DIST = 1e9  # python float: folds into jit as a constant


def hamming_matrix(desc_a: jnp.ndarray, desc_b: jnp.ndarray,
                   valid_a=None, valid_b=None) -> jnp.ndarray:
    """Pairwise Hamming distances (N, M) float32 from ±1 int8 descriptors.

    Invalid rows/cols are set to INVALID_DIST so they can never win.
    """
    bits = desc_a.shape[-1]
    # bf16 is exact for ±1 operands and f32 accumulation is exact up to the
    # 256-long sums
    dots = jax.lax.dot_general(
        desc_a.astype(jnp.bfloat16), desc_b.astype(jnp.bfloat16),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    dist = 0.5 * (bits - dots)
    if valid_a is not None:
        dist = jnp.where(valid_a[:, None], dist, INVALID_DIST)
    if valid_b is not None:
        dist = jnp.where(valid_b[None, :], dist, INVALID_DIST)
    return dist


class Matches(NamedTuple):
    """Fixed-capacity match list: for each feature of A, its match in B."""

    idx_b: jnp.ndarray    # (N,) int32 — matched column per row of A
    dist: jnp.ndarray     # (N,) float32 — Hamming distance of the match
    valid: jnp.ndarray    # (N,) bool — cross-checked & distance-gated


def mutual_nn(dist: jnp.ndarray, max_dist: float) -> Matches:
    """Cross-checked nearest-neighbour matching (BFMatcher crossCheck=true):
    (i, j) is a match iff j = argmin_j d[i, :] and i = argmin_i d[:, j] and
    d[i, j] <= max_dist."""
    j_best = jnp.argmin(dist, axis=1)                      # (N,)
    i_best = jnp.argmin(dist, axis=0)                      # (M,)
    d_best = jnp.take_along_axis(dist, j_best[:, None], axis=1)[:, 0]
    mutual = i_best[j_best] == jnp.arange(dist.shape[0])
    valid = mutual & (d_best <= max_dist)
    return Matches(j_best.astype(jnp.int32), d_best, valid)


def ratio_test(dist: jnp.ndarray, ratio: float, max_dist: float) -> Matches:
    """Lowe-style acceptance: best match must beat the second best by
    ``ratio`` (used by the guided map matching, matcher.cpp:734-747 uses a
    ratio *of the best distance* — see slam_map/guided.py for that variant)."""
    neg = -dist
    top2, idx2 = jax.lax.top_k(neg, 2)
    d1, d2 = -top2[:, 0], -top2[:, 1]
    valid = (d1 <= max_dist) & (d1 <= ratio * jnp.maximum(d2, 1e-6))
    return Matches(idx2[:, 0].astype(jnp.int32), d1, valid)


def gather_pairs(xyz_a: jnp.ndarray, xyz_b: jnp.ndarray, m: Matches
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Matched 3D point pairs (both (N, 3)); rows with m.valid == False are
    garbage and must stay masked downstream."""
    return xyz_a, xyz_b[m.idx_b]
