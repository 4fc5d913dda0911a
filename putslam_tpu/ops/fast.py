"""FAST corner detection as dense whole-image elementwise ops.

Batched replacement for the reference's cv::FastFeatureDetector /
cv::ORB detection with per-grid-cell response capping
(reference: src/Matcher/matcherOpenCV.cpp:97-180 — ``detectFeatures`` with
gridRows×gridCols cells, per-cell response sort + cap; DBScan declustering
src/Matcher/dbscan.cpp:79-123).

Instead of per-pixel branching, the segment test runs as a stack of shifted
image comparisons — pure elementwise arithmetic over the full frame, which XLA
fuses into a handful of loops. Non-max suppression is a windowed max;
the detection cap is per-cell top-k followed by a global top-k (exactly the
grid policy of the reference, but branch-free).

All outputs are fixed-capacity arrays + validity masks.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

# Bresenham circle of radius 3 — the 16 FAST offsets in clockwise order.
FAST_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
ARC_LENGTH = 9  # FAST-9: at least 9 contiguous circle pixels pass the test


def _shift2d(img, dx: int, dy: int):
    """Shift image content by (-dy, -dx) so result[y, x] = img[y+dy, x+dx],
    zero-padded at borders. Static shifts → XLA pad+slice, no gather."""
    H, W = img.shape
    y0, y1 = max(dy, 0), H + min(dy, 0)
    x0, x1 = max(dx, 0), W + min(dx, 0)
    core = img[y0:y1, x0:x1]
    return jnp.pad(core, ((max(-dy, 0), max(dy, 0)), (max(-dx, 0), max(dx, 0))))


def fast_score_map(gray: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """FAST-9 corner response for every pixel of ``gray`` (H, W) in [0, 1].

    ``threshold`` is on the 0..255 intensity scale (reference config scale).
    Returns (H, W) float32 scores; 0 where the segment test fails. The score
    is the sum over circle pixels of the excess |I(q) − I(p)| − t for the
    passing polarity (a standard SAD-style FAST score used for NMS ranking).
    """
    img = gray * 255.0
    t = jnp.float32(threshold)
    # Accumulate everything in ONE unrolled pass over the 16 circle offsets:
    # per-pixel 16-bit masks of bright/dark flags + the SAD excess sums.
    # All elementwise over (H, W) — XLA fuses the chain into a few loops
    # with no (16, H, W) intermediates (the stacked-diff formulation moves
    # ~10× the bytes once detection is batched over frames).
    mask_b = jnp.zeros(img.shape, jnp.int32)
    mask_d = jnp.zeros(img.shape, jnp.int32)
    excess_b = jnp.zeros(img.shape, jnp.float32)
    excess_d = jnp.zeros(img.shape, jnp.float32)
    for k, (dx, dy) in enumerate(FAST_OFFSETS):
        diff = _shift2d(img, dx, dy) - img
        mask_b = mask_b | ((diff > t).astype(jnp.int32) << k)
        mask_d = mask_d | ((diff < -t).astype(jnp.int32) << k)
        excess_b = excess_b + jnp.maximum(diff - t, 0.0)
        excess_d = excess_d + jnp.maximum(-diff - t, 0.0)

    # contiguous-run test: bits s..s+8 (cyclic over 16) all set for some s
    is_bright = jnp.zeros(img.shape, bool)
    is_dark = jnp.zeros(img.shape, bool)
    full = (1 << 16) - 1
    for s in range(16):
        arc = (((0x1FF << s) | (0x1FF >> (16 - s))) & full)
        is_bright = is_bright | ((mask_b & arc) == arc)
        is_dark = is_dark | ((mask_d & arc) == arc)
    score = jnp.where(is_bright, excess_b, 0.0) + jnp.where(is_dark, excess_d, 0.0)
    # kill the 3-px border where the circle leaves the image
    H, W = gray.shape
    yy = jnp.arange(H)[:, None]
    xx = jnp.arange(W)[None, :]
    inside = (yy >= 3) & (yy < H - 3) & (xx >= 3) & (xx < W - 3)
    return jnp.where(inside, score, 0.0)


def nms(score: jnp.ndarray, radius: int) -> jnp.ndarray:
    """Keep strict local maxima within a (2r+1)² window (the DBScan-style
    declustering of dbscan.cpp:79-123 as a windowed max)."""
    w = 2 * radius + 1
    pooled = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (w, w), (1, 1), "SAME"
    )
    return jnp.where((score >= pooled) & (score > 0.0), score, 0.0)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def grid_topk(score: jnp.ndarray, grid_rows: int, grid_cols: int,
              max_features: int) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Grid-capped detection (matcherOpenCV.cpp:118-180): bounded detections
    per grid cell by response, then global top-``max_features``.

    ``lax.top_k`` over whole cells lowers to a full per-row sort. Instead
    each cell is subdivided into m×m subtiles and each
    subtile keeps ONE winner (an argmax — a cheap max-reduce), with m chosen
    so the per-cell candidate count matches the reference's per-cell cap.
    One winner per subtile is a slightly stronger spatial spread than
    per-cell-top-k (a dense cluster inside one subtile yields one detection
    instead of several), which is the same declustering direction the
    reference's DBScan step pushes in (dbscan.cpp:79-123). The small
    candidate set (a few thousand) then goes through one global top-k.

    Returns (uv (K,2) float32 [u, v], response (K,), valid (K,) bool), sorted
    by descending response; invalid slots have response 0 and uv (-1, -1).
    """
    H, W = score.shape
    # per-cell cap of the reference policy (×2 headroom, as before)
    k_cell = -(-max_features // (grid_rows * grid_cols)) * 2
    m = max(int(-(-(k_cell ** 0.5) // 1)), 1)  # ceil(sqrt(k_cell))
    nsh, nsw = grid_rows * m, grid_cols * m    # subtile grid over the image
    sub_h = -(-H // nsh)
    sub_w = -(-W // nsw)
    Hp, Wp = sub_h * nsh, sub_w * nsw
    padded = jnp.pad(score, ((0, Hp - H), (0, Wp - W)))
    tiles = padded.reshape(nsh, sub_h, nsw, sub_w)
    tiles = tiles.transpose(0, 2, 1, 3).reshape(nsh * nsw, sub_h * sub_w)
    tile_best = jnp.max(tiles, axis=1)                    # (S,)
    tile_arg = jnp.argmax(tiles, axis=1)                  # (S,)

    # absolute pixel coordinates of each subtile winner
    s = jnp.arange(nsh * nsw)
    cy = (s // nsw) * sub_h + tile_arg // sub_w
    cx = (s % nsw) * sub_w + tile_arg % sub_w

    k = min(max_features, tile_best.shape[0])
    top_scores, top_idx = jax.lax.top_k(tile_best, k)
    uv = jnp.stack([cx[top_idx].astype(jnp.float32),
                    cy[top_idx].astype(jnp.float32)], axis=-1)
    valid = top_scores > 0.0
    uv = jnp.where(valid[:, None], uv, -1.0)
    if k < max_features:
        pad = max_features - k
        uv = jnp.pad(uv, ((0, pad), (0, 0)), constant_values=-1.0)
        top_scores = jnp.pad(top_scores, (0, pad))
        valid = jnp.pad(valid, (0, pad))
    return uv, jnp.where(valid, top_scores, 0.0), valid


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def grid_topk_exact(score: jnp.ndarray, grid_rows: int, grid_cols: int,
                    max_features: int
                    ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """EXACT per-cell top-k — the reference's policy verbatim
    (matcherOpenCV.cpp:118-180: per-cell response sort + cap, then global
    cap). ``lax.top_k`` over whole cells lowers to a full per-row sort
    (~0.27 ms/frame at 640×480 — 4× the subtile path), so this is the
    *oracle* the fast ``grid_topk`` is validated against
    (tests/test_round4.py) and a selectable operating point
    (DetectorConfig.grid_policy="exact") for parity runs."""
    H, W = score.shape
    k_cell = -(-max_features // (grid_rows * grid_cols)) * 2
    cell_h = -(-H // grid_rows)
    cell_w = -(-W // grid_cols)
    Hp, Wp = cell_h * grid_rows, cell_w * grid_cols
    padded = jnp.pad(score, ((0, Hp - H), (0, Wp - W)))
    cells = padded.reshape(grid_rows, cell_h, grid_cols, cell_w)
    cells = cells.transpose(0, 2, 1, 3).reshape(
        grid_rows * grid_cols, cell_h * cell_w)
    k_cell = min(k_cell, cell_h * cell_w)
    c_scores, c_arg = jax.lax.top_k(cells, k_cell)       # (C, k_cell)
    cidx = jnp.arange(grid_rows * grid_cols)[:, None]
    cy = (cidx // grid_cols) * cell_h + c_arg // cell_w
    cx = (cidx % grid_cols) * cell_w + c_arg % cell_w
    flat_s = c_scores.reshape(-1)
    flat_x = cx.reshape(-1)
    flat_y = cy.reshape(-1)
    k = min(max_features, flat_s.shape[0])
    top_scores, top_idx = jax.lax.top_k(flat_s, k)
    uv = jnp.stack([flat_x[top_idx].astype(jnp.float32),
                    flat_y[top_idx].astype(jnp.float32)], axis=-1)
    valid = top_scores > 0.0
    uv = jnp.where(valid[:, None], uv, -1.0)
    if k < max_features:
        pad = max_features - k
        uv = jnp.pad(uv, ((0, pad), (0, 0)), constant_values=-1.0)
        top_scores = jnp.pad(top_scores, (0, pad))
        valid = jnp.pad(valid, (0, pad))
    return uv, jnp.where(valid, top_scores, 0.0), valid


def subpixel_refine(score: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Quadratic (parabola) sub-pixel refinement of keypoint locations on the
    response map (the reference gets sub-pixel implicitly through KLT /
    patch Gauss-Newton, src/Matcher/MatchingOnPatches.cpp; here a 3×3 fit).

    uv: (K, 2) integer-valued float coords → refined float coords, offsets
    clamped to ±0.5 px."""
    H, W = score.shape
    u = jnp.clip(uv[:, 0].astype(jnp.int32), 1, W - 2)
    v = jnp.clip(uv[:, 1].astype(jnp.int32), 1, H - 2)

    def grab(du, dv):
        return score[v + dv, u + du]

    s_c = grab(0, 0)
    dx = 0.5 * (grab(1, 0) - grab(-1, 0))
    dy = 0.5 * (grab(0, 1) - grab(0, -1))
    dxx = grab(1, 0) - 2 * s_c + grab(-1, 0)
    dyy = grab(0, 1) - 2 * s_c + grab(0, -1)
    ou = jnp.where(jnp.abs(dxx) > 1e-6, -dx / dxx, 0.0)
    ov = jnp.where(jnp.abs(dyy) > 1e-6, -dy / dyy, 0.0)
    ou = jnp.clip(ou, -0.5, 0.5)
    ov = jnp.clip(ov, -0.5, 0.5)
    return uv + jnp.stack([ou, ov], axis=-1)


def detect(gray: jnp.ndarray, threshold: float, nms_radius: int,
           grid_rows: int, grid_cols: int, max_features: int,
           grid_policy: str = "subtile"):
    """fast_score_map → nms → grid cap → subpixel refine, one call.
    ``grid_policy``: "subtile" (fast, one winner per subtile) or "exact"
    (the reference's per-cell top-k, ~4× the cap cost)."""
    raw = fast_score_map(gray, threshold)
    s = nms(raw, nms_radius)
    cap = grid_topk if grid_policy == "subtile" else grid_topk_exact
    uv, resp, valid = cap(s, grid_rows, grid_cols, max_features)
    uv = jnp.where(valid[:, None], subpixel_refine(raw, uv), uv)
    return uv, resp, valid
