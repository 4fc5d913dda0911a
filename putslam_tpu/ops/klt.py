"""Batched pyramidal Lucas-Kanade optical flow (KLT).

Batched replacement for the reference's tracking front-end
(reference: src/Matcher/matcherOpenCV.cpp:209-300 ``performTracking`` —
cv::calcOpticalFlowPyrLK with winSize 7, 3 levels, error threshold + pruning;
the Gauss-Newton patch alignment of src/Matcher/MatchingOnPatches.cpp:37-66
is the single-level case of the same iteration with a precomputed inverse
Hessian).

All N tracks advance together: each GN iteration is a batched (N, W²)
bilinear sample + two (N,) 2×2 solves — no per-feature loops. Iteration
counts are static (masked convergence), so the whole tracker jits into one
program.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from putslam_tpu.config import TrackerConfig


def build_pyramid(img: jnp.ndarray, levels: int) -> List[jnp.ndarray]:
    """Halving average-pool pyramid (cv::buildOpticalFlowPyramid analog)."""
    pyr = [img]
    for _ in range(levels - 1):
        im = pyr[-1]
        H2, W2 = (im.shape[0] // 2) * 2, (im.shape[1] // 2) * 2
        im = im[:H2, :W2].reshape(H2 // 2, 2, W2 // 2, 2).mean(axis=(1, 3))
        pyr.append(im)
    return pyr


def _grad(img):
    gx = jnp.zeros_like(img)
    gx = gx.at[:, 1:-1].set(0.5 * (img[:, 2:] - img[:, :-2]))
    gy = jnp.zeros_like(img)
    gy = gy.at[1:-1, :].set(0.5 * (img[2:, :] - img[:-2, :]))
    return gx, gy


def _sample_patches(img, pts, offs):
    """Bilinear patches: img (H,W), pts (N,2), offs (W2,2) → (N, W2)."""
    H, W = img.shape
    u = jnp.clip(pts[:, None, 0] + offs[None, :, 0], 0.0, W - 1.001)
    v = jnp.clip(pts[:, None, 1] + offs[None, :, 1], 0.0, H - 1.001)
    x0 = jnp.floor(u).astype(jnp.int32)
    y0 = jnp.floor(v).astype(jnp.int32)
    du = u - x0
    dv = v - y0
    i00 = img[y0, x0]
    i01 = img[y0, x0 + 1]
    i10 = img[y0 + 1, x0]
    i11 = img[y0 + 1, x0 + 1]
    return (i00 * (1 - du) * (1 - dv) + i01 * du * (1 - dv)
            + i10 * (1 - du) * dv + i11 * du * dv)


class TrackResult(NamedTuple):
    pts: jnp.ndarray     # (N, 2) tracked positions in the new frame
    err: jnp.ndarray     # (N,) mean |ΔI| over the window (trackingErrorType 0)
    valid: jnp.ndarray   # (N,) bool — converged, in-image, below error gate


@functools.partial(jax.jit, static_argnums=(0,))
def track(tcfg: TrackerConfig, prev: jnp.ndarray, curr: jnp.ndarray,
          pts: jnp.ndarray, valid: jnp.ndarray,
          init_flow: jnp.ndarray = None) -> TrackResult:
    """Track ``pts`` (N,2, pixels in ``prev``) into ``curr``.

    Inverse-compositional LK: template gradients (and the 2×2 structure
    matrix) come from the *previous* frame once per level; each iteration
    only samples the current frame.
    """
    r = tcfg.win_size // 2
    oy, ox = jnp.meshgrid(
        jnp.arange(-r, r + 1, dtype=jnp.float32),
        jnp.arange(-r, r + 1, dtype=jnp.float32), indexing="ij")
    offs = jnp.stack([ox.reshape(-1), oy.reshape(-1)], axis=-1)  # (W2,2)

    prev_pyr = build_pyramid(prev, tcfg.max_levels)
    curr_pyr = build_pyramid(curr, tcfg.max_levels)

    # displacement at level-0 scale (useInitialFlow analog)
    flow = jnp.zeros_like(pts) if init_flow is None else init_flow
    min_eig = jnp.full((pts.shape[0],), jnp.inf)

    for lvl in reversed(range(tcfg.max_levels)):
        s = 2.0 ** lvl
        p_l = pts / s
        img_p = prev_pyr[lvl]
        img_c = curr_pyr[lvl]
        gx, gy = _grad(img_p)
        T = _sample_patches(img_p, p_l, offs)               # template (N,W2)
        Tx = _sample_patches(gx, p_l, offs)
        Ty = _sample_patches(gy, p_l, offs)
        # structure matrix G = [[Σgx², Σgxgy], [Σgxgy, Σgy²]]
        a = jnp.sum(Tx * Tx, axis=-1)
        b = jnp.sum(Tx * Ty, axis=-1)
        c = jnp.sum(Ty * Ty, axis=-1)
        det = a * c - b * b
        inv_ok = det > 1e-6
        det_safe = jnp.where(inv_ok, det, 1.0)
        # minimal eigenvalue per pixel count (cv::minEigThreshold semantics)
        tr_half = 0.5 * (a + c)
        eig = tr_half - jnp.sqrt(jnp.maximum(tr_half ** 2 - det, 0.0))
        min_eig = jnp.minimum(min_eig, eig / offs.shape[0])

        def gn_iter(i, fl):
            q = p_l + fl / s
            I = _sample_patches(img_c, q, offs)
            diff = I - T                                    # (N,W2)
            bx = jnp.sum(Tx * diff, axis=-1)
            by = jnp.sum(Ty * diff, axis=-1)
            du = (c * bx - b * by) / det_safe
            dv = (a * by - b * bx) / det_safe
            step = jnp.stack([du, dv], axis=-1) * s
            step = jnp.where(inv_ok[:, None], step, 0.0)
            # masked convergence: stop moving once |step| < eps
            small = jnp.linalg.norm(step, axis=-1) < tcfg.eps * s
            return fl - jnp.where(small[:, None], 0.0, step)

        flow = jax.lax.fori_loop(0, tcfg.max_iter, gn_iter, flow)

    new_pts = pts + flow
    # final photometric error at level 0
    I0 = _sample_patches(curr_pyr[0], new_pts, offs)
    T0 = _sample_patches(prev_pyr[0], pts, offs)
    err = jnp.mean(jnp.abs(I0 - T0), axis=-1) * 255.0       # 0..255 scale
    H, W = prev.shape
    inb = (
        (new_pts[:, 0] >= r) & (new_pts[:, 0] <= W - 1 - r)
        & (new_pts[:, 1] >= r) & (new_pts[:, 1] <= H - 1 - r)
    )
    ok = valid & inb & (err < tcfg.error_threshold)
    return TrackResult(new_pts, err, ok)


def refine_patch_alignment(tcfg: TrackerConfig, ref_img, tgt_img, ref_pts,
                           tgt_pts_init, valid) -> TrackResult:
    """Single-level Gauss-Newton photometric refinement of candidate
    correspondences (MatchingOnPatches.cpp ``optimizeLocation``): polish an
    initial guess in the target image (e.g. from descriptor matching) to
    sub-pixel photometric alignment."""
    one = TrackerConfig(win_size=tcfg.win_size, max_levels=1,
                        max_iter=tcfg.max_iter, eps=tcfg.eps,
                        error_threshold=tcfg.error_threshold)
    return track(one, ref_img, tgt_img, ref_pts, valid,
                 init_flow=tgt_pts_init - ref_pts)


@functools.partial(jax.jit, static_argnums=(0,))
def refine_patch_alignment_affine(tcfg: TrackerConfig, ref_img, tgt_img,
                                  ref_pts, tgt_pts_init,
                                  valid) -> TrackResult:
    """Affine-warped inverse-compositional patch alignment — the WARPING
    variant of MatchingOnPatches (the reference declares the option in
    include/putslam/Matcher/MatchingOnPatches.h:37-66 but ships only the
    translational optimizeLocation; this implements the full 6-DoF
    inverse-compositional Lucas-Kanade, so slanted/rotated patches align
    where pure translation plateaus).

    Warp W(x; p) = (I + A)·x + t around the template point, p = (a₁..a₄,
    tx, ty). Template gradients/Hessian precompute once; each iteration is
    one batched bilinear sample + a (N,6,6) solve; update composes the
    inverted incremental warp (Baker-Matthews IC)."""
    r = tcfg.win_size // 2
    oy, ox = jnp.meshgrid(
        jnp.arange(-r, r + 1, dtype=jnp.float32),
        jnp.arange(-r, r + 1, dtype=jnp.float32), indexing="ij")
    offs = jnp.stack([ox.reshape(-1), oy.reshape(-1)], axis=-1)   # (W2, 2)
    W2 = offs.shape[0]
    N = ref_pts.shape[0]

    gx, gy = _grad(ref_img)
    T = _sample_patches(ref_img, ref_pts, offs)                   # (N, W2)
    Tx = _sample_patches(gx, ref_pts, offs)
    Ty = _sample_patches(gy, ref_pts, offs)
    # steepest-descent images: (N, W2, 6)
    sd = jnp.stack([Tx * offs[None, :, 0], Tx * offs[None, :, 1],
                    Ty * offs[None, :, 0], Ty * offs[None, :, 1],
                    Tx, Ty], axis=-1)
    Hm = jnp.einsum("nwa,nwb->nab", sd, sd)                       # (N, 6, 6)
    Hm = Hm + 1e-4 * jnp.eye(6, dtype=Hm.dtype)

    # warp state as 2x3 matrices [I+A | t], t initialized from the guess
    M0 = jnp.tile(jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
                            ref_img.dtype), (N, 1, 1))
    M0 = M0.at[:, :, 2].set(tgt_pts_init - ref_pts)

    def gn_iter(i, M):
        # sample target at warped offsets around the template point
        w_off = jnp.einsum("nab,wb->nwa", M[:, :, :2], offs) \
            + M[:, None, :, 2]
        q = ref_pts[:, None, :] + w_off                           # (N, W2, 2)
        H, Wd = tgt_img.shape
        u = jnp.clip(q[..., 0], 0.0, Wd - 1.001)
        v = jnp.clip(q[..., 1], 0.0, H - 1.001)
        x0 = jnp.floor(u).astype(jnp.int32)
        y0 = jnp.floor(v).astype(jnp.int32)
        du, dv = u - x0, v - y0
        I = (tgt_img[y0, x0] * (1 - du) * (1 - dv)
             + tgt_img[y0, x0 + 1] * du * (1 - dv)
             + tgt_img[y0 + 1, x0] * (1 - du) * dv
             + tgt_img[y0 + 1, x0 + 1] * du * dv)
        b = jnp.einsum("nwa,nw->na", sd, I - T)                   # (N, 6)
        dp = jnp.linalg.solve(Hm, b[..., None])[..., 0]           # (N, 6)
        # compose M ← M ∘ inv(W(dp)) in homogeneous 3x3 form
        Md = jnp.tile(jnp.eye(3, dtype=M.dtype), (N, 1, 1))
        Md = Md.at[:, 0, 0].add(dp[:, 0]).at[:, 0, 1].add(dp[:, 1])
        Md = Md.at[:, 1, 0].add(dp[:, 2]).at[:, 1, 1].add(dp[:, 3])
        Md = Md.at[:, 0, 2].add(dp[:, 4]).at[:, 1, 2].add(dp[:, 5])
        M3 = jnp.concatenate(
            [M, jnp.tile(jnp.array([[0.0, 0.0, 1.0]], M.dtype),
                         (N, 1, 1))], axis=1)
        Mn = jnp.einsum("nab,nbc->nac", M3, jnp.linalg.inv(Md))[:, :2, :]
        small = jnp.linalg.norm(dp[:, 4:6], axis=-1) < tcfg.eps
        return jnp.where(small[:, None, None], M, Mn)

    M = jax.lax.fori_loop(0, tcfg.max_iter, gn_iter, M0)
    new_pts = ref_pts + M[:, :, 2]
    # photometric error under the final warp
    w_off = jnp.einsum("nab,wb->nwa", M[:, :, :2], offs) + M[:, None, :, 2]
    q = ref_pts[:, None, :] + w_off
    H, Wd = tgt_img.shape
    u = jnp.clip(q[..., 0], 0.0, Wd - 1.001)
    v = jnp.clip(q[..., 1], 0.0, H - 1.001)
    x0 = jnp.floor(u).astype(jnp.int32)
    y0 = jnp.floor(v).astype(jnp.int32)
    du, dv = u - x0, v - y0
    I = (tgt_img[y0, x0] * (1 - du) * (1 - dv)
         + tgt_img[y0, x0 + 1] * du * (1 - dv)
         + tgt_img[y0 + 1, x0] * (1 - du) * dv
         + tgt_img[y0 + 1, x0 + 1] * du * dv)
    err = jnp.mean(jnp.abs(I - T), axis=-1) * 255.0
    inb = (
        (new_pts[:, 0] >= r) & (new_pts[:, 0] <= Wd - 1 - r)
        & (new_pts[:, 1] >= r) & (new_pts[:, 1] <= H - 1 - r)
    )
    ok = valid & inb & (err < tcfg.error_threshold)
    return TrackResult(new_pts, err, ok)
