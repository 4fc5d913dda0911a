"""Oriented binary descriptors (steered BRIEF / ORB-class), batched.

Batched replacement for the reference's cv::ORB descriptor stage and the
vendored LDB (reference: src/Matcher/matcherOpenCV.cpp:182-196
``describeFeatures``; src/LDB/ldb.cpp — 0/1 intensity/gradient tests; multi-
octave handling matcher.cpp:283-338).

Pipeline: a box-smoothed image → one 32×32 patch per keypoint (batched
dynamic-slice gather) → intensity-centroid orientation (ORB's moments) →
256 pairwise intensity tests at coordinates rotated by the orientation,
bilinearly sampled *inside the patch* so the whole descriptor stage is a
(N, 256)-shaped dense computation. Descriptors are stored as ±1 int8 so
Hamming distance becomes a bf16 matmul (see ops/matching.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

PATCH = 32            # extracted patch side
DESC_BITS = 256       # descriptor length
TEST_SIGMA = 5.0      # BRIEF-II: test endpoints ~ N(0, (PATCH/5)^2 / 4)
TEST_CLIP = 12.0      # keep endpoints well inside the patch (rotation margin)


def make_test_pattern(seed: int = 1234) -> np.ndarray:
    """The 256 (p, q) test-point pairs, shape (256, 4) = [px, py, qx, qy],
    coordinates relative to patch center. Classic BRIEF-II Gaussian sampling
    with a fixed seed (generated, not copied from any implementation)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, TEST_SIGMA, size=(DESC_BITS, 4)).astype(np.float32)
    return np.clip(pts, -TEST_CLIP, TEST_CLIP)


_PATTERN = make_test_pattern()  # numpy: jit inlines it as a constant

# Disc mask + coordinate grids for the intensity-centroid orientation
# (radius = 15, ORB's standard moment patch).
_yy, _xx = np.mgrid[0:PATCH, 0:PATCH].astype(np.float32)
_cx = _cy = (PATCH - 1) / 2.0
# NOTE: keep module-level constants as NUMPY — a jit that closes over a
# device array pays a host sync + re-ship per call on remote backends,
# while numpy constants fold into the compiled executable for free.
_DISC = ((_xx - _cx) ** 2 + (_yy - _cy) ** 2 <= 15.0 ** 2).astype(np.float32)
_XREL = _xx - _cx
_YREL = _yy - _cy


def box_blur(img: jnp.ndarray, radius: int = 2) -> jnp.ndarray:
    """Separable box blur (BRIEF's pre-smoothing; OpenCV uses a 31×31
    integral-image box of 5 — radius 2 box is the same smoothing scale)."""
    w = 2 * radius + 1
    kernel = jnp.ones((w,), img.dtype) / w
    x = img[None, None, :, :]
    kv = kernel.reshape(1, 1, w, 1)
    kh = kernel.reshape(1, 1, 1, w)
    x = jax.lax.conv_general_dilated(x, kv, (1, 1), [(radius, radius), (0, 0)])
    x = jax.lax.conv_general_dilated(x, kh, (1, 1), [(0, 0), (radius, radius)])
    return x[0, 0]


def extract_patches(img: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Gather one PATCH×PATCH window centered at each (integer-rounded)
    keypoint. uv: (N, 2) float [u, v] → (N, PATCH, PATCH).

    Out-of-range coordinates are clamped (callers should already exclude
    border keypoints via the detection border)."""
    H, W = img.shape
    half = PATCH // 2
    u0 = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32) - half, 0, W - PATCH)
    v0 = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32) - half, 0, H - PATCH)

    def slice_one(v, u):
        return jax.lax.dynamic_slice(img, (v, u), (PATCH, PATCH))

    return jax.vmap(slice_one)(v0, u0)


def orientations(patches: jnp.ndarray) -> jnp.ndarray:
    """ORB intensity-centroid angle per patch: θ = atan2(m01, m10) over a
    radius-15 disc. patches: (N, P, P) → (N,) radians."""
    w = patches * _DISC
    m10 = jnp.sum(w * _XREL, axis=(-1, -2))
    m01 = jnp.sum(w * _YREL, axis=(-1, -2))
    return jnp.arctan2(m01, m10)


# ---------------------------------------------------------------------------
# Matmul steering: orientation quantized into N_BINS; for each bin the
# rotated bilinear sampling of all 2×256 test points is folded into ONE
# constant (P², 256) matrix D_bin = W_q − W_p, so the whole descriptor stage
# is   bits = sign(patch_flat @ [D_0 | … | D_{B-1}])  — a single matmul —
# followed by a per-keypoint bin select. (ORB steers with 12° granularity;
# 24 bins = 15° is equivalent quality.)
# ---------------------------------------------------------------------------

N_BINS = 24


def _bilinear_weight_matrix(xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """(K,) patch-frame coords → (P*P, K) bilinear sampling matrix."""
    K = xs.shape[0]
    W = np.zeros((PATCH * PATCH, K), np.float32)
    px = np.clip(xs + _cx, 0.0, PATCH - 1.001)
    py = np.clip(ys + _cy, 0.0, PATCH - 1.001)
    x0 = np.floor(px).astype(np.int64)
    y0 = np.floor(py).astype(np.int64)
    dx = px - x0
    dy = py - y0
    for k in range(K):
        base = y0[k] * PATCH + x0[k]
        W[base, k] += (1 - dx[k]) * (1 - dy[k])
        W[base + 1, k] += dx[k] * (1 - dy[k])
        W[base + PATCH, k] += (1 - dx[k]) * dy[k]
        W[base + PATCH + 1, k] += dx[k] * dy[k]
    return W


def _make_steer_bank() -> np.ndarray:
    """(P*P, N_BINS*256) constant: column (b, t) computes I(q_t) − I(p_t)
    under rotation by bin-b angle."""
    pat = make_test_pattern()
    bank = np.zeros((PATCH * PATCH, N_BINS * DESC_BITS), np.float32)
    for b in range(N_BINS):
        th = 2.0 * np.pi * b / N_BINS
        c, s = np.cos(th), np.sin(th)
        rpx = c * pat[:, 0] - s * pat[:, 1]
        rpy = s * pat[:, 0] + c * pat[:, 1]
        rqx = c * pat[:, 2] - s * pat[:, 3]
        rqy = s * pat[:, 2] + c * pat[:, 3]
        Wp = _bilinear_weight_matrix(rpx, rpy)
        Wq = _bilinear_weight_matrix(rqx, rqy)
        bank[:, b * DESC_BITS:(b + 1) * DESC_BITS] = Wq - Wp
    return bank


# bf16 operands run at the matrix units' full rate; the descriptor is a sign test, so the
# ~3-decimal-digit mantissa is ample (bits near zero flip under noise anyway)
_STEER_BANK = _make_steer_bank()  # numpy (see note above)


def _make_moment_cols() -> np.ndarray:
    """(P*P, 2) columns computing the ORB intensity-centroid moments
    (m10, m01) over the radius-15 disc — appended to the descriptor bank so
    orientation falls out of the SAME matmul as the steering tests."""
    disc = _DISC
    return np.stack([(disc * _XREL_NP).reshape(-1),
                     (disc * _YREL_NP).reshape(-1)], axis=1).astype(np.float32)


def _blur_matrix(radius: int = 2) -> np.ndarray:
    """(P², P²) separable box-blur as a matrix over flattened patches, edge
    taps clamped. Left-multiplying the test bank by its transpose folds
    BRIEF's pre-smoothing INTO the constant bank, so the runtime pipeline
    needs no blurred image at all (blur ∘ sample is itself a linear
    functional of the raw patch)."""
    w = 2 * radius + 1
    B1 = np.zeros((PATCH, PATCH), np.float32)
    for i in range(PATCH):
        for d in range(-radius, radius + 1):
            B1[i, min(max(i + d, 0), PATCH - 1)] += 1.0 / w
    # separable: blur2d = B1_rows ⊗ B1_cols acting on vec(patch)
    return np.kron(B1, B1)


# ---------------------------------------------------------------------------
# LDB-style bank: multi-gridding cell-average intensity + gradient tests
# (reference: src/LDB/ldb.cpp — 2×2/3×3/4×4 griddings, per-cell mean
# intensity / dx / dy compared across cell pairs; 256-bit selection). Every
# LDB test is a *linear functional* of the patch, so the whole descriptor is
# one more constant bank for the same matmul — rotation handled by building
# the cell-membership masks in rotated coordinates per orientation bin.
# ---------------------------------------------------------------------------

LDB_RADIUS = 13.0  # cells live inside this disc (fits rotated in the patch)


def _ldb_cell_weights(grid: int, theta: float) -> np.ndarray:
    """(grid², P*P) normalized membership masks of a grid×grid tiling of the
    square [-r, r]², rotated by theta."""
    c, s = np.cos(theta), np.sin(theta)
    # patch pixel coords rotated back into the cell frame
    xr = c * _XREL_NP + s * _YREL_NP
    yr = -s * _XREL_NP + c * _YREL_NP
    r = LDB_RADIUS
    cell_w = 2 * r / grid
    ix = np.floor((xr + r) / cell_w).astype(np.int64)
    iy = np.floor((yr + r) / cell_w).astype(np.int64)
    inside = (xr >= -r) & (xr < r) & (yr >= -r) & (yr < r)
    W = np.zeros((grid * grid, PATCH * PATCH), np.float32)
    flat_cell = (iy * grid + ix).reshape(-1)
    flat_in = inside.reshape(-1)
    for pix in range(PATCH * PATCH):
        if flat_in[pix]:
            W[flat_cell[pix], pix] += 1.0
    W /= np.maximum(W.sum(axis=1, keepdims=True), 1.0)
    return W


def _shift_matrix(dx: int, dy: int) -> np.ndarray:
    """(P², P²) permutation-ish matrix: (S @ patch_flat)[y,x] = patch[y+dy, x+dx]."""
    S = np.zeros((PATCH * PATCH, PATCH * PATCH), np.float32)
    for y in range(PATCH):
        for x in range(PATCH):
            ys, xs = min(max(y + dy, 0), PATCH - 1), min(max(x + dx, 0), PATCH - 1)
            S[y * PATCH + x, ys * PATCH + xs] = 1.0
    return S


def _make_ldb_bank() -> np.ndarray:
    """(P*P, N_BINS*256): LDB tests per orientation bin. Test set: all cell
    pairs of the 2×2 and 3×3 griddings and a fixed subset of the 4×4
    gridding, with intensity/dx/dy channels interleaved, truncated to 256."""
    Sdx = _shift_matrix(1, 0) - _shift_matrix(-1, 0)
    Sdy = _shift_matrix(0, 1) - _shift_matrix(0, -1)
    bank = np.zeros((PATCH * PATCH, N_BINS * DESC_BITS), np.float32)
    rng = np.random.default_rng(5)
    for b in range(N_BINS):
        th = 2.0 * np.pi * b / N_BINS
        cols = []
        for grid in (2, 3, 4):
            W = _ldb_cell_weights(grid, th)           # (g², P²)
            n = W.shape[0]
            pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
            if grid == 4:
                sel = rng.permutation(len(pairs))[:44]
                pairs = [pairs[k] for k in sel]
            for (i, j) in pairs:
                d = W[i] - W[j]
                cols.append(d)                         # intensity
                cols.append(d @ Sdx * 0.5)             # mean dx
                cols.append(d @ Sdy * 0.5)             # mean dy
        cols = np.stack(cols[:DESC_BITS], axis=1)      # (P², 256)
        bank[:, b * DESC_BITS:(b + 1) * DESC_BITS] = cols
    return bank


_XREL_NP = _xx - _cx
_YREL_NP = _yy - _cy

_LDB_BANK = None  # built lazily (it is ~1s of numpy)


def _get_ldb_bank():
    global _LDB_BANK
    if _LDB_BANK is None:
        _LDB_BANK = _make_ldb_bank()  # cache numpy: safe under any trace
    return jnp.asarray(_LDB_BANK, dtype=jnp.bfloat16)


_FUSED_BANKS: dict = {}


def _get_fused_bank(kind: str) -> jnp.ndarray:
    """(P*P, N_BINS*256 + 2) bf16 constant: all steering bins' test columns
    followed by the two orientation-moment columns (m10, m01), so descriptor
    tests AND orientation come out of one matmul.

    The test columns are pre-composed with the box blur (see _blur_matrix),
    so callers pass RAW patches — no blurred image is ever built. The
    moment columns are NOT blurred (ORB computes moments on the raw image).

    Cached as NUMPY (a jnp array built under an enclosing trace would leak
    the tracer); jnp.asarray at the call site is a free constant fold."""
    if kind not in _FUSED_BANKS:
        bank = _make_steer_bank() if kind == "brief" else _make_ldb_bank()
        bank = _blur_matrix().T @ bank   # (blur ∘ test) as one constant
        _FUSED_BANKS[kind] = np.concatenate(
            [bank, _make_moment_cols()], axis=1)
    return jnp.asarray(_FUSED_BANKS[kind], dtype=jnp.bfloat16)


def describe_patches(patches: jnp.ndarray, kind: str = "brief"):
    """(N, P, P) RAW patches → (desc (N, 256) int8 ±1, angles (N,)).

    One matmul computes every orientation bin's 256 test responses plus
    the intensity-centroid moments; the per-keypoint bin is then selected
    with a one-hot contraction (no gather). BRIEF's
    pre-smoothing is pre-composed into the bank constant, so no blurred
    image is needed. Responses are sign tests, so the bf16 output precision
    is ample."""
    N = patches.shape[0]
    bank = _get_fused_bank(kind)
    flat = patches.reshape(N, PATCH * PATCH).astype(jnp.bfloat16)
    out = jnp.dot(flat, bank,
                  preferred_element_type=jnp.bfloat16)       # (N, B*256+2)
    m10 = out[:, -2].astype(jnp.float32)
    m01 = out[:, -1].astype(jnp.float32)
    ang = jnp.arctan2(m01, m10)
    tau = jnp.mod(ang, 2.0 * jnp.pi)
    bins = jnp.round(tau / (2.0 * jnp.pi / N_BINS)).astype(jnp.int32) % N_BINS
    diffs = out[:, :N_BINS * DESC_BITS].reshape(N, N_BINS, DESC_BITS)
    onehot = jax.nn.one_hot(bins, N_BINS, dtype=jnp.bfloat16)
    sel = jnp.einsum("nbd,nb->nd", diffs, onehot,
                     preferred_element_type=jnp.float32)
    return jnp.where(sel > 0, jnp.int8(1), jnp.int8(-1)), ang


def steered_brief(patches: jnp.ndarray, angles: jnp.ndarray,
                  kind: str = "brief") -> jnp.ndarray:
    """Compute 256-bit steered binary descriptors as ±1 int8 for externally
    supplied ``angles`` (the fused path in ``describe_patches`` derives the
    angle from the same matmul — prefer it; this entry point exists for
    callers steering by a known orientation)."""
    N = patches.shape[0]
    bank = (jnp.asarray(_STEER_BANK, dtype=jnp.bfloat16)
            if kind == "brief" else _get_ldb_bank())
    flat = patches.reshape(N, PATCH * PATCH).astype(jnp.bfloat16)
    diffs = jnp.dot(flat, bank,
                    preferred_element_type=jnp.bfloat16)      # (N, B*256)
    diffs = diffs.reshape(N, N_BINS, DESC_BITS)
    tau = jnp.mod(angles, 2.0 * jnp.pi)
    bins = jnp.round(tau / (2.0 * jnp.pi / N_BINS)).astype(jnp.int32) % N_BINS
    onehot = jax.nn.one_hot(bins, N_BINS, dtype=jnp.bfloat16)
    sel = jnp.einsum("nbd,nb->nd", diffs, onehot,
                     preferred_element_type=jnp.float32)
    return jnp.where(sel > 0, jnp.int8(1), jnp.int8(-1))


@functools.partial(jax.jit, static_argnames=("smooth_radius", "kind"))
def describe(img: jnp.ndarray, uv: jnp.ndarray, valid: jnp.ndarray,
             smooth_radius: int = 2, kind: str = "brief"):
    """Full descriptor stage: raw patches → fused orientation+BRIEF (the
    pre-smoothing lives inside the bank constant — ``smooth_radius`` kept
    for API compatibility, radius 2 is baked in).

    Returns (desc (N,256) int8 ±1, angles (N,) float32). Invalid keypoints
    get zero descriptors (so their dot products can never win a match).
    """
    patches = extract_patches(img, uv)
    desc, ang = describe_patches(patches, kind)
    desc = jnp.where(valid[:, None], desc, jnp.int8(0))
    return desc, ang


def pack_bits(desc_pm1: jnp.ndarray) -> jnp.ndarray:
    """±1 int8 (N,256) → packed uint32 (N,8) for compact storage/BoW."""
    bits = (desc_pm1 > 0).astype(jnp.uint32).reshape(desc_pm1.shape[0], 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(bits << shifts[None, None, :], axis=-1)
