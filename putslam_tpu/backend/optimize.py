"""Bundle adjustment: batched Gauss-Newton with Schur complement.

Batched replacement for the reference's g2o optimization pipeline
(reference: src/PoseGraph/graph_g2o.cpp:32-65 — LinearSolverPCG +
BlockSolverX + Gauss-Newton; ``optimize`` :873-933 with chi²-ratio
termination :888-908; first-vertex gauge fix :184-186; estimate copy-back
:936-997; robust kernels :367-383).

Design: all pose-landmark factors are evaluated in one batched pass
(analytic Jacobians), reduced into
  * per-keyframe 6×6 blocks (segment-sum → dense camera Hessian),
  * per-landmark 3×3 blocks (closed-form inverses, no LAPACK),
  * a dense (K·6, L·3) camera-landmark coupling matrix,
and the landmark block is eliminated by a Schur complement whose heavy
product is a single matmul:  S = H_cc − H_cl·blkdiag(H_ll⁻¹)·H_clᵀ.
The reduced camera system (≤ 1536²) is solved with dense Cholesky (exact
at this size, where the reference uses PCG). Landmarks back-substitute in
closed form.

State updates are pure: poses retract on the right, landmarks add; masks
keep fixed/invalid entries frozen. This one function is the whole
"optimization thread" of the reference (featuresMap.cpp:881-1026) — called
synchronously every N frames or at end, it is deterministic by construction.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from putslam_tpu.config import BackendConfig, CameraConfig
from putslam_tpu.backend import factors
from putslam_tpu.backend.graph import GraphState
from putslam_tpu.geometry import se3
from putslam_tpu.geometry.uncertainty import chol3x3, inv3x3


class BAResult(NamedTuple):
    kf_pose: jnp.ndarray    # (K, 7) optimized poses
    lm_pos: jnp.ndarray     # (L, 3) optimized landmarks
    chi2: jnp.ndarray       # (iters,) weighted squared error per iteration
    obs_sq_err: jnp.ndarray # (M,) final per-observation weighted sq. error


def _final_sq_errors(bcfg: BackendConfig, kf_pose, lm_pos, lm_valid,
                     g: GraphState, lm_gen=None, kf_gen=None,
                     cam: CameraConfig = None):
    """Per-observation weighted squared errors at a state — the prune
    signal, WITHOUT Jacobians (the full _assemble_obs costs ~0.5 ms per BA
    call at fr1 capacities just to throw the J's away; round-5 profiling)."""
    kf_p = kf_pose[g.obs_kf]
    lm_p = lm_pos[g.obs_lm]
    fu, fv = (cam.fu, cam.fv) if cam is not None else (525.0, 525.0)
    if bcfg.error_type == 0:
        r = factors.obs_residual(kf_p, lm_p, g.obs_xyz)
    else:
        r = factors.reproj_residual(kf_p, lm_p, g.obs_xyz, fu, fv)
    gate = g.obs_valid & lm_valid[g.obs_lm]
    if lm_gen is not None:
        gate = gate & (g.obs_gen == lm_gen[g.obs_lm])
    if kf_gen is not None:
        gate = gate & (g.obs_kfgen == kf_gen[g.obs_kf])
    if bcfg.use_obs_info and bcfg.error_type == 0:
        Lw = _whitening_chol(g, kf_pose.dtype)
        r = jnp.einsum("msr,ms->mr", Lw, r)
        w_info = gate.astype(kf_pose.dtype)
    elif bcfg.error_type == 1:
        w_info = gate.astype(kf_pose.dtype) / (bcfg.obs_pixel_sigma ** 2)
    else:
        w_info = g.obs_w * gate
    return w_info * jnp.sum(r * r, axis=-1)


def _assemble_obs(bcfg: BackendConfig, kf_pose, lm_pos, lm_valid, g: GraphState,
                  lm_gen=None, kf_gen=None, cam: CameraConfig = None):
    """Residuals/Jacobians/weights for all pose-landmark observations.

    ``lm_gen`` / ``kf_gen``: slot generations — observations whose stored
    generation does not match the referenced landmark/keyframe slot's current
    generation are stale (slot recycled since insertion) and get zero weight.

    Factor type dispatches on ``bcfg.error_type`` (0 → 3D Euclidean Edge3D,
    1 → 2D reprojection, the custom PUT g2o edge). With
    ``bcfg.use_obs_info`` the stored full 3×3 information matrices whiten
    the 3D residual/Jacobians (r' = Lᵀr with Info = L·Lᵀ), so anisotropic
    sensor noise (depthSensorModel.cpp:28-95) shapes the normal equations."""
    kf_p = kf_pose[g.obs_kf]
    lm_p = lm_pos[g.obs_lm]
    fu, fv = (cam.fu, cam.fv) if cam is not None else (525.0, 525.0)
    r, Jp, Jl = factors.assemble_obs_terms(kf_p, lm_p, g.obs_xyz,
                                           bcfg.error_type, fu, fv)
    gate = g.obs_valid & lm_valid[g.obs_lm]
    if lm_gen is not None:
        gate = gate & (g.obs_gen == lm_gen[g.obs_lm])
    if kf_gen is not None:
        gate = gate & (g.obs_kfgen == kf_gen[g.obs_kf])
    if bcfg.use_obs_info and bcfg.error_type == 0:
        Lw = _whitening_chol(g, kf_pose.dtype)                  # (M,3,3)
        r = jnp.einsum("msr,ms->mr", Lw, r)
        Jp = jnp.einsum("msr,msj->mrj", Lw, Jp)
        Jl = jnp.einsum("msr,msj->mrj", Lw, Jl)
        w_info = gate.astype(kf_pose.dtype)   # info folded into the whitening
    elif bcfg.error_type == 1:
        # reprojection residuals are in *pixels*: the stored obs_w carries
        # metres⁻² information and must not weight them — the pixel-noise
        # information 1/σ_px² does (edge_se3_pointxyz_reprojectionError.h)
        w_info = gate.astype(kf_pose.dtype) / (bcfg.obs_pixel_sigma ** 2)
    else:
        w_info = g.obs_w * gate
    sq = w_info * jnp.sum(r * r, axis=-1)
    w_rob = factors.robust_weight(sq, bcfg.robust_kernel,
                                  bcfg.robust_delta)
    w = w_info * w_rob
    return r, Jp, Jl, w, sq


def _whitening_chol(g: GraphState, dtype):
    """Per-observation whitening factor L with Info = L·Lᵀ. Observations
    stored without a full information matrix (obs_info all-zero — e.g. g2o
    imports or use_uncertainty=False producers) fall back to their scalar
    weight, √obs_w·I, instead of being silently annihilated by chol(0)."""
    tr = (g.obs_info[..., 0, 0] + g.obs_info[..., 1, 1]
          + g.obs_info[..., 2, 2])
    has_info = tr > 0.0
    scalar = jnp.sqrt(jnp.maximum(g.obs_w, 0.0))[:, None, None] \
        * jnp.eye(3, dtype=dtype)
    return jnp.where(has_info[:, None, None], chol3x3(g.obs_info), scalar)


def _pp_weights(bcfg: BackendConfig, g: GraphState, r6, kf_gen=None):
    """Per pose-pose edge (info weight, robust weight product, chi²-term) with
    stale-generation masking."""
    gate = g.pp_valid
    if kf_gen is not None:
        gate = gate & (g.pp_gen_i == kf_gen[g.pp_i]) \
            & (g.pp_gen_j == kf_gen[g.pp_j])
    wpp_info = g.pp_w * gate
    sq_pp = wpp_info * jnp.sum(r6 * r6, axis=-1)
    wpp = wpp_info * factors.robust_weight(sq_pp, bcfg.robust_kernel,
                                           bcfg.robust_delta)
    return wpp, sq_pp


@functools.partial(jax.jit, static_argnums=(0,), static_argnames=("cam",))
def gauss_newton_pcg(bcfg: BackendConfig,
                     kf_pose: jnp.ndarray, kf_valid: jnp.ndarray,
                     lm_pos: jnp.ndarray, lm_valid: jnp.ndarray,
                     g: GraphState,
                     fixed_kf: jnp.ndarray,
                     lm_gen: jnp.ndarray = None,
                     kf_gen: jnp.ndarray = None,
                     cam: CameraConfig = None) -> BAResult:
    """Matrix-free variant: the reduced camera system S·x = b is solved by
    block-Jacobi-preconditioned conjugate gradients, applying
    S v = H_cc v − H_cl (H_ll⁻¹ (H_lc v)) through per-observation 6×3
    products and segment sums — no (K·6, L·3) coupling matrix is ever
    materialized. This is the reference's LinearSolverPCG architecture
    (graph_g2o.cpp:35) rebuilt batched; use for maps too large for the
    dense Schur path."""
    K = kf_pose.shape[0]
    L = lm_pos.shape[0]
    lam = bcfg.damping

    def iteration(carry, _):
        kf_pose, lm_pos = carry
        r, Jp, Jl, w, sq = _assemble_obs(bcfg, kf_pose, lm_pos, lm_valid, g,
                                         lm_gen, kf_gen, cam)
        chi2 = jnp.sum(sq)

        B = jnp.einsum("m,mri,mrj->mij", w, Jp, Jl)             # (M,6,3)
        JpT_Jp = jnp.einsum("m,mri,mrj->mij", w, Jp, Jp)        # (M,6,6)
        JlT_Jl = jnp.einsum("m,mri,mrj->mij", w, Jl, Jl)        # (M,3,3)
        bp = -jnp.einsum("m,mri,mr->mi", w, Jp, r)
        bl = -jnp.einsum("m,mri,mr->mi", w, Jl, r)

        H_cc_diag = jnp.zeros((K, 6, 6), kf_pose.dtype).at[g.obs_kf].add(JpT_Jp)
        H_ll = jnp.zeros((L, 3, 3), kf_pose.dtype).at[g.obs_lm].add(JlT_Jl)
        b_c = jnp.zeros((K, 6), kf_pose.dtype).at[g.obs_kf].add(bp)
        b_l = jnp.zeros((L, 3), kf_pose.dtype).at[g.obs_lm].add(bl)

        # pose-pose edges: diagonal + off-diagonal kept per-edge for matvec
        pi = kf_pose[g.pp_i]
        pj = kf_pose[g.pp_j]
        r6 = factors.pp_residual(pi, pj, g.pp_rel)
        Ji, Jj = factors.pp_jacobians(pi, pj, g.pp_rel)
        wpp, sq_pp = _pp_weights(bcfg, g, r6, kf_gen)
        chi2 = chi2 + jnp.sum(sq_pp)
        Hii = jnp.einsum("e,eri,erj->eij", wpp, Ji, Ji)
        Hjj = jnp.einsum("e,eri,erj->eij", wpp, Jj, Jj)
        Hij = jnp.einsum("e,eri,erj->eij", wpp, Ji, Jj)
        H_cc_diag = H_cc_diag.at[g.pp_i].add(Hii).at[g.pp_j].add(Hjj)
        b_c = b_c.at[g.pp_i].add(-jnp.einsum("e,eri,er->ei", wpp, Ji, r6))
        b_c = b_c.at[g.pp_j].add(-jnp.einsum("e,eri,er->ei", wpp, Jj, r6))

        tr_ll = (H_ll[..., 0, 0] + H_ll[..., 1, 1] + H_ll[..., 2, 2]) / 3.0
        H_ll_inv = inv3x3(H_ll + (lam * (1.0 + tr_ll))[:, None, None]
                          * jnp.eye(3, dtype=kf_pose.dtype))

        frozen = fixed_kf | ~kf_valid
        diag_scale = jnp.maximum(
            jnp.max(jnp.abs(jnp.einsum("kii->k", H_cc_diag))), 1.0) / 6.0

        def S_matvec(v):                                        # v: (K, 6)
            v = jnp.where(frozen[:, None], 0.0, v)
            u = jnp.einsum("kij,kj->ki", H_cc_diag, v)
            # pp off-diagonal blocks
            u = u.at[g.pp_i].add(jnp.einsum("eij,ej->ei", Hij, v[g.pp_j]))
            u = u.at[g.pp_j].add(jnp.einsum("eji,ej->ei", Hij, v[g.pp_i]))
            # − H_cl H_ll⁻¹ H_lc v via per-observation products
            a = jnp.einsum("mij,mi->mj", B, v[g.obs_kf])        # (M,3)
            t1 = jnp.zeros((L, 3), v.dtype).at[g.obs_lm].add(a)
            t2 = jnp.einsum("lab,lb->la", H_ll_inv, t1)
            c = jnp.einsum("mij,mj->mi", B, t2[g.obs_lm])       # (M,6)
            u = u - jnp.zeros((K, 6), v.dtype).at[g.obs_kf].add(c)
            u = u + (lam * diag_scale) * v
            return jnp.where(frozen[:, None], v, u)

        # block-Jacobi preconditioner from H_cc diagonal blocks
        eye6 = jnp.eye(6, dtype=kf_pose.dtype)
        M_blocks = H_cc_diag + (lam * diag_scale + 1e-6) * eye6
        M_inv = jnp.linalg.inv(M_blocks)                        # (K,6,6)

        def M_solve(v):
            out = jnp.einsum("kij,kj->ki", M_inv, v)
            return jnp.where(frozen[:, None], v, out)

        b_vec = jnp.where(frozen[:, None], 0.0, b_c)

        def pcg_step(carry, _):
            x, rr, p, rz = carry
            Sp = S_matvec(p)
            denom = jnp.sum(p * Sp)
            alpha = jnp.where(jnp.abs(denom) > 1e-20, rz / denom, 0.0)
            x = x + alpha * p
            rr = rr - alpha * Sp
            z = M_solve(rr)
            rz_new = jnp.sum(rr * z)
            beta = jnp.where(jnp.abs(rz) > 1e-20, rz_new / rz, 0.0)
            p = z + beta * p
            return (x, rr, p, rz_new), rz_new

        x0 = jnp.zeros_like(b_vec)
        z0 = M_solve(b_vec)
        (dc_mat, _, _, _), _ = jax.lax.scan(
            pcg_step, (x0, b_vec, z0, jnp.sum(b_vec * z0)), None,
            length=bcfg.pcg_iterations)
        dc = dc_mat.reshape(K * 6)
        dc = jnp.where(jnp.isfinite(dc), dc, 0.0)
        dc = jnp.where(jnp.all(jnp.abs(dc) < 1e3), dc, 0.0)
        dc_mat = dc.reshape(K, 6)

        # landmark back-substitution via per-observation products
        a = jnp.einsum("mij,mi->mj", B, dc_mat[g.obs_kf])
        Hlc_dc = jnp.zeros((L, 3), kf_pose.dtype).at[g.obs_lm].add(a)
        dl = jnp.einsum("lab,lb->la", H_ll_inv, b_l - Hlc_dc)
        dl = jnp.where(jnp.isfinite(dl), dl, 0.0)

        new_pose = se3.retract(kf_pose, dc_mat)
        new_pose = jnp.where(frozen[:, None], kf_pose, new_pose)
        moved = lm_valid & (jnp.abs(dl).max(axis=-1) < 1e3)
        new_lm = jnp.where(moved[:, None], lm_pos + dl, lm_pos)
        return (new_pose, new_lm), chi2

    (kf_out, lm_out), chi2s = jax.lax.scan(
        iteration, (kf_pose, lm_pos), None, length=bcfg.gn_iterations)
    sq_final = _final_sq_errors(bcfg, kf_out, lm_out, lm_valid, g,
                                lm_gen, kf_gen, cam)
    return BAResult(kf_out, lm_out, chi2s, sq_final)


@functools.partial(jax.jit, static_argnums=(0,), static_argnames=("cam",))
def gauss_newton(bcfg: BackendConfig,
                 kf_pose: jnp.ndarray, kf_valid: jnp.ndarray,
                 lm_pos: jnp.ndarray, lm_valid: jnp.ndarray,
                 g: GraphState,
                 fixed_kf: jnp.ndarray,
                 lm_gen: jnp.ndarray = None,
                 kf_gen: jnp.ndarray = None,
                 cam: CameraConfig = None) -> BAResult:
    """Run ``bcfg.gn_iterations`` Gauss-Newton steps. ``fixed_kf``: (K,) bool
    gauge/window fixing (first pose always fixed by the caller); ``lm_gen`` /
    ``kf_gen``: optional slot generations for stale-edge masking; ``cam``:
    intrinsics for the reprojection factor (error_type=1)."""
    K = kf_pose.shape[0]
    L = lm_pos.shape[0]
    lam = bcfg.damping

    def iteration(carry, _):
        kf_pose, lm_pos = carry
        r, Jp, Jl, w, sq = _assemble_obs(bcfg, kf_pose, lm_pos, lm_valid, g,
                                         lm_gen, kf_gen, cam)
        chi2 = jnp.sum(sq)

        # --- per-keyframe and per-landmark blocks (segment sums) ----------
        JpT_Jp = jnp.einsum("m,mri,mrj->mij", w, Jp, Jp)        # (M,6,6)
        JlT_Jl = jnp.einsum("m,mri,mrj->mij", w, Jl, Jl)        # (M,3,3)
        JpT_Jl = jnp.einsum("m,mri,mrj->mij", w, Jp, Jl)        # (M,6,3)
        bp = -jnp.einsum("m,mri,mr->mi", w, Jp, r)              # (M,6)
        bl = -jnp.einsum("m,mri,mr->mi", w, Jl, r)              # (M,3)

        H_cc = jnp.zeros((K, K, 6, 6), kf_pose.dtype)
        H_cc = H_cc.at[g.obs_kf, g.obs_kf].add(JpT_Jp)
        H_ll = jnp.zeros((L, 3, 3), kf_pose.dtype).at[g.obs_lm].add(JlT_Jl)
        H_cl = jnp.zeros((K, L, 6, 3), kf_pose.dtype)
        H_cl = H_cl.at[g.obs_kf, g.obs_lm].add(JpT_Jl)
        b_c = jnp.zeros((K, 6), kf_pose.dtype).at[g.obs_kf].add(bp)
        b_l = jnp.zeros((L, 3), kf_pose.dtype).at[g.obs_lm].add(bl)

        # --- pose-pose edges ---------------------------------------------
        pi = kf_pose[g.pp_i]
        pj = kf_pose[g.pp_j]
        r6 = factors.pp_residual(pi, pj, g.pp_rel)              # (E,6)
        Ji, Jj = factors.pp_jacobians(pi, pj, g.pp_rel)         # (E,6,6)
        wpp, sq_pp = _pp_weights(bcfg, g, r6, kf_gen)
        chi2 = chi2 + jnp.sum(sq_pp)
        H_cc = H_cc.at[g.pp_i, g.pp_i].add(jnp.einsum("e,eri,erj->eij", wpp, Ji, Ji))
        H_cc = H_cc.at[g.pp_j, g.pp_j].add(jnp.einsum("e,eri,erj->eij", wpp, Jj, Jj))
        H_cc = H_cc.at[g.pp_i, g.pp_j].add(jnp.einsum("e,eri,erj->eij", wpp, Ji, Jj))
        H_cc = H_cc.at[g.pp_j, g.pp_i].add(jnp.einsum("e,eri,erj->eij", wpp, Jj, Ji))
        b_c = b_c.at[g.pp_i].add(-jnp.einsum("e,eri,er->ei", wpp, Ji, r6))
        b_c = b_c.at[g.pp_j].add(-jnp.einsum("e,eri,er->ei", wpp, Jj, r6))

        # --- Schur complement over landmarks ------------------------------
        # relative + absolute damping (float32 assembly noise is ~1e-5 of
        # the diagonal scale; absolute λ alone can leave S indefinite)
        tr_ll = (H_ll[..., 0, 0] + H_ll[..., 1, 1] + H_ll[..., 2, 2]) / 3.0
        lam_ll = lam * (1.0 + tr_ll)
        H_ll_damped = H_ll + lam_ll[:, None, None] * jnp.eye(3, dtype=kf_pose.dtype)
        H_ll_inv = inv3x3(H_ll_damped)                          # (L,3,3)

        Hcl = H_cl.transpose(0, 2, 1, 3).reshape(K * 6, L * 3)
        # blkdiag(H_ll⁻¹) applied on the right: (K6, L, 3) × (L, 3, 3)
        HclWinv = jnp.einsum("kla,lab->klb",
                             Hcl.reshape(K * 6, L, 3), H_ll_inv)
        S = (H_cc.transpose(0, 2, 1, 3).reshape(K * 6, K * 6)
             - jnp.dot(HclWinv.reshape(K * 6, L * 3), Hcl.T,
                       preferred_element_type=jnp.float32))
        Winv_bl = jnp.einsum("lab,lb->la", H_ll_inv, b_l)       # (L,3)
        b_red = b_c.reshape(K * 6) - jnp.dot(Hcl, Winv_bl.reshape(L * 3))

        # --- gauge fixing + invalid keyframes -----------------------------
        frozen = (fixed_kf | ~kf_valid)                         # (K,)
        frozen6 = jnp.repeat(frozen, 6)
        S = jnp.where(frozen6[:, None] | frozen6[None, :], 0.0, S)
        S = S + jnp.diag(frozen6.astype(S.dtype))
        S = 0.5 * (S + S.T)                                     # exact symmetry
        max_diag = jnp.maximum(jnp.max(jnp.abs(jnp.diagonal(S))), 1.0)
        S = S + (lam * max_diag) * jnp.eye(K * 6, dtype=S.dtype)
        b_red = jnp.where(frozen6, 0.0, b_red)

        # --- solve + back-substitute --------------------------------------
        dc = jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(S, lower=True), b_red)  # (K6,)
        # robustness guard (g2o-style): a failed factorization or a blown-up
        # step must never poison the state — skip the update instead
        dc = jnp.where(jnp.isfinite(dc), dc, 0.0)
        step_ok = jnp.all(jnp.abs(dc) < 1e3)
        dc = jnp.where(step_ok, dc, 0.0)
        # δl = H_ll⁻¹ (b_l − H_lc δc)
        Hlc_dc = jnp.einsum("kla,k->la",
                            Hcl.reshape(K * 6, L, 3), dc)        # (L,3)
        dl = jnp.einsum("lab,lb->la", H_ll_inv, b_l - Hlc_dc)

        dl = jnp.where(jnp.isfinite(dl), dl, 0.0)
        new_pose = se3.retract(kf_pose, dc.reshape(K, 6))
        new_pose = jnp.where(frozen[:, None], kf_pose, new_pose)
        moved = lm_valid & (jnp.abs(dl).max(axis=-1) < 1e3)     # blowup guard
        new_lm = jnp.where(moved[:, None], lm_pos + dl, lm_pos)
        return (new_pose, new_lm), chi2

    (kf_out, lm_out), chi2s = jax.lax.scan(
        iteration, (kf_pose, lm_pos), None, length=bcfg.gn_iterations)
    sq_final = _final_sq_errors(bcfg, kf_out, lm_out, lm_valid, g,
                                lm_gen, kf_gen, cam)
    return BAResult(kf_out, lm_out, chi2s, sq_final)


def schur_subtrahend_mm(obs_kf, obs_lm, F, K: int, L: int):
    """The Schur subtrahend ``S_sub = H_cl·H_ll⁻¹·H_clᵀ`` (K·6, K·6) built
    entirely with matmuls from the *whitened* per-observation coupling
    F = (w·JpᵀJl)·chol(H_ll⁻¹) — never scattering into a (K, L, 6, 3)
    buffer (that scatter is XLA-serialized at runtime and a compile-time
    bomb at fr1 capacities). Two products:

        G[a, 6k+i, l] = Σ_m P[m,k]·F[m,i,a]·Q[m,l]   (one-hot expansion)
        S_sub         = Σ_a G_a·G_aᵀ                  (batched over a)

    Both products run on bf16 operands with f32 accumulation, each f32
    operand split into a bf16 head and tail (x = hi + lo, ~16 significant
    bits): G from two passes (the one-hot factors are exact in bf16),
    G·Gᵀ from three (hi·hi + hi·lo + lo·hi). One bf16 pass is not enough:
    S = H_cc − S_sub cancels in the weakly constrained directions of a
    long keyframe chain, and the ~0.4 % error of bf16 entries stalls or
    reverses the step there (the scatter oracle in f32 converges)."""
    M = F.shape[0]
    Pb = jax.nn.one_hot(obs_kf, K, dtype=jnp.bfloat16)          # (M, K)
    Qb = jax.nn.one_hot(obs_lm, L, dtype=jnp.bfloat16)          # (M, L)
    Fp = jnp.swapaxes(F, 1, 2)                                  # (M, 3, 6)

    def expand(f):                                              # (18K, L)
        A = (Pb[:, None, :] * f.reshape(M, 18, 1)).reshape(M, 18 * K)
        return jax.lax.dot_general(
            A, Qb, dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)

    def outer(a, b):                                            # (3, 6K, 6K)
        return jax.lax.dot_general(
            a, b, dimension_numbers=(((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.float32)

    f_hi, f_lo = _split_bf16(Fp)
    Gp = expand(f_hi) + expand(f_lo)
    g_hi, g_lo = _split_bf16(Gp.reshape(3, 6 * K, L))
    Sik = outer(g_hi, g_hi) + outer(g_hi, g_lo) + outer(g_lo, g_hi)
    S_ik = jnp.sum(Sik, axis=0)
    return S_ik.reshape(6, K, 6, K).transpose(1, 0, 3, 2).reshape(K * 6, K * 6)


def _split_bf16(x):
    """f32 ``x`` as bf16 ``(hi, lo)`` with ``hi + lo ≈ x`` to ~16 bits.

    The head is rounded with ``reduce_precision``: XLA may drop an
    f32 → bf16 → f32 round trip as excess precision (the GPU compiler
    does), which would leave ``lo`` zero and the split a single pass."""
    hi = jax.lax.reduce_precision(x, exponent_bits=8, mantissa_bits=7)
    return hi.astype(jnp.bfloat16), (x - hi).astype(jnp.bfloat16)


@functools.partial(jax.jit, static_argnums=(0,), static_argnames=("cam",))
def gauss_newton_mm(bcfg: BackendConfig,
                    kf_pose: jnp.ndarray, kf_valid: jnp.ndarray,
                    lm_pos: jnp.ndarray, lm_valid: jnp.ndarray,
                    g: GraphState,
                    fixed_kf: jnp.ndarray,
                    lm_gen: jnp.ndarray = None,
                    kf_gen: jnp.ndarray = None,
                    cam: CameraConfig = None) -> BAResult:
    """Dense Schur rebuilt from matmuls: the camera-landmark coupling is
    never scattered into a (K, L, 6, 3) buffer (XLA lowers that scatter
    to a serialized update stream — the single most expensive op of the
    scatter-based path, and a compile-time bomb at fr1 capacities).
    Instead the *whitened* coupling

        G[k·6+i, l·3+a] = Σ_{m: kf=k, lm=l}  (w·JpᵀJl · chol(H_ll⁻¹))[i,a]

    is built by one one-hot matmul — A = P ⊙ F row-expanded (M, 18K),
    G' = Aᵀ·Q with P/Q the keyframe/landmark one-hot operators — and the
    Schur subtrahend is a single product S_sub = G·Gᵀ.

    Precision contract: S (curvature) is accumulated in float32 from
    split-bf16 operands (~16 significant bits, see schur_subtrahend_mm).
    The gradient b is computed exactly in float32 through per-observation
    products and HIGHEST-precision one-hot sums, so the Gauss-Newton fixed
    point (b → 0) is unchanged; the curvature's rounding only perturbs the
    step direction, an inexact-Newton step the damping absorbs.
    """
    K = kf_pose.shape[0]
    L = lm_pos.shape[0]
    M = g.obs_kf.shape[0]
    lam = bcfg.damping
    f32 = kf_pose.dtype
    fu, fv = (cam.fu, cam.fv) if cam is not None else (525.0, 525.0)

    # --- active-window compaction (static): gather the ≤W free keyframes
    # into a compact block so every camera-side product and the Cholesky run
    # at (6·W)² instead of (6·K)². Frozen keyframes' observations still
    # flow into H_ll / b_l (landmark anchoring — the window's gauge), and
    # their rows of the camera system never existed to begin with (the
    # full-K path built them and then masked them to identity).
    # The reference optimizes the active subgraph the same way: everything
    # outside the marginalization window is a fixed vertex
    # (graph_g2o.cpp:873-933, featuresMap.cpp:1043-1104).
    windowed = 0 < bcfg.ba_window < K
    KC = bcfg.ba_window if windowed else K                      # compact dim
    frozen_full = fixed_kf | ~kf_valid                          # (K,)
    if windowed:
        free = ~frozen_full
        sel = jnp.nonzero(free, size=KC, fill_value=K)[0]       # (KC,)
        comp_of = jnp.full((K + 1,), KC, jnp.int32).at[sel].set(
            jnp.arange(KC, dtype=jnp.int32))[:K]                # (K,) → [0,KC]
        ck_obs = comp_of[g.obs_kf]                              # KC = dropped
        cpp_i = comp_of[g.pp_i]
        cpp_j = comp_of[g.pp_j]
        # compact slots left unpaired (fewer free keyframes than W)
        dead_c = sel >= K                                       # (KC,)
    else:
        sel = jnp.arange(K, dtype=jnp.int32)
        ck_obs = g.obs_kf
        cpp_i = g.pp_i
        cpp_j = g.pp_j
        dead_c = frozen_full

    # compact-side one-hot segment-sum operator: loop-invariant, built once;
    # the sentinel column KC (dropped/frozen rows) is sliced away so those
    # observations contribute nothing to the camera system
    Pf = jax.nn.one_hot(ck_obs, KC + 1, dtype=f32)[:, :KC]      # (M, KC)
    # full-K one-hot for per-observation keyframe-pose reads: an (M, K)·
    # (K, ·) matmul replaces the M-row gather (exact: rows have a single 1)
    P_full = jax.nn.one_hot(g.obs_kf, K, dtype=f32)             # (M, K)

    # --- landmark-axis compaction (static): the ≤ LC valid landmarks get
    # compact slots; every obs↔landmark gather/scatter in the iteration
    # becomes a one-hot f32 matmul ------------------------------------------
    lm_blocked = 0 < bcfg.ba_lm_block < L
    LC = bcfg.ba_lm_block if lm_blocked else L
    if lm_blocked:
        sel_lm = jnp.nonzero(lm_valid, size=LC, fill_value=L)[0]  # (LC,)
        comp_lm = jnp.full((L + 1,), LC, jnp.int32).at[sel_lm].set(
            jnp.arange(LC, dtype=jnp.int32))[:L]
        cl_obs = comp_lm[g.obs_lm]                              # LC = dropped
        lm_dead_c = sel_lm >= L                                 # (LC,)
        lm_ok_obs = cl_obs < LC        # ≡ lm_valid[g.obs_lm] by construction
    else:
        sel_lm = jnp.arange(L, dtype=jnp.int32)
        cl_obs = g.obs_lm
        lm_dead_c = ~lm_valid
        lm_ok_obs = lm_valid[g.obs_lm]
    Qf = jax.nn.one_hot(cl_obs, LC + 1, dtype=f32)[:, :LC]      # (M, LC)

    # Every f32 one-hot product below stands in for an exact gather or
    # segment sum, so each pins Precision.HIGHEST: at DEFAULT a GPU may run
    # an f32 dot in TF32 (~10 mantissa bits), which would round the landmark
    # positions read into every residual, the gradient b, and the generation
    # counters the stale-edge gates compare with ==.
    hi = jax.lax.Precision.HIGHEST

    def _obs_from_lm(x_c):
        """(LC, d) compact landmark values → (M, d) per-observation rows
        (zero for dropped landmarks) via one one-hot product."""
        return jax.lax.dot_general(
            Qf, x_c.reshape(LC, -1),
            dimension_numbers=(((1,), (0,)), ((), ())), precision=hi)

    def _lm_from_obs(x_m):
        """(M, d) per-observation values → (LC, d) segment sums."""
        return jax.lax.dot_general(
            Qf, x_m, dimension_numbers=(((0,), (0,)), ((), ())),
            precision=hi)

    gate = g.obs_valid & lm_ok_obs
    if lm_gen is not None:
        lm_gen_c = lm_gen[sel_lm].astype(f32)                   # (LC,)
        gen_at_obs = _obs_from_lm(lm_gen_c)[:, 0]
        gate = gate & (gen_at_obs == g.obs_gen.astype(f32))
    if kf_gen is not None:
        kfgen_at_obs = jax.lax.dot_general(
            P_full, kf_gen.astype(f32)[:, None],
            dimension_numbers=(((1,), (0,)), ((), ())), precision=hi)[:, 0]
        gate = gate & (kfgen_at_obs == g.obs_kfgen.astype(f32))

    pp_gate = g.pp_valid
    if kf_gen is not None:
        pp_gate = pp_gate & (g.pp_gen_i == kf_gen[g.pp_i]) \
            & (g.pp_gen_j == kf_gen[g.pp_j])

    if bcfg.use_obs_info and bcfg.error_type == 0:
        Lw = _whitening_chol(g, f32)                            # (M, 3, 3)

    def do_iteration(carry):
        kf_pose, lm_pos_c = carry
        kf_p = jax.lax.dot_general(                             # (M, 7)
            P_full, kf_pose, dimension_numbers=(((1,), (0,)), ((), ())),
            precision=hi)
        lm_p = _obs_from_lm(lm_pos_c)                           # (M, 3)
        r, Jp, Jl = factors.assemble_obs_terms(kf_p, lm_p, g.obs_xyz,
                                               bcfg.error_type, fu, fv)
        if bcfg.use_obs_info and bcfg.error_type == 0:
            r = jnp.einsum("msr,ms->mr", Lw, r)
            Jp = jnp.einsum("msr,msj->mrj", Lw, Jp)
            Jl = jnp.einsum("msr,msj->mrj", Lw, Jl)
            w_info = gate.astype(f32)
        elif bcfg.error_type == 1:
            w_info = gate.astype(f32) / (bcfg.obs_pixel_sigma ** 2)
        else:
            w_info = g.obs_w * gate
        sq = w_info * jnp.sum(r * r, axis=-1)
        w = w_info * factors.robust_weight(sq, bcfg.robust_kernel,
                                           bcfg.robust_delta)
        chi2 = jnp.sum(sq)

        # --- per-observation blocks -------------------------------------
        C = jnp.einsum("m,mri,mra->mia", w, Jp, Jl)             # (M, 6, 3)
        JpT_Jp = jnp.einsum("m,mri,mrj->mij", w, Jp, Jp)        # (M, 6, 6)
        JlT_Jl = jnp.einsum("m,mri,mrj->mij", w, Jl, Jl)        # (M, 3, 3)
        bp = -jnp.einsum("m,mri,mr->mi", w, Jp, r)              # (M, 6)
        bl = -jnp.einsum("m,mri,mr->mi", w, Jl, r)              # (M, 3)

        # camera-side segment sums as one (KC, M)×(M, 42) matmul (exact:
        # one-hot rows have a single 1.0)
        k_pack = jnp.concatenate([JpT_Jp.reshape(M, 36), bp], axis=1)
        k_sums = jax.lax.dot_general(
            Pf, k_pack, dimension_numbers=(((0,), (0,)), ((), ())),
            precision=hi)                                       # (KC, 42)
        H_cc_diag = k_sums[:, :36].reshape(KC, 6, 6)
        b_c = k_sums[:, 36:42]
        # L-side segment sums as one (LC, M)×(M, 12) matmul (exact one-hot)
        l_pack = jnp.concatenate([JlT_Jl.reshape(M, 9), bl], axis=1)
        l_sums = _lm_from_obs(l_pack)                           # (LC, 12)
        H_ll = l_sums[:, :9].reshape(LC, 3, 3)
        b_l = l_sums[:, 9:12]

        # --- pose-pose edges (E is small; scatter into a compact
        # (KC+1,KC+1,6,6) buffer — the sentinel row/col KC swallows frozen
        # endpoints and is sliced away; a frozen endpoint still pushes its
        # gradient/curvature into the *free* endpoint's block, i.e. the
        # edge acts as a prior anchored at the frozen pose) ----------------
        pi = kf_pose[g.pp_i]
        pj = kf_pose[g.pp_j]
        r6 = factors.pp_residual(pi, pj, g.pp_rel)
        Ji, Jj = factors.pp_jacobians(pi, pj, g.pp_rel)
        wpp_info = g.pp_w * pp_gate
        sq_pp = wpp_info * jnp.sum(r6 * r6, axis=-1)
        wpp = wpp_info * factors.robust_weight(sq_pp, bcfg.robust_kernel,
                                               bcfg.robust_delta)
        chi2 = chi2 + jnp.sum(sq_pp)
        H_cc = jnp.zeros((KC + 1, KC + 1, 6, 6), f32)
        H_cc = H_cc.at[jnp.arange(KC), jnp.arange(KC)].add(H_cc_diag)
        H_cc = H_cc.at[cpp_i, cpp_i].add(jnp.einsum("e,eri,erj->eij", wpp, Ji, Ji))
        H_cc = H_cc.at[cpp_j, cpp_j].add(jnp.einsum("e,eri,erj->eij", wpp, Jj, Jj))
        H_cc = H_cc.at[cpp_i, cpp_j].add(jnp.einsum("e,eri,erj->eij", wpp, Ji, Jj))
        H_cc = H_cc.at[cpp_j, cpp_i].add(jnp.einsum("e,eri,erj->eij", wpp, Jj, Ji))
        H_cc = H_cc[:KC, :KC]
        b_cp = jnp.zeros((KC + 1, 6), f32)
        b_cp = b_cp.at[cpp_i].add(-jnp.einsum("e,eri,er->ei", wpp, Ji, r6))
        b_cp = b_cp.at[cpp_j].add(-jnp.einsum("e,eri,er->ei", wpp, Jj, r6))
        b_c = b_c + b_cp[:KC]

        # --- landmark elimination (compact axis) -------------------------
        tr_ll = (H_ll[..., 0, 0] + H_ll[..., 1, 1] + H_ll[..., 2, 2]) / 3.0
        H_ll_inv = inv3x3(H_ll + (lam * (1.0 + tr_ll))[:, None, None]
                          * jnp.eye(3, dtype=f32))
        Linv = chol3x3(H_ll_inv)                                # (LC, 3, 3)

        # whitened coupling F = C · Linv[lm]  (so G·Gᵀ = H_cl·H_ll⁻¹·H_clᵀ)
        # — frozen observations carry sentinel index KC, whose one-hot row
        # is all-zero, so they drop out of the camera-side coupling while
        # still having fed H_ll / b_l above (landmark anchoring)
        Linv_m = _obs_from_lm(Linv.reshape(LC, 9)).reshape(M, 3, 3)
        F = jnp.einsum("mia,mab->mib", C, Linv_m)               # (M, 6, 3)
        S_sub = schur_subtrahend_mm(ck_obs, cl_obs, F, KC, LC)
        S = H_cc.transpose(0, 2, 1, 3).reshape(KC * 6, KC * 6) - S_sub

        # exact f32 gradient of the reduced system
        t = jnp.einsum("lab,lb->la", H_ll_inv, b_l)             # (LC, 3)
        c_m = jnp.einsum("mia,ma->mi", C, _obs_from_lm(t))      # (M, 6)
        b_red = (b_c - jax.lax.dot_general(
            Pf, c_m, dimension_numbers=(((0,), (0,)), ((), ())),
            precision=hi)).reshape(KC * 6)

        # --- gauge fixing + solve (same robustness contract as the
        # scatter path). dead_c: unpaired compact slots (windowed) or
        # frozen/invalid keyframes (full-K) — identity rows. ---------------
        frozen6 = jnp.repeat(dead_c, 6)
        S = jnp.where(frozen6[:, None] | frozen6[None, :], 0.0, S)
        S = S + jnp.diag(frozen6.astype(S.dtype))
        S = 0.5 * (S + S.T)
        max_diag = jnp.maximum(jnp.max(jnp.abs(jnp.diagonal(S))), 1.0)
        S = S + (lam * max_diag) * jnp.eye(KC * 6, dtype=S.dtype)
        b_red = jnp.where(frozen6, 0.0, b_red)
        dc = jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(S, lower=True), b_red)
        dc = jnp.where(jnp.isfinite(dc), dc, 0.0)
        dc = jnp.where(jnp.all(jnp.abs(dc) < 1e3), dc, 0.0)
        dc_mat = dc.reshape(KC, 6)

        # scatter the compact step back onto the full keyframe axis (frozen
        # rows read zero — their poses stay put by construction)
        if windowed:
            dc_full = jnp.zeros((K + 1, 6), f32).at[sel].set(dc_mat)[:K]
        else:
            dc_full = dc_mat

        # --- landmark back-substitution: δl = H_ll⁻¹ (b_l − H_lc δc) ------
        # per-observation camera step through the *compact* one-hot (frozen
        # observations read a zero step, exactly as before)
        dc_obs = jax.lax.dot_general(
            Pf, dc_mat, dimension_numbers=(((1,), (0,)), ((), ())),
            precision=hi)                                       # (M, 6)
        u_m = jnp.einsum("mia,mi->ma", C, dc_obs)               # (M, 3)
        Hlc_dc = _lm_from_obs(u_m)                              # (LC, 3)
        dl = jnp.einsum("lab,lb->la", H_ll_inv, b_l - Hlc_dc)
        dl = jnp.where(jnp.isfinite(dl), dl, 0.0)

        new_pose = se3.retract(kf_pose, dc_full)
        new_pose = jnp.where(frozen_full[:, None], kf_pose, new_pose)
        moved = ~lm_dead_c & (jnp.abs(dl).max(axis=-1) < 1e3)
        new_lm_c = jnp.where(moved[:, None], lm_pos_c + dl, lm_pos_c)
        return (new_pose, new_lm_c), chi2

    # chi²-ratio convergence (graph_g2o.cpp:888-908): once an iteration
    # fails to improve chi² by the configured ratio, the remaining scan
    # steps take the skip branch of the cond — essentially free at runtime,
    # so steady-state BA calls pay for only the 1-2 iterations they need.
    def iteration(carry, _):
        kf_pose, lm_pos_c, prev_chi2, done = carry
        (new_pose, new_lm_c), chi2 = jax.lax.cond(
            done,
            lambda c: (c, prev_chi2),
            do_iteration,
            (kf_pose, lm_pos_c))
        done = done | (chi2 >= bcfg.chi2_ratio_termination * prev_chi2)
        return (new_pose, new_lm_c, chi2, done), chi2

    lm_pos_c0 = lm_pos[jnp.clip(sel_lm, 0, L - 1)]              # (LC, 3)
    (kf_out, lm_out_c, _, _), chi2s = jax.lax.scan(
        iteration, (kf_pose, lm_pos_c0, jnp.float32(jnp.inf),
                    jnp.asarray(False)),
        None, length=bcfg.gn_iterations)
    # scatter the compact landmark block back (sentinel rows drop OOB)
    lm_out = lm_pos.at[jnp.where(lm_dead_c, L, sel_lm)].set(lm_out_c)
    sq_final = _final_sq_errors(bcfg, kf_out, lm_out, lm_valid, g,
                                lm_gen, kf_gen, cam)
    return BAResult(kf_out, lm_out, chi2s, sq_final)


def optimize_graph(bcfg: BackendConfig, kf_pose, kf_valid, lm_pos, lm_valid,
                   g: GraphState, fixed_kf, lm_gen=None, kf_gen=None,
                   cam: CameraConfig = None) -> BAResult:
    """Solver front door: dispatches on bcfg.solver
    ("dense_schur_mm" | "dense_schur" | "pcg")."""
    fn = {"dense_schur": gauss_newton,
          "dense_schur_mm": gauss_newton_mm,
          "pcg": gauss_newton_pcg}[bcfg.solver]
    return fn(bcfg, kf_pose, kf_valid, lm_pos, lm_valid, g, fixed_kf, lm_gen,
              kf_gen, cam=cam)


def prune_mask_from_errors(bcfg: BackendConfig, sq_err: jnp.ndarray,
                           threshold: float) -> jnp.ndarray:
    """Edges whose weighted squared error exceeds ``threshold`` — the chi²
    edge pruning of optimizeAndPrune (graph_g2o.cpp:1394-1505)."""
    return sq_err > threshold


@functools.partial(jax.jit, static_argnums=(0,), static_argnames=("cam",))
def pose_covariances(bcfg: BackendConfig,
                     kf_pose: jnp.ndarray, kf_valid: jnp.ndarray,
                     lm_pos: jnp.ndarray, lm_valid: jnp.ndarray,
                     g: GraphState, fixed_kf: jnp.ndarray,
                     lm_gen: jnp.ndarray = None,
                     kf_gen: jnp.ndarray = None,
                     cam: CameraConfig = None) -> jnp.ndarray:
    """Marginal 6×6 pose covariances from the reduced camera system:
    diag blocks of S⁻¹ at the current estimate (the reference extracts the
    same from g2o's Hessian, graph_g2o.cpp:1324-1390 ``getPoseCovariance``).

    Returns (K, 6, 6); fixed/invalid keyframes get zero blocks.

    Built with the matmul coupling (``schur_subtrahend_mm``) — the scatter-based build
    was a compile/runtime bomb at fr1 capacities. Includes pose-pose edge
    information (the reference extracts covariances from the full Hessian,
    graph_g2o.cpp:1324-1390)."""
    K = kf_pose.shape[0]
    L = lm_pos.shape[0]
    lam = bcfg.damping
    r, Jp, Jl, w, _ = _assemble_obs(bcfg, kf_pose, lm_pos, lm_valid, g, lm_gen,
                                    kf_gen, cam)
    C = jnp.einsum("m,mri,mra->mia", w, Jp, Jl)
    JpT_Jp = jnp.einsum("m,mri,mrj->mij", w, Jp, Jp)
    JlT_Jl = jnp.einsum("m,mri,mrj->mij", w, Jl, Jl)
    H_cc = jnp.zeros((K, K, 6, 6), kf_pose.dtype)
    H_cc = H_cc.at[jnp.arange(K), jnp.arange(K)].add(
        jnp.zeros((K, 6, 6), kf_pose.dtype).at[g.obs_kf].add(JpT_Jp))
    H_ll = jnp.zeros((L, 3, 3), kf_pose.dtype).at[g.obs_lm].add(JlT_Jl)
    # pose-pose edges
    pi = kf_pose[g.pp_i]
    pj = kf_pose[g.pp_j]
    r6 = factors.pp_residual(pi, pj, g.pp_rel)
    Ji, Jj = factors.pp_jacobians(pi, pj, g.pp_rel)
    wpp, _ = _pp_weights(bcfg, g, r6, kf_gen)
    H_cc = H_cc.at[g.pp_i, g.pp_i].add(jnp.einsum("e,eri,erj->eij", wpp, Ji, Ji))
    H_cc = H_cc.at[g.pp_j, g.pp_j].add(jnp.einsum("e,eri,erj->eij", wpp, Jj, Jj))
    H_cc = H_cc.at[g.pp_i, g.pp_j].add(jnp.einsum("e,eri,erj->eij", wpp, Ji, Jj))
    H_cc = H_cc.at[g.pp_j, g.pp_i].add(jnp.einsum("e,eri,erj->eij", wpp, Jj, Ji))

    tr_ll = (H_ll[..., 0, 0] + H_ll[..., 1, 1] + H_ll[..., 2, 2]) / 3.0
    H_ll_inv = inv3x3(H_ll + (lam * (1.0 + tr_ll))[:, None, None]
                      * jnp.eye(3, dtype=kf_pose.dtype))
    Linv = chol3x3(H_ll_inv)
    F = jnp.einsum("mia,mab->mib", C, Linv[g.obs_lm])
    S = (H_cc.transpose(0, 2, 1, 3).reshape(K * 6, K * 6)
         - schur_subtrahend_mm(g.obs_kf, g.obs_lm, F, K, L))
    frozen = fixed_kf | ~kf_valid
    frozen6 = jnp.repeat(frozen, 6)
    S = jnp.where(frozen6[:, None] | frozen6[None, :], 0.0, S)
    S = S + jnp.diag(frozen6.astype(S.dtype))
    S = 0.5 * (S + S.T)
    max_diag = jnp.maximum(jnp.max(jnp.abs(jnp.diagonal(S))), 1.0)
    S = S + (lam * max_diag) * jnp.eye(K * 6, dtype=S.dtype)
    S_inv = jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(S, lower=True),
        jnp.eye(K * 6, dtype=S.dtype))
    cov = S_inv.reshape(K, 6, K, 6)
    diag = jnp.einsum("kikj->kij", cov)
    return jnp.where(frozen[:, None, None], 0.0, diag)
