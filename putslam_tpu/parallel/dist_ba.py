"""Distributed bundle adjustment over a device mesh.

The reference has no distributed story (single process, SURVEY §2); this is
the scaling path for maps beyond one device: landmarks are
partitioned across the mesh, every device assembles the Hessian
contribution of *its* landmark block, and the reduced camera system is
formed by a ``psum`` of per-block Schur products:

    S = H_cc − Σ_d  H_cl^(d) · blkdiag(H_ll^(d)⁻¹) · H_cl^(d)ᵀ

The (K·6)² reduced system is then solved identically on every device
(replicated Cholesky — tiny), and each device back-substitutes only its own
landmark block. Per-device memory and the dominant matmul scale as 1/ndev;
the all-reduce payload is the (K·6)² matrix, independent of the map size.

Observation ownership: landmark slot l lives on device l mod ndev, at row
l ÷ ndev of its block. The engine allocates slots from 0 upward, so
contiguous blocks would put a young map on device 0 alone; the strided
assignment spreads it. The edge store is *partitioned by owner* before the
shard_map — each device receives only a (2·M/ndev)-slot slice holding its
own edges (stable argsort by owner, one gather), so per-device assembly
work, the per-observation einsums, AND the one-hot Schur coupling all scale
as 1/ndev, not just the Schur product. A device owning more than its 2×
slack slice drops the overflow edges from that call;
``partition_overflow`` reports the dropped count for observability.
Pose-pose edges are assembled on device 0 (K-sized, tiny) and psum'd.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from putslam_tpu.backend import factors
from putslam_tpu.backend.graph import GraphState
from putslam_tpu.backend.optimize import schur_subtrahend_mm
from putslam_tpu.config import BackendConfig, CameraConfig
from putslam_tpu.geometry import se3
from putslam_tpu.geometry.uncertainty import chol3x3, inv3x3


def owner_counts(g: GraphState, ndev: int):
    """Valid edges owned by each of ``ndev`` devices (numpy, (ndev,))."""
    import numpy as np

    owner = np.where(np.asarray(g.obs_valid), np.asarray(g.obs_lm) % ndev,
                     ndev)
    return np.bincount(owner, minlength=ndev + 1)[:ndev]


def partition_overflow(g: GraphState, ndev: int) -> int:
    """Edges dropped by the 2×-slack owner partition for this graph state
    (0 in balanced conditions) — host-side pre-check mirroring the in-jit
    ``overflow`` output of ``dist_gauss_newton`` (same formula); use it to
    size/rebalance BEFORE paying for a sharded compile on a pathologically
    skewed edge distribution."""
    import numpy as np

    M = g.obs_kf.shape[0]
    Ms = min(M, max(8, (2 * M) // ndev))
    return int(np.maximum(owner_counts(g, ndev) - Ms, 0).sum())


@functools.partial(jax.jit, static_argnums=(0, 1), static_argnames=("cam",))
def dist_gauss_newton(bcfg: BackendConfig, mesh: Mesh,
                      kf_pose, kf_valid, lm_pos, lm_valid,
                      g: GraphState, fixed_kf, lm_gen,
                      kf_gen=None, cam: CameraConfig = None):
    """Sharded Gauss-Newton: same math as backend.optimize.gauss_newton,
    with the landmark axis partitioned over ``mesh``'s first axis.

    Returns (kf_pose', lm_pos', chi2 (iters,), overflow ()): ``overflow``
    counts edges DROPPED by the 2×-slack owner partition — a nonzero value
    means a skewed ownership distribution silently weakened the solve, and
    callers must rebalance or fall back to the single-device solver.
    """
    axis = mesh.axis_names[0]
    ndev = mesh.devices.size
    K = kf_pose.shape[0]
    L = lm_pos.shape[0]
    assert L % ndev == 0, "landmark capacity must divide the mesh size"
    Ls = L // ndev
    lam = bcfg.damping
    fu, fv = (cam.fu, cam.fv) if cam is not None else (525.0, 525.0)
    if kf_gen is None:
        kf_gen = jnp.zeros((K,), jnp.int32)

    lm_sharding = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())

    # --- partition the edge store by owning device (stable argsort by
    # owner + one gather) so each device ships and scans only its slice ---
    M = g.obs_kf.shape[0]
    Ms = min(M, max(8, (2 * M) // ndev))            # 2× slack per device
    owner = jnp.where(g.obs_valid, g.obs_lm % ndev, ndev)
    order = jnp.argsort(owner, stable=True).astype(jnp.int32)
    counts = jnp.bincount(owner, length=ndev + 1)[:ndev]        # (ndev,)
    overflow = jnp.sum(jnp.maximum(counts - Ms, 0)).astype(jnp.int32)
    starts = jnp.concatenate(
        [jnp.zeros((1,), counts.dtype), jnp.cumsum(counts)[:-1]])
    jj = jnp.arange(Ms)
    take = jnp.clip(starts[:, None] + jj[None, :], 0, M - 1)    # (ndev, Ms)
    inb = jj[None, :] < counts[:, None]
    idx = order[take]                                           # (ndev, Ms)

    def _part(x):
        return x[idx]                                           # (ndev, Ms, ...)

    p_kf = _part(g.obs_kf)
    p_xyz = _part(g.obs_xyz)
    p_w = _part(g.obs_w)
    p_gen = _part(g.obs_gen)
    p_kfgen = _part(g.obs_kfgen)
    p_info = _part(g.obs_info)
    p_lm_local = _part(g.obs_lm) // ndev
    p_valid = inb & _part(g.obs_valid)

    def body(kf_pose, lm_pos_l, lm_valid_l, lm_gen_l,
             p_kf, p_lm_local, p_xyz, p_w, p_gen, p_kfgen, p_info, p_valid,
             g, fixed_kf, kf_valid, kf_gen):
        """shard_map body: lm_* are local (Ls,...) landmark blocks, p_* are
        this device's (Ms,...) edge slice; the rest replicated."""
        my = jax.lax.axis_index(axis)
        p_kf, p_lm_local, p_xyz, p_w, p_gen, p_kfgen, p_info, p_valid = (
            a[0] for a in (p_kf, p_lm_local, p_xyz, p_w, p_gen, p_kfgen,
                           p_info, p_valid))

        def iteration(carry, _):
            kf_pose, lm_pos_l = carry
            # --- this device's own observation factors --------------------
            safe_lm = jnp.clip(p_lm_local, 0, Ls - 1)
            kf_p = kf_pose[p_kf]
            lm_p = lm_pos_l[safe_lm]
            r, Jp, Jl = factors.assemble_obs_terms(
                kf_p, lm_p, p_xyz, bcfg.error_type, fu, fv)
            gate = (p_valid & lm_valid_l[safe_lm]
                    & (p_gen == lm_gen_l[safe_lm])
                    & (p_kfgen == kf_gen[p_kf]))
            if bcfg.use_obs_info and bcfg.error_type == 0:
                from putslam_tpu.geometry.uncertainty import chol3x3 as _c3
                tr = (p_info[..., 0, 0] + p_info[..., 1, 1]
                      + p_info[..., 2, 2])
                scalar = jnp.sqrt(jnp.maximum(p_w, 0.0))[:, None, None] \
                    * jnp.eye(3, dtype=kf_pose.dtype)
                Lw = jnp.where((tr > 0.0)[:, None, None], _c3(p_info),
                               scalar)
                r = jnp.einsum("msr,ms->mr", Lw, r)
                Jp = jnp.einsum("msr,msj->mrj", Lw, Jp)
                Jl = jnp.einsum("msr,msj->mrj", Lw, Jl)
                w_info = gate.astype(kf_pose.dtype)
            elif bcfg.error_type == 1:
                w_info = gate.astype(kf_pose.dtype) \
                    / (bcfg.obs_pixel_sigma ** 2)
            else:
                w_info = p_w * gate
            sq = w_info * jnp.sum(r * r, axis=-1)
            w = w_info * factors.robust_weight(sq, bcfg.robust_kernel,
                                               bcfg.robust_delta)
            chi2 = jax.lax.psum(jnp.sum(sq), axis)

            JpT_Jp = jnp.einsum("m,mri,mrj->mij", w, Jp, Jp)
            JlT_Jl = jnp.einsum("m,mri,mrj->mij", w, Jl, Jl)
            C = jnp.einsum("m,mri,mra->mia", w, Jp, Jl)    # (M, 6, 3)
            bp = -jnp.einsum("m,mri,mr->mi", w, Jp, r)
            bl = -jnp.einsum("m,mri,mr->mi", w, Jl, r)

            H_cc_part = jnp.zeros((K, K, 6, 6), kf_pose.dtype)
            H_cc_part = H_cc_part.at[p_kf, p_kf].add(JpT_Jp)
            H_ll = jnp.zeros((Ls, 3, 3), kf_pose.dtype).at[safe_lm].add(JlT_Jl)
            b_c_part = jnp.zeros((K, 6), kf_pose.dtype).at[p_kf].add(bp)
            b_l = jnp.zeros((Ls, 3), kf_pose.dtype).at[safe_lm].add(bl)

            # --- pose-pose edges: only on device 0 (then psum'd) ----------
            pi = kf_pose[g.pp_i]
            pj = kf_pose[g.pp_j]
            r6 = factors.pp_residual(pi, pj, g.pp_rel)
            Ji, Jj = factors.pp_jacobians(pi, pj, g.pp_rel)
            on0 = (my == 0).astype(kf_pose.dtype)
            pp_gate = (g.pp_valid & (g.pp_gen_i == kf_gen[g.pp_i])
                       & (g.pp_gen_j == kf_gen[g.pp_j]))
            wpp_info = g.pp_w * pp_gate * on0
            sq_pp = wpp_info * jnp.sum(r6 * r6, axis=-1)
            wpp = wpp_info * factors.robust_weight(
                sq_pp, bcfg.robust_kernel, bcfg.robust_delta)
            chi2 = chi2 + jax.lax.psum(jnp.sum(sq_pp), axis)
            H_cc_part = H_cc_part.at[g.pp_i, g.pp_i].add(
                jnp.einsum("e,eri,erj->eij", wpp, Ji, Ji))
            H_cc_part = H_cc_part.at[g.pp_j, g.pp_j].add(
                jnp.einsum("e,eri,erj->eij", wpp, Jj, Jj))
            H_cc_part = H_cc_part.at[g.pp_i, g.pp_j].add(
                jnp.einsum("e,eri,erj->eij", wpp, Ji, Jj))
            H_cc_part = H_cc_part.at[g.pp_j, g.pp_i].add(
                jnp.einsum("e,eri,erj->eij", wpp, Jj, Ji))
            b_c_part = b_c_part.at[g.pp_i].add(
                -jnp.einsum("e,eri,er->ei", wpp, Ji, r6))
            b_c_part = b_c_part.at[g.pp_j].add(
                -jnp.einsum("e,eri,er->ei", wpp, Jj, r6))

            # --- local Schur contribution + cross-device reduction ---------
            # matmul coupling build (optimize.schur_subtrahend_mm) — rows for edges not
            # owned by this shard vanish because w (hence C/F) is 0 there
            tr_ll = (H_ll[..., 0, 0] + H_ll[..., 1, 1] + H_ll[..., 2, 2]) / 3.0
            H_ll_inv = inv3x3(
                H_ll + (lam * (1.0 + tr_ll))[:, None, None]
                * jnp.eye(3, dtype=kf_pose.dtype))
            Linv = chol3x3(H_ll_inv)
            F = jnp.einsum("mia,mab->mib", C, Linv[safe_lm])
            S_part = (H_cc_part.transpose(0, 2, 1, 3).reshape(K * 6, K * 6)
                      - schur_subtrahend_mm(p_kf, safe_lm, F, K, Ls))
            # exact f32 gradient of the reduced system (per-obs products)
            t = jnp.einsum("lab,lb->la", H_ll_inv, b_l)      # (Ls, 3)
            c_m = jnp.einsum("mia,ma->mi", C, t[safe_lm])    # (M, 6)
            b_part = (b_c_part
                      - jnp.zeros((K, 6), kf_pose.dtype).at[p_kf].add(c_m)
                      ).reshape(K * 6)

            S = jax.lax.psum(S_part, axis)                 # (K6, K6) — tiny
            b_red = jax.lax.psum(b_part, axis)

            # --- replicated solve ----------------------------------------
            frozen = fixed_kf | ~kf_valid
            frozen6 = jnp.repeat(frozen, 6)
            S = jnp.where(frozen6[:, None] | frozen6[None, :], 0.0, S)
            S = S + jnp.diag(frozen6.astype(S.dtype))
            S = 0.5 * (S + S.T)
            max_diag = jnp.maximum(jnp.max(jnp.abs(jnp.diagonal(S))), 1.0)
            S = S + (lam * max_diag) * jnp.eye(K * 6, dtype=S.dtype)
            b_red = jnp.where(frozen6, 0.0, b_red)
            dc = jax.scipy.linalg.cho_solve(
                jax.scipy.linalg.cho_factor(S, lower=True), b_red)
            dc = jnp.where(jnp.isfinite(dc), dc, 0.0)
            dc = jnp.where(jnp.all(jnp.abs(dc) < 1e3), dc, 0.0)

            # --- local landmark back-substitution (per-obs products) ------
            u_m = jnp.einsum("mia,mi->ma", C, dc.reshape(K, 6)[p_kf])
            Hlc_dc = jnp.zeros((Ls, 3), kf_pose.dtype).at[safe_lm].add(u_m)
            dl = jnp.einsum("lab,lb->la", H_ll_inv, b_l - Hlc_dc)
            dl = jnp.where(jnp.isfinite(dl), dl, 0.0)

            new_pose = se3.retract(kf_pose, dc.reshape(K, 6))
            new_pose = jnp.where(frozen[:, None], kf_pose, new_pose)
            moved = lm_valid_l & (jnp.abs(dl).max(axis=-1) < 1e3)
            new_lm = jnp.where(moved[:, None], lm_pos_l + dl, lm_pos_l)
            return (new_pose, new_lm), chi2

        (kf_out, lm_out), chi2s = jax.lax.scan(
            iteration, (kf_pose, lm_pos_l), None, length=bcfg.gn_iterations)
        return kf_out, lm_out, chi2s

    sharded = shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis),
                  P(axis), P(axis), P(axis), P(axis), P(axis), P(axis),
                  P(axis), P(axis),
                  P(), P(), P(), P()),
        out_specs=(P(), P(axis), P()),
    )
    def to_blocks(x):
        """Slot order → owner blocks: row d·Ls + j holds slot j·ndev + d."""
        return jax.device_put(
            x.reshape((Ls, ndev) + x.shape[1:]).swapaxes(0, 1).reshape(
                x.shape), lm_sharding)

    kf_out, lm_out, chi2s = sharded(
        jax.device_put(kf_pose, repl),
        to_blocks(lm_pos), to_blocks(lm_valid), to_blocks(lm_gen),
        p_kf, p_lm_local, p_xyz, p_w, p_gen, p_kfgen, p_info, p_valid,
        jax.device_put(g, repl),
        jax.device_put(fixed_kf, repl),
        jax.device_put(kf_valid, repl),
        jax.device_put(kf_gen, repl),
    )
    lm_out = lm_out.reshape(ndev, Ls, 3).swapaxes(0, 1).reshape(L, 3)
    return kf_out, lm_out, chi2s, overflow
