#!/usr/bin/env python
"""Run the whole SLAM path once on the GPU, and check what comes out.

    python chip_smoke.py               # one card: phases 1-4
    python chip_smoke.py --four-cards  # four cards: phase 1, then phase 5 only

1. Device: JAX's first device must be a GPU. Prints the device kind and
   count, and each card's name and power limit from nvidia-smi.
2. Main path, file-played: a seeded handheld sequence is written to disk in
   the TUM layout (tools/make_disk_dataset.py), then played through the
   normal entry point ``putslam_tpu.run.main`` at ``tum_fr1_config()``
   widths: native decode, the chunked jitted scan, the final optimization,
   the trajectory files, ATE/RPE against the ground truth.
3. The same sequence with ``--only-vo``, and with
   ``--loop-closure --global-ba``.
4. Numerics on the card against the same computation on the CPU device of
   this process, or against an exact reference: detection + description,
   the Hamming products, the production BA solver against the scatter
   solver (on the engine's own graph after the sequence, and on a graph
   filling the config's capacities with the engine graph's views per
   landmark), and whether an f32 dot at DEFAULT precision runs in TF32
   here. Also times the FAST score map + non-max suppression.
5. ``--four-cards``: distributed finalize from the engine's state after the
   sequence, distributed BA at the config's capacities and session-sharded
   VO on a 4-card mesh, each against its one-card run.

One process owns the card(s). Every check raises on failure, so the script
exits non-zero and prints no result line; the last line of a passing run is
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import sys
import tempfile
import time

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))

FRAMES = 200        # 1 + three 64-frame chunks + a 7-frame padded tail
SEED = 3            # tools/make_disk_dataset.py's default sequence seed
CHUNK = 64

# ATE bounds (metres) on the sequence above, one per run. Origin: a CPU
# rehearsal of the identical sequence, seed and command (JAX_PLATFORMS=cpu,
# same phase functions, on the 16-core host of an H100 machine): ATE
# 0.0111 m (main path), 0.10031 m (VO only), 0.00839 m (loop closure +
# global BA). Margin: 2x the CPU ATE plus 5 mm. The GPU run does not
# reproduce the CPU trajectory bit for bit (reduction order, bf16/TF32
# products), so the bound is on ATE, not on poses.
ATE_BOUND_M = {"slam": 0.0272, "vo": 0.20562, "lc": 0.02178}

DESC_BITS_ALLOWED = 5e-3   # descriptor bits that may differ GPU vs CPU
# dense_schur_mm vs the dense_schur oracle, both running the same number of
# iterations: poses within 2e-4 and chi² within 2 %, as in
# tests/test_round3.py::test_solvers_agree.
BA_POSE_ATOL = 2e-4
BA_CHI2_RTOL = 0.02
# split-bf16 Schur curvature against the f32 scatter solve, and a sharded
# reduction order: direction-only drift
DIST_POSE_ATOL = 5e-3
# vmapped vs one-by-one VO is the same computation, but XLA may choose other
# kernels for the batched form and a RANSAC tie may then pick another
# hypothesis; 5 mm is well under the ~3 cm VO error on these sequences.
VO_POSE_ATOL = 5e-3
GRAPH_NOISE_M = 0.005      # observation noise of the synthetic BA graph


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------------------
# 1. device
# --------------------------------------------------------------------------


def phase_device(n_cards: int = 1):
    """(JAX devices, nvidia-smi's name and power limit of each card), or
    SystemExit when the first device is not a GPU or there are fewer than
    ``n_cards``."""
    from putslam_tpu.utils.device import card_name_and_power, require_gpu

    devs = require_gpu()
    if len(devs) < n_cards:
        raise SystemExit(f"need {n_cards} GPUs, JAX sees {len(devs)}")
    log(f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)}")
    card = card_name_and_power()
    log(f"card (name, power limit): {card}")
    return devs, card


# --------------------------------------------------------------------------
# 2-3. the main path and its variants, through run.main
# --------------------------------------------------------------------------


def materialize(root: str, frames: int = FRAMES, seed: int = SEED) -> str:
    """Write the seeded handheld sequence (clean preset, fr1 camera) to
    ``root`` with tools/make_disk_dataset.py."""
    sys.path.insert(0, os.path.join(_ROOT, "tools"))
    import make_disk_dataset

    rc = make_disk_dataset.main(["--frames", str(frames), "--out", root,
                                 "--seed", str(seed), "--degrade", "clean"])
    if rc != 0:
        raise RuntimeError(f"make_disk_dataset exited {rc}")
    return root


def run_engine(dataset: str, out: str, *extra: str) -> dict:
    """``putslam_tpu.run.main`` on ``dataset``; returns its JSON report."""
    from putslam_tpu import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(["--dataset", dataset, "--out", out,
                       "--chunk", str(CHUNK), *extra])
    if rc != 0:
        raise RuntimeError(f"run.main {extra} exited {rc}")
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    files = ["VO_trajectory.res", "fps.res"]
    if "--only-vo" not in extra:
        files.append("graph_trajectory.res")
    for f in files:
        if not os.path.exists(os.path.join(out, f)):
            raise RuntimeError(f"run.main {extra} wrote no {f}")
    return report


def check_run(name: str, report: dict, frames: int, bound: float,
              card: str) -> dict:
    """Print a run's numbers; raise unless they are finite and in bound."""
    log(f"{name}: frames={report['frames']} "
        f"first_chunk_s={report.get('first_chunk_s')} "
        f"steady_fps={report.get('steady_fps')} fps={report['fps']} "
        f"on {report['platform']}/{report['device_kind']} [{card}] "
        f"ATE={report.get('ate_rmse_m')} m (bound {bound}) "
        f"ATE_before_final={report.get('ate_before_final_m')} "
        f"RPE={report.get('rpe_trans_m')} m / {report.get('rpe_rot_rad')} rad")
    if report["frames"] != frames:
        raise RuntimeError(f"{name}: {report['frames']} frames, want {frames}")
    for k in ("ate_rmse_m", "rpe_trans_m", "rpe_rot_rad"):
        if not math.isfinite(report.get(k, math.nan)):
            raise RuntimeError(f"{name}: {k} missing or not finite")
    if report["ate_rmse_m"] > bound:
        raise RuntimeError(f"{name}: ATE {report['ate_rmse_m']} m > {bound}")
    return report


def decoder_name() -> str:
    from putslam_tpu.io import native_loader

    return ("native libpng (native/libputslam_io.so)"
            if native_loader.available() else "numpy (putslam_tpu/io/png.py)")


def phase_main_path(work: str, card: str, frames: int = FRAMES,
                    seed: int = SEED, bound: float = ATE_BOUND_M["slam"]):
    dataset = materialize(os.path.join(work, "seq"), frames, seed)
    log(f"decoder: {decoder_name()}")
    rep = run_engine(dataset, os.path.join(work, "out_slam"))
    return dataset, check_run("main path", rep, frames, bound, card)


def phase_vo_and_lc(work: str, dataset: str, card: str,
                    frames: int = FRAMES, bounds=None):
    bounds = bounds or ATE_BOUND_M
    vo = run_engine(dataset, os.path.join(work, "out_vo"), "--only-vo")
    vo = check_run("vo only", vo, frames, bounds["vo"], card)
    lc = run_engine(dataset, os.path.join(work, "out_lc"),
                    "--loop-closure", "--global-ba")
    lc = check_run("loop closure + global BA", lc, frames, bounds["lc"],
                   card)
    return vo, lc


# --------------------------------------------------------------------------
# 4. numerics against the plain reference
# --------------------------------------------------------------------------


def _keypoint_order(f) -> np.ndarray:
    """Valid keypoints sorted by (octave, v, u), so two runs compare as
    sets whatever order their top-k left ties in."""
    valid = np.flatnonzero(np.asarray(f.valid))
    uv = np.round(np.asarray(f.uv)[valid], 2)
    octv = np.asarray(f.octave)[valid]
    return valid[np.lexsort((uv[:, 0], uv[:, 1], octv))]


_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.int32)


def popcount_hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, M) Hamming distances of ±1 descriptors by XOR + popcount."""
    pa = np.packbits(a > 0, axis=1)
    pb = np.packbits(b > 0, axis=1)
    out = np.empty((len(a), len(b)), np.int32)
    for s in range(0, len(a), 64):
        x = pa[s:s + 64, None, :] ^ pb[None, :, :]
        out[s:s + 64] = _POPCOUNT8[x].sum(-1)
    return out


def check_detection(cfg, gray, depth, dev, ref_dev):
    """detect_and_describe on ``dev`` against ``ref_dev``: equal keypoint
    sets (FAST compares in f32; positions to 1e-3 px, because the sub-pixel
    refinement divides), descriptor bits equal except at bf16 sign-test
    ties. Returns the features computed on ``dev``."""
    import jax

    from putslam_tpu.frontend.detector import detect_and_describe

    f_dev = detect_and_describe(cfg, jax.device_put(gray, dev),
                                jax.device_put(depth, dev))
    f_ref = detect_and_describe(cfg, jax.device_put(gray, ref_dev),
                                jax.device_put(depth, ref_dev))
    ia, ib = _keypoint_order(f_dev), _keypoint_order(f_ref)
    if len(ia) != len(ib) or len(ia) == 0:
        raise RuntimeError(f"keypoints: {len(ia)} on {dev}, {len(ib)} on "
                           f"{ref_dev}")
    if not np.array_equal(np.asarray(f_dev.octave)[ia],
                          np.asarray(f_ref.octave)[ib]):
        raise RuntimeError("keypoint octaves differ")
    duv = np.abs(np.asarray(f_dev.uv)[ia] - np.asarray(f_ref.uv)[ib]).max()
    if duv > 1e-3:
        raise RuntimeError(f"keypoint positions differ by {duv} px")
    bits = np.asarray(f_dev.desc)[ia] != np.asarray(f_ref.desc)[ib]
    frac = float(bits.mean())
    log(f"numerics: keypoints equal ({len(ia)}; max |duv| {duv} px); "
        f"descriptor bits differing {int(bits.sum())}/{bits.size} = {frac} "
        f"(allowed {DESC_BITS_ALLOWED}: bf16 sign-test ties)")
    if frac > DESC_BITS_ALLOWED:
        raise RuntimeError(f"descriptor bits differ: {frac}")
    return f_dev


def check_hamming(cfg, feat, dev, seed: int = 0):
    """The two bf16 Hamming products must equal XOR + popcount exactly:
    ``ops.matching.hamming_matrix`` against a map-sized descriptor bank,
    and the guided-match product of ``slam_map.features_map``."""
    import jax
    import jax.numpy as jnp

    from putslam_tpu.geometry import se3
    from putslam_tpu.ops import matching
    from putslam_tpu.slam_map import features_map as fm

    rng = np.random.default_rng(seed)
    L, D = cfg.map.max_landmarks, cfg.map.descriptor_views
    valid = np.asarray(feat.valid)
    desc = np.asarray(feat.desc)[valid]
    bank = rng.choice(np.array([-1, 1], np.int8), (L, D, fm.DESC_BITS))

    got = np.asarray(jax.jit(matching.hamming_matrix)(
        jax.device_put(desc, dev),
        jax.device_put(bank.reshape(L * D, -1), dev)))
    ref = popcount_hamming(desc, bank.reshape(L * D, -1))
    if not np.array_equal(got, ref):
        raise RuntimeError(f"hamming_matrix differs from popcount: max "
                           f"{np.abs(got - ref).max()}")

    # guided product: landmarks placed on the frame's own 3D points, so the
    # sphere and octave gates pass and the Hamming term decides
    N = feat.capacity
    n = min(N, L)
    m = fm.init_map(cfg)
    m = m._replace(
        lm_pos=m.lm_pos.at[:n].set(feat.xyz[:n]),
        lm_octave=m.lm_octave.at[:n].set(feat.octave[:n]),
        lm_valid=m.lm_valid.at[:n].set(feat.has_depth[:n]),
        lm_desc=jnp.asarray(bank),
        lm_slot_used=jnp.ones((L, D), bool))
    guided = jax.jit(fm._guided_distances, static_argnums=(0, 4))
    dist = np.asarray(guided(cfg, jax.device_put(m, dev),
                             jax.device_put(se3.identity(), dev),
                             jax.device_put(feat, dev), 1.0))
    full = np.asarray(feat.desc)
    ref_g = popcount_hamming(full, bank.reshape(L * D, -1))
    ref_g = ref_g.reshape(N, L, D).min(-1).T                      # (L, N)
    fin = np.isfinite(dist)
    if fin.sum() == 0:
        raise RuntimeError("guided product: every pair gated out")
    if not np.array_equal(dist[fin], ref_g[fin]):
        raise RuntimeError("guided Hamming product differs from popcount")
    log(f"numerics: Hamming exact ({got.size} hamming_matrix pairs, "
        f"{int(fin.sum())} guided pairs) against XOR + popcount")


def make_graph(K: int, L: int, M: int, E: int, n_lm: int,
               views: np.ndarray):
    """A seeded BA problem in a (K, L, M, E)-capacity graph: K keyframes on
    a path, odometry edges between consecutive ones, and up to ``n_lm``
    landmarks, each seen by a run of consecutive keyframes whose length is
    drawn from ``views`` (observations per landmark, as an engine graph has
    them), so that the observations fit in M. Returns (kf_true, kf_init,
    lm_true, lm_init, lm_valid, graph) as numpy / GraphState."""
    import jax.numpy as jnp

    from putslam_tpu.backend.graph import GraphState
    from putslam_tpu.geometry import se3

    rng = np.random.default_rng(0)
    t = np.stack([np.linspace(0.0, 3.0, K),
                  0.2 * np.sin(np.linspace(0.0, 6.0, K)),
                  np.linspace(0.0, 1.0, K)], -1)
    rv = 0.1 * rng.normal(size=(K, 3))
    q = np.asarray(se3.so3_exp_quat(jnp.asarray(rv, jnp.float32)))
    kf_true = np.concatenate([t, q], -1).astype(np.float32)

    v = np.clip(rng.choice(np.asarray(views), min(n_lm, L)), 1, K)
    v = v[:np.searchsorted(np.cumsum(v), M, side="right")]
    n_lm = len(v)
    home = np.clip(np.round((np.arange(n_lm) + 0.5) * K / n_lm - v / 2),
                   0, K - v).astype(np.int64)       # first keyframe of each
    lm_local = np.stack([rng.uniform(-1.5, 1.5, n_lm),
                         rng.uniform(-1.0, 1.0, n_lm),
                         rng.uniform(2.0, 4.0, n_lm)], -1)
    lm_used = np.asarray(se3.apply(jnp.asarray(kf_true[home + v // 2]),
                                   jnp.asarray(lm_local, jnp.float32)))
    slots = rng.choice(L, n_lm, replace=False)
    lm_true = np.zeros((L, 3), np.float32)
    lm_true[slots] = lm_used
    lm_valid = np.zeros((L,), bool)
    lm_valid[slots] = True

    first = np.repeat(home - np.cumsum(v) + v, v)     # per-observation
    obs_kf = first + np.arange(v.sum())
    obs_lm = np.repeat(slots, v)
    m = len(obs_kf)
    z = np.asarray(se3.apply(se3.inverse(jnp.asarray(kf_true[obs_kf])),
                             jnp.asarray(lm_true[obs_lm])))
    z = z + rng.normal(0.0, GRAPH_NOISE_M, z.shape).astype(np.float32)

    def pad(x, fill=0):
        out = np.full((M,) + x.shape[1:], fill, x.dtype)
        out[:m] = x
        return out

    ei, ej = np.arange(K - 1), np.arange(1, K)
    rel = np.asarray(se3.relative(jnp.asarray(kf_true[ei]),
                                  jnp.asarray(kf_true[ej])))
    ne = min(K - 1, E)
    pp_rel = np.zeros((E, 7), np.float32)
    pp_rel[:, 3] = 1.0
    pp_rel[:ne] = rel[:ne]

    def pad_e(x):
        out = np.zeros((E,), x.dtype)
        out[:ne] = x[:ne]
        return out

    g = GraphState(
        obs_kf=jnp.asarray(pad(obs_kf.astype(np.int32))),
        obs_lm=jnp.asarray(pad(obs_lm.astype(np.int32))),
        obs_xyz=jnp.asarray(pad(z.astype(np.float32))),
        obs_w=jnp.asarray(pad(np.full((m,), GRAPH_NOISE_M ** -2,
                                      np.float32))),
        obs_gen=jnp.zeros((M,), jnp.int32),
        obs_kfgen=jnp.zeros((M,), jnp.int32),
        obs_seq=jnp.asarray(pad(np.arange(m, dtype=np.int32))),
        obs_valid=jnp.asarray(pad(np.ones((m,), bool))),
        n_obs=jnp.int32(m),
        obs_info=jnp.zeros((M, 3, 3), jnp.float32),
        pp_i=jnp.asarray(pad_e(ei.astype(np.int32))),
        pp_j=jnp.asarray(pad_e(ej.astype(np.int32))),
        pp_rel=jnp.asarray(pp_rel),
        pp_w=jnp.asarray(pad_e(np.full((K - 1,), 1e3, np.float32))),
        pp_gen_i=jnp.zeros((E,), jnp.int32),
        pp_gen_j=jnp.zeros((E,), jnp.int32),
        pp_valid=jnp.asarray(pad_e(np.ones((K - 1,), bool))),
        n_pp=jnp.int32(ne),
    )
    kf_init = np.array(se3.retract(
        jnp.asarray(kf_true),
        jnp.asarray(rng.normal(0.0, 0.01, (K, 6)).astype(np.float32))))
    kf_init[0] = kf_true[0]
    lm_init = lm_true + np.where(
        lm_valid[:, None], rng.normal(0.0, 0.02, (L, 3)), 0.0
    ).astype(np.float32)
    return kf_true, kf_init, lm_true, lm_init, lm_valid, g


def engine_state(cfg, dataset: str):
    """The engine's state at the end of ``dataset``, before the final
    optimization: the decode and the chunked scan of ``run.main`` (whose
    scan this process has compiled already). Returns (cfg with the
    dataset's camera, state)."""
    from putslam_tpu import run
    from putslam_tpu.models import slam

    cfg, _, grays, depths, _, gt = run.load_dataset(cfg, dataset)
    _, _, st = slam.run_slam(cfg, grays, depths, init_pose=gt[0],
                             chunk_size=CHUNK)
    return cfg, st


def finalize_inputs(cfg, st):
    """What ``slam.finalize`` hands its first solve: every keyframe free but
    the oldest, the landmarks with ``final_min_obs`` observations. Returns
    (positional args of optimize_graph, its lm_gen/kf_gen/cam keywords)."""
    import jax.numpy as jnp

    m = st.map
    lm_valid = m.lm_valid & (m.lm_n_obs >= cfg.backend.final_min_obs)
    seqs = jnp.where(m.kf_valid, m.kf_seq, jnp.iinfo(jnp.int32).max)
    fixed = jnp.zeros_like(m.kf_valid).at[jnp.argmin(seqs)].set(True)
    return ((m.kf_pose, m.kf_valid, m.lm_pos, lm_valid, st.graph, fixed),
            dict(lm_gen=m.lm_gen, kf_gen=m.kf_gen, cam=cfg.camera))


def view_counts(args, kw) -> np.ndarray:
    """Observations per landmark in a graph, over the landmarks with any:
    the edges a solve of ``args``/``kw`` keeps (valid, to a valid landmark
    and keyframe of the generation the edge was made with). Raises when
    there are none: an engine that kept no map has nothing to compare."""
    kf_valid, lm_valid, g = (np.asarray(args[1]), np.asarray(args[3]),
                             args[4])
    lm, kf = np.asarray(g.obs_lm), np.asarray(g.obs_kf)
    ok = (np.asarray(g.obs_valid) & lm_valid[lm] & kf_valid[kf]
          & (np.asarray(g.obs_gen) == np.asarray(kw["lm_gen"])[lm])
          & (np.asarray(g.obs_kfgen) == np.asarray(kw["kf_gen"])[kf]))
    if not ok.any():
        raise RuntimeError("the engine's graph holds no usable observation")
    counts = np.bincount(lm[ok], minlength=len(lm_valid))
    return counts[counts > 0]


def compare_solvers(name, bcfg, args, kw, dev):
    """One ``optimize_graph`` call with the production ``dense_schur_mm``
    solver (default precision) against the scatter ``dense_schur`` oracle
    at HIGHEST matmul precision, both on ``dev``; raises unless the poses
    and the final chi² agree. Returns (max |dpose|, relative chi² gap).

    dense_schur_mm's chi²-ratio stop is off here, so that both run every
    iteration: along the weak directions of a long keyframe chain the
    oracle's poses still drift by millimetres per iteration at a chi² that
    changes in the sixth digit, so two solvers that stop at different
    iterations differ there for a reason that is not numeric."""
    import jax

    from putslam_tpu.backend import optimize as opt

    bcfg = dataclasses.replace(bcfg, chi2_ratio_termination=math.inf)
    args = jax.device_put(args, dev)
    mm = opt.optimize_graph(dataclasses.replace(bcfg,
                                                solver="dense_schur_mm"),
                            *args, **kw)
    with jax.default_matmul_precision("highest"):
        ref = opt.optimize_graph(dataclasses.replace(bcfg,
                                                     solver="dense_schur"),
                                 *args, **kw)
    dpose = float(np.abs(np.asarray(mm.kf_pose)
                         - np.asarray(ref.kf_pose)).max())
    c_mm, c_ref = float(mm.chi2[-1]), float(ref.chi2[-1])
    rel = abs(c_mm - c_ref) / max(c_ref, 1e-6)
    log(f"numerics: BA {name}: dense_schur_mm vs dense_schur (HIGHEST): "
        f"max |dpose| {dpose} (atol {BA_POSE_ATOL}); chi2 {c_mm} vs "
        f"{c_ref}, rel {rel} (rtol {BA_CHI2_RTOL}); chi2 start "
        f"{float(ref.chi2[0])}")
    if not (dpose <= BA_POSE_ATOL and rel <= BA_CHI2_RTOL):
        raise RuntimeError(f"BA {name}: dense_schur_mm disagrees with "
                           f"dense_schur")
    return dpose, rel


def check_ba(cfg, st, dev):
    """The production BA solver against the scatter oracle, with the
    end-of-run finalize's settings, on two graphs:

    - the engine's own graph after the sequence, with finalize's inputs
      (capped to the first ``ba_lm_block`` landmarks, the ones
      dense_schur_mm keeps, so that both solve the same problem);
    - a graph filling the config's capacities: K keyframes, M observations,
      as many landmarks as fit in ``ba_lm_block`` and M, each with a number
      of views drawn from the engine graph's.

    The robust kernel is off, as in tests/test_round3.py::test_solvers_agree:
    Cauchy reweighting moves the problem with the estimate, so two paths
    that differ in the last bits can reweight apart."""
    import jax.numpy as jnp

    K, L = cfg.map.max_keyframes, cfg.map.max_landmarks
    M, E = cfg.backend.max_observations, cfg.backend.max_pose_pose_edges
    LC = cfg.backend.ba_lm_block or L
    bcfg = dataclasses.replace(
        cfg.backend, gn_iterations=cfg.backend.final_gn_iterations,
        ba_window=0, robust_kernel="none")

    args, kw = finalize_inputs(cfg, st)
    keep = np.flatnonzero(np.asarray(args[3]))[:LC]
    args = args[:3] + (jnp.zeros((L,), bool).at[keep].set(True),) + args[4:]
    views = view_counts(args, kw)
    log(f"numerics: engine graph: {int(np.asarray(args[1]).sum())} "
        f"keyframes, {int(views.sum())} observations of {len(views)} "
        f"landmarks; views per landmark: mean {views.mean()}, "
        f"median {np.median(views)}, max {views.max()}, histogram "
        f"{np.bincount(views).tolist()}")
    compare_solvers(f"engine graph (K={K} L={L} M={M})", bcfg, args, kw, dev)

    _, kf_init, _, lm_init, lm_valid, g = make_graph(K, L, M, E, LC, views)
    compare_solvers(
        f"K={K} L={L} M={M}, {int(lm_valid.sum())} landmarks, "
        f"{int(g.n_obs)} observations, views from the engine graph", bcfg,
        (jnp.asarray(kf_init), jnp.ones((K,), bool), jnp.asarray(lm_init),
         jnp.asarray(lm_valid), g, jnp.zeros((K,), bool).at[0].set(True)),
        {}, dev)


def check_onehot_precision(cfg, dev, seed: int = 0):
    """The one-hot read of gauss_newton_mm (landmark positions to
    observations) at DEFAULT against HIGHEST precision on ``dev``: prints
    whether an f32 dot at DEFAULT is exact here (if not, TF32 is in play
    and the HIGHEST pins in backend/optimize.py are needed)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    M, L = cfg.backend.max_observations, cfg.backend.ba_lm_block
    idx = rng.integers(0, L, M)
    x = rng.uniform(-4.0, 4.0, (L, 3)).astype(np.float32)
    q = jax.device_put(jax.nn.one_hot(idx, L, dtype=jnp.float32), dev)
    xd = jax.device_put(x, dev)

    def read(precision):
        return np.asarray(jax.jit(lambda a, b: jax.lax.dot_general(
            a, b, (((1,), (0,)), ((), ())), precision=precision))(q, xd))

    exact = x[idx]
    err_def = float(np.abs(read(jax.lax.Precision.DEFAULT) - exact).max())
    err_hi = float(np.abs(read(jax.lax.Precision.HIGHEST) - exact).max())
    log(f"numerics: one-hot read M={M} L={L}: max error DEFAULT {err_def}, "
        f"HIGHEST {err_hi}; TF32 in play at DEFAULT: {err_def > 0.0}")
    if err_hi != 0.0:
        raise RuntimeError(f"one-hot read at HIGHEST is not exact: {err_hi}")
    return err_def


def time_fast(cfg, dev, reps: int = 200) -> float:
    """Mean ms of the jitted ``fast.nms(fast.fast_score_map(...))`` on one
    ``cfg.camera``-sized frame on ``dev`` (warm, device-fenced)."""
    import jax

    from putslam_tpu.ops import fast

    det = cfg.detector
    g = jax.device_put(np.random.default_rng(0).uniform(
        0, 1, (cfg.camera.height, cfg.camera.width)).astype(np.float32), dev)
    fn = jax.jit(lambda x: fast.nms(fast.fast_score_map(
        x, det.fast_threshold), det.nms_radius))
    jax.block_until_ready(fn(g))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(g)
    jax.block_until_ready(out)
    ms = 1e3 * (time.perf_counter() - t0) / reps
    log(f"fast: fast_score_map + nms at {cfg.camera.width}x"
        f"{cfg.camera.height} on {dev.device_kind}: {ms} ms per frame "
        f"(mean of {reps}, XLA)")
    return ms


def phase_numerics(cfg, gray, depth, st, dev, ref_dev):
    """Phase 4 on one frame ``gray``/``depth`` and the engine state ``st``
    after the sequence."""
    feat = check_detection(cfg, gray, depth, dev, ref_dev)
    check_hamming(cfg, feat, dev)
    check_ba(cfg, st, dev)
    check_onehot_precision(cfg, dev)
    time_fast(cfg, dev)


# --------------------------------------------------------------------------
# 5. four cards
# --------------------------------------------------------------------------


def _on_all(x, devs, what: str):
    """Raise unless ``x`` has one shard on each of ``devs``."""
    got = {s.device for s in x.addressable_shards}
    if got != set(devs):
        raise RuntimeError(f"{what}: shards on {sorted(map(str, got))}, "
                           f"want one on each of {len(devs)} devices")


def _edges_on_all(g, n: int, what: str):
    """Raise unless each of the ``n`` devices owns observation edges of
    ``g`` under dist_ba's partition, and none overflows its slice."""
    from putslam_tpu.parallel import dist_ba

    counts = dist_ba.owner_counts(g, n)
    ovf = dist_ba.partition_overflow(g, n)
    log(f"four cards: {what}: edges per device {counts.tolist()}, "
        f"overflow {ovf}")
    if counts.min() == 0 or ovf:
        raise RuntimeError(f"{what}: edges per device {counts.tolist()}, "
                           f"overflow {ovf}")


def phase_four_cards(cfg, devs, work: str, frames: int = FRAMES,
                     vo_frames: int = 16, sessions: int = 4):
    """finalize_dist vs finalize from the engine's state after phase 2's
    sequence, dist_gauss_newton vs the single-device scatter solve at the
    config's capacities, vo_sessions_sharded vs one vo_sequence per
    session; each on a 1-D mesh over ``devs``."""
    import jax
    import jax.numpy as jnp

    from putslam_tpu.backend import optimize as opt
    from putslam_tpu.io import synthetic
    from putslam_tpu.models import slam, vo
    from putslam_tpu.parallel import dist_ba, mesh as mesh_mod

    n = len(devs)
    # --- finalize_dist from the engine's own state -------------------------
    dataset = materialize(os.path.join(work, "seq"), frames)
    cfg, st = engine_state(cfg, dataset)
    cam = cfg.camera
    lm_mesh = mesh_mod.make_mesh(n, axis="lm")
    _edges_on_all(st.graph, n, "engine graph")
    single = slam.finalize(cfg, st)
    dist = slam.finalize_dist(cfg, st, lm_mesh)
    kv = np.asarray(st.map.kf_valid)
    if kv.sum() < 4:
        raise RuntimeError(f"only {int(kv.sum())} keyframes: nothing to "
                           f"compare finalize_dist on")
    d_fin = float(np.abs(np.asarray(single.map.kf_pose)[kv]
                         - np.asarray(dist.map.kf_pose)[kv]).max())
    moved = float(np.abs(np.asarray(single.map.kf_pose)[kv]
                         - np.asarray(st.map.kf_pose)[kv]).max())
    log(f"four cards: finalize_dist vs finalize ({cfg.backend.solver}) over "
        f"{int(kv.sum())} keyframes: max |dpose| {d_fin} (atol "
        f"{DIST_POSE_ATOL}); finalize moved keyframes by up to {moved}")
    if d_fin > DIST_POSE_ATOL:
        raise RuntimeError("finalize_dist disagrees with finalize")

    # --- dist_gauss_newton at the config's capacities, views per landmark
    # from the engine's graph (as in phase 4) -------------------------------
    K, L = cfg.map.max_keyframes, cfg.map.max_landmarks
    M, E = cfg.backend.max_observations, cfg.backend.max_pose_pose_edges
    views = view_counts(*finalize_inputs(cfg, st))
    _, kf_init, _, lm_init, lm_valid, g = make_graph(
        K, L, M, E, cfg.backend.ba_lm_block or L, views)
    _edges_on_all(g, n, "capacity graph")
    # finalize_dist's settings, so its compiled solve is reused
    bcfg = dataclasses.replace(cfg.backend,
                               gn_iterations=cfg.backend.final_gn_iterations,
                               ba_window=0)
    args = (jnp.asarray(kf_init), jnp.ones((K,), bool), jnp.asarray(lm_init),
            jnp.asarray(lm_valid), g, jnp.zeros((K,), bool).at[0].set(True),
            jnp.zeros((L,), jnp.int32), jnp.zeros((K,), jnp.int32))
    with jax.default_matmul_precision("highest"):
        ref = opt.gauss_newton(bcfg, *args, cam=cam)
    kf_d, lm_d, chi2_d, ovf = dist_ba.dist_gauss_newton(bcfg, lm_mesh, *args,
                                                        cam=cam)
    d_kf = float(np.abs(np.asarray(kf_d) - np.asarray(ref.kf_pose)).max())
    d_lm = float(np.abs(np.asarray(lm_d) - np.asarray(ref.lm_pos))[
        lm_valid].max())
    c_d, c_r = float(chi2_d[-1]), float(ref.chi2[-1])
    log(f"four cards: dist_gauss_newton K={K} L={L} M={M} "
        f"({int(lm_valid.sum())} landmarks, {int(g.n_obs)} observations, "
        f"views from the engine graph) vs gauss_newton: "
        f"overflow {int(ovf)}, max |dpose| {d_kf}, max |dlm| {d_lm}, chi2 "
        f"{c_d} vs {c_r} (atol {DIST_POSE_ATOL}, rtol {BA_CHI2_RTOL})")
    if (int(ovf) or d_kf > DIST_POSE_ATOL or d_lm > DIST_POSE_ATOL
            or abs(c_d - c_r) > BA_CHI2_RTOL * max(c_r, 1e-6)):
        raise RuntimeError("dist_gauss_newton disagrees with gauss_newton")

    # --- session-sharded VO -----------------------------------------------
    sess = [synthetic.handheld_trajectory(vo_frames, seed=SEED + s)
            for s in range(sessions)]
    gd = [synthetic.render_sequence(cam, p) for p in sess]
    g_all = jnp.stack([x[0] for x in gd])
    d_all = jnp.stack([x[1] for x in gd])
    s_mesh = mesh_mod.make_mesh(n)
    sharded = mesh_mod.vo_sessions_sharded(cfg, s_mesh, g_all, d_all, seed=0)
    _on_all(sharded, devs, "vo_sessions_sharded poses")
    keys = jax.random.split(jax.random.PRNGKey(0), sessions)
    d_vo = 0.0
    for s in range(sessions):
        one, _ = vo.vo_sequence(cfg, g_all[s], d_all[s], keys[s])
        d_vo = max(d_vo, float(np.abs(np.asarray(one)
                                      - np.asarray(sharded[s])).max()))
    log(f"four cards: vo_sessions_sharded ({sessions} sessions x {vo_frames} "
        f"frames) vs one vo_sequence each: max |dpose| {d_vo} "
        f"(atol {VO_POSE_ATOL})")
    if d_vo > VO_POSE_ATOL:
        raise RuntimeError("vo_sessions_sharded disagrees with vo_sequence")


# --------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the distributed phase, on four GPUs")
    args = ap.parse_args(argv)

    import jax

    from putslam_tpu.config import tum_fr1_config
    from putslam_tpu.io import tum
    from putslam_tpu.utils.device import enable_compile_cache

    devs, card = phase_device(4 if args.four_cards else 1)
    enable_compile_cache()
    cfg = tum_fr1_config()
    with tempfile.TemporaryDirectory() as work:
        if args.four_cards:
            phase_four_cards(cfg, devs[:4], work)
        else:
            dataset, _ = phase_main_path(work, card)
            phase_vo_and_lc(work, dataset, card)
            cfg, st = engine_state(cfg, dataset)
            frame = tum.TumDataset(dataset)[0]
            phase_numerics(cfg, frame.gray, frame.depth, st, devs[0],
                           jax.devices("cpu")[0])
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
