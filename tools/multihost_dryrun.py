#!/usr/bin/env python
"""2-process dryrun: distributed BA over a mesh spanning OS processes.

Each process hosts N virtual CPU devices; together they form a 2N-device
global mesh. Both processes build the identical synthetic BA problem
(seeded) and run ``parallel.dist_ba.dist_gauss_newton`` over the global
mesh — the Schur psum crosses the process boundary exactly as it would
cross the network between hosts. Prints one JSON line with the final chi² so
the caller can compare against the single-process result.

Usage (each process):
    python tools/multihost_dryrun.py --coordinator 127.0.0.1:PORT \
        --num-processes 2 --process-id {0,1} [--devices-per-process 4]
Single-process reference:
    python tools/multihost_dryrun.py --single [--devices-per-process 8]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_problem(rng, K=8, L=64, M=512, E=16):
    import jax.numpy as jnp
    from putslam_tpu.backend import graph
    from putslam_tpu.geometry import se3

    kf_t = jnp.asarray(rng.uniform(-0.5, 0.5, (K, 3)), jnp.float32)
    kf_pose = jnp.concatenate(
        [kf_t, jnp.tile(jnp.array([1.0, 0, 0, 0], jnp.float32), (K, 1))],
        axis=1)
    kf_valid = jnp.ones((K,), bool)
    lm_gt = jnp.asarray(rng.uniform([-2, -1.5, 1.0], [2, 1.5, 4.0], (L, 3)),
                        jnp.float32)
    lm_valid = jnp.ones((L,), bool)
    lm_gen = jnp.zeros((L,), jnp.int32)

    g = graph.init_graph(M, E)
    n_obs = 0
    obs_kf, obs_lm, obs_xyz = [], [], []
    for k in range(K):
        T = kf_pose[k]
        z = se3.apply(se3.inverse(T), lm_gt)
        z = z + jnp.asarray(rng.normal(0, 0.01, z.shape), jnp.float32)
        obs_kf.append(jnp.full((L,), k, jnp.int32))
        obs_lm.append(jnp.arange(L, dtype=jnp.int32))
        obs_xyz.append(z)
        n_obs += L
    g = graph.add_observations(
        g, jnp.concatenate(obs_kf), jnp.concatenate(obs_lm),
        jnp.concatenate(obs_xyz),
        jnp.full((n_obs,), 100.0), jnp.ones((n_obs,), bool))
    lm_init = lm_gt + jnp.asarray(rng.normal(0, 0.05, lm_gt.shape),
                                  jnp.float32)
    kf_init = kf_pose.at[1:, :3].add(
        jnp.asarray(rng.normal(0, 0.02, (K - 1, 3)), jnp.float32))
    fixed = jnp.zeros((K,), bool).at[0].set(True)
    return kf_init, kf_valid, lm_init, lm_valid, lm_gen, g, fixed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--devices-per-process", type=int, default=4)
    ap.add_argument("--single", action="store_true")
    args = ap.parse_args(argv)

    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count="
        f"{args.devices_per_process}").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

    from putslam_tpu.parallel import multihost

    if not args.single:
        multihost.initialize_distributed(args.coordinator,
                                         args.num_processes, args.process_id)
    pid, pcount, local, glob = multihost.process_info()

    import numpy as np
    from putslam_tpu.config import tiny_test_config
    from putslam_tpu.parallel import dist_ba

    rng = np.random.default_rng(42)
    kf, kfv, lm, lmv, lmg, g, fixed = build_problem(rng)
    mesh = multihost.global_mesh()
    bcfg = tiny_test_config().backend
    kf_out, lm_out, chi2, overflow = dist_ba.dist_gauss_newton(
        bcfg, mesh, kf, kfv, lm, lmv, g, fixed, lmg)
    # fetch a replicated scalar (addressable on every process)
    chi2_final = float(np.asarray(jax.device_get(chi2))[-1])
    print(json.dumps({
        "process": pid, "process_count": pcount,
        "local_devices": local, "global_devices": glob,
        "chi2_final": chi2_final,
        "partition_overflow": int(overflow),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
