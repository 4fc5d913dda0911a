#!/usr/bin/env python
"""Measured dist-BA scaling on the virtual CPU mesh at fr1 capacities.

docs/SCALING.md once derived 2-host efficiency from single-device timings
and network arithmetic only. This tool MEASURES the sharded
solver per-GN-iteration at fr1 capacities (K=256, L=8192, M=8192) on
1/2/4/8 virtual CPU devices (XLA:CPU executes the same shard_map program
with real collectives over shared memory — the scaling SHAPE, i.e. how the
per-device assembly work and the psum payload divide, is the measurement;
absolute times are CPU times, not device times, and are labeled as such).

Usage:  python tools/measure_scaling.py [--json-out results/scaling.json]
(self-re-executes with XLA_FLAGS to get the 8-device host platform)
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CAPS = dict(K=256, L=8192, M=8192, E=1024)


def run_measurement(json_out):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from putslam_tpu.backend import graph as graph_mod
    from putslam_tpu.config import BackendConfig
    from putslam_tpu.geometry import se3
    from putslam_tpu.parallel import dist_ba, mesh as mesh_mod

    K, L, M = CAPS["K"], CAPS["L"], CAPS["M"]
    rng = np.random.default_rng(7)
    kf_pose = jnp.asarray(
        np.concatenate([rng.normal(0, 0.1, (K, 3)),
                        np.tile([1.0, 0, 0, 0], (K, 1))], -1)
        .astype(np.float32))
    lm_pos = jnp.asarray(rng.normal(0, 1.0, (L, 3)).astype(np.float32)
                         + np.array([0, 0, 3], np.float32))
    g = graph_mod.init_graph(M, CAPS["E"])
    okf = jnp.asarray(rng.integers(0, K, M), jnp.int32)
    olm = jnp.asarray(rng.integers(0, L, M), jnp.int32)
    z = se3.apply(se3.inverse(kf_pose[okf]), lm_pos[olm])
    g = graph_mod.add_observations(g, okf, olm, z, jnp.full((M,), 100.0),
                                   jnp.ones((M,), bool))
    fixed = jnp.zeros((K,), bool).at[0].set(True)
    lm_gen = jnp.zeros((L,), jnp.int32)

    ITERS_A, ITERS_B = 2, 6          # marginal slope cancels fixed overhead
    rows = []
    for ndev in (1, 2, 4, 8):
        devs = jax.devices()[:ndev]
        from jax.sharding import Mesh
        mesh = Mesh(np.array(devs), ("lm",))
        times = {}
        for iters in (ITERS_A, ITERS_B):
            bcfg = BackendConfig(gn_iterations=iters, damping=1e-5,
                                 chi2_ratio_termination=0.0)
            kf_o, lm_o, chi2, ovf = dist_ba.dist_gauss_newton(
                bcfg, mesh, kf_pose, jnp.ones((K,), bool), lm_pos,
                jnp.ones((L,), bool), g, fixed, lm_gen)
            jax.block_until_ready(kf_o)          # compile + warm
            best = 1e9
            for _ in range(3):
                t0 = time.time()
                kf_o, lm_o, chi2, ovf = dist_ba.dist_gauss_newton(
                    bcfg, mesh, kf_pose, jnp.ones((K,), bool), lm_pos,
                    jnp.ones((L,), bool), g, fixed, lm_gen)
                jax.block_until_ready(kf_o)
                best = min(best, time.time() - t0)
            times[iters] = best
            assert int(ovf) == 0
        per_iter = (times[ITERS_B] - times[ITERS_A]) / (ITERS_B - ITERS_A)
        rows.append({"ndev": ndev, "per_gn_iter_ms": round(1e3 * per_iter, 2)})
        print(f"ndev={ndev}: {rows[-1]['per_gn_iter_ms']} ms/GN-iter "
              f"(call@{ITERS_A}it {1e3*times[ITERS_A]:.1f} ms)", flush=True)

    t1 = rows[0]["per_gn_iter_ms"]
    for r in rows:
        r["speedup"] = round(t1 / max(r["per_gn_iter_ms"], 1e-9), 2)
        r["efficiency_pct"] = round(100 * r["speedup"] / r["ndev"], 1)
    out = {"platform": "cpu-virtual-mesh", "capacities": CAPS, "rows": rows,
           "note": "scaling SHAPE on XLA:CPU shard_map with real "
                   "collectives; absolute ms are CPU, not device times"}
    print(json.dumps(out))
    if json_out:
        with open(json_out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--inner", action="store_true")
    args = ap.parse_args(argv)
    if not args.inner:
        env = dict(os.environ)
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + " --xla_force_host_platform_device_count=8")
        cmd = [sys.executable, os.path.abspath(__file__), "--inner"]
        if args.json_out:
            cmd += ["--json-out", args.json_out]
        return subprocess.call(cmd, env=env)
    return run_measurement(args.json_out)


if __name__ == "__main__":
    sys.exit(main())
