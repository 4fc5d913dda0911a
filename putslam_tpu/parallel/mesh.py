"""Device-mesh creation and sharded multi-session VO.

The reference has no distributed execution at all (4 POSIX threads + mutexes,
SURVEY §2 "Parallelism"); this module introduces the parallelism
axes mandated by BASELINE.json: data parallelism over concurrent SLAM
sessions/frames here, and model/graph sharding for distributed BA in
``parallel/dist_ba.py``.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from putslam_tpu.config import SlamConfig
from putslam_tpu.models import vo as vo_mod


def make_mesh(n_devices: Optional[int] = None, axis: str = "session") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def vo_sessions_sharded(cfg: SlamConfig, mesh: Mesh, grays: jnp.ndarray,
                        depths: jnp.ndarray, seed: int = 0):
    """Run B independent VO sessions, one shard per device along the
    ``session`` axis (multi-session mapping = the stretch config in
    BASELINE.json; each session is a full vo_sequence scan).

    grays/depths: (B, T, H, W). Returns poses (B, T, 7).
    """
    axis = mesh.axis_names[0]
    data_sharding = NamedSharding(mesh, P(axis))

    grays = jax.device_put(grays, data_sharding)
    depths = jax.device_put(depths, data_sharding)
    keys = jax.device_put(
        jax.random.split(jax.random.PRNGKey(seed), grays.shape[0]), data_sharding
    )

    @functools.partial(jax.jit, out_shardings=NamedSharding(mesh, P(axis)))
    def run(g, d, k):
        def one(gi, di, ki):
            poses, _ = vo_mod.vo_sequence(cfg, gi, di, ki)
            return poses

        return jax.vmap(one)(g, d, k)

    return run(grays, depths, keys)
