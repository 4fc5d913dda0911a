"""Multi-host runtime scaffolding.

The reference is strictly single-process (SURVEY §5: no NCCL/MPI/Gloo
anywhere). Scaling beyond one host follows the JAX recipe:

* every process calls :func:`initialize_distributed`
  (``jax.distributed.initialize`` with an explicit coordinator address,
  process count and process id) so all hosts join one runtime,
* a **global** mesh is built over ``jax.devices()`` — which, after
  initialization, lists every device on every host,
* the existing sharded computations (``parallel/dist_ba.py``,
  ``parallel/mesh.py``) run unchanged over that mesh: collectives ride
  NVLink between the cards of one host and the network across hosts; the
  only cross-host payload in distributed BA is the psum of the (K·6)²
  reduced camera system, independent of the map size.

The 2-process CPU dryrun (``tools/multihost_dryrun.py``,
``tests/test_multihost.py``) validates exactly this path on one machine:
two OS processes × N virtual CPU devices form a 2N-device global mesh and
must reproduce the single-process BA result bit-for-bit-close.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           local_device_ids: Optional[Sequence[int]] = None
                           ) -> bool:
    """Join (or skip) the multi-process JAX runtime.

    Call before any other JAX API in every process, with the coordinator's
    ``host:port``, the process count and this process's id — nothing on a
    GPU host discovers them. With ``num_processes in (None, 0, 1)`` this is
    a no-op returning False — single-process runs pay nothing. Returns True
    when a multi-process runtime was initialized.
    """
    if num_processes is None or num_processes <= 1:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process run needs coordinator_address and "
                         "process_id")
    import jax

    kwargs = dict(coordinator_address=coordinator_address,
                  num_processes=num_processes, process_id=process_id)
    if local_device_ids is not None:
        kwargs["local_device_ids"] = list(local_device_ids)
    jax.distributed.initialize(**kwargs)
    return True


def global_mesh(axis_name: str = "lm"):
    """1-D mesh over every device of every joined process (the landmark-block
    axis of distributed BA). The cards of one host are joined all to all, so
    the mesh follows the algorithm alone."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis_name,))


def process_info():
    """(process_index, process_count, local_devices, global_devices)."""
    import jax

    return (jax.process_index(), jax.process_count(),
            len(jax.local_devices()), len(jax.devices()))
