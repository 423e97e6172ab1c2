"""Multi-host initialization for the distributed BA / engine path.

The reference has no distributed computing at all (4 pthreads over shared
memory, SURVEY §2.3); scale-out across HOSTS is this build's own
deliverable (BASELINE "N>=2 hosts" leg): `jax.distributed.initialize`
joins the processes into one runtime, `jax.devices()` then spans every
host's devices, and the same `jax.sharding.Mesh` + shard_map/GSPMD code
paths run within a host and across hosts — no separate communication
backend: XLA inserts the collectives the mesh needs (NCCL on GPUs).

Wiring:
  * programmatic: `multihost.initialize(coordinator, num_processes,
    process_id)` before any other JAX call;
  * environment-driven (what `scripts/run_kitti.py --distributed` uses):
    SSVIO_COORDINATOR=host:port  SSVIO_NUM_PROCESSES=N  SSVIO_PROCESS_ID=k
    (or the standard JAX env/cluster auto-detection when present).

Tested by tests/test_multihost.py: two OS processes, CPU backend, a
global 2x<local devices> mesh, landmark-sharded BA via
parallel.dist_ba — the cross-process analog of the virtual-mesh single-process
tests (SURVEY §4d).
"""

from __future__ import annotations

import os
from typing import Optional

ENV_COORD = "SSVIO_COORDINATOR"
ENV_NPROC = "SSVIO_NUM_PROCESSES"
ENV_PID = "SSVIO_PROCESS_ID"


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Join this process into a multi-host JAX runtime.

    Arguments default to the SSVIO_* environment variables; with none
    present, falls back to `jax.distributed.initialize()`'s own cluster
    auto-detection (SLURM/GKE env), and returns False if that is
    unavailable (single-process run). Must run before the backend is
    first used. Returns True when a distributed runtime was initialized.
    """
    import jax

    coordinator = coordinator or os.environ.get(ENV_COORD)
    if num_processes is None and os.environ.get(ENV_NPROC):
        num_processes = int(os.environ[ENV_NPROC])
    if process_id is None and os.environ.get(ENV_PID):
        process_id = int(os.environ[ENV_PID])

    if coordinator is not None:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
        return True
    try:
        # cluster auto-detection (raises without a recognized environment)
        jax.distributed.initialize()
        return True
    except Exception:
        return False


def global_mesh(axis_name: str = "lm"):
    """1-D mesh over ALL devices of the (possibly multi-host) runtime.
    XLA places the collectives (NCCL on GPUs)."""
    from ssvio_tpu.parallel import dist_ba
    import jax
    return dist_ba.make_mesh(jax.devices(), axis_name)


def process_index() -> int:
    import jax
    return jax.process_index()


def is_primary() -> bool:
    """True on the process that should own host-side singletons (keyframe
    records, loop-closing host driver, trajectory export)."""
    return process_index() == 0
