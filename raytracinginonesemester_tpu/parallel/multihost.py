"""Multi-host orchestration.

The reference is strictly single-process (SURVEY §2: no MPI/NCCL/
sockets anywhere); multi-host scale-out is the new framework's mandated
axis.  This module wraps ``jax.distributed`` initialization and builds
host-by-device meshes whose *inner* axis stays inside one host (NVLink
between its cards) and whose *outer* axis spans hosts over the network —
the layout rule that keeps hit merges off the slow network.

On a single host everything degrades to the local-device mesh, so the
same render entry point works everywhere.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["initialize_multihost", "host_chip_mesh", "is_multihost"]


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize ``jax.distributed`` when running under a multi-host
    launcher; no-op (returns False) for single-process runs.

    Arguments default to the standard env vars
    (``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``
    or a cluster launcher's automatic configuration).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env else None

    if coordinator_address is None and num_processes in (None, 1):
        return False  # single process

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def is_multihost() -> bool:
    return jax.process_count() > 1


def host_chip_mesh(
    axis_names: Tuple[str, str] = ("data", "model"),
    model_parallel_per_host: int = 1,
) -> Mesh:
    """Mesh shaped (hosts * chips/host / mp, mp).

    The model axis is confined to one host's devices so its
    all_gather/psum hit merges stay on the intra-host links; the data
    axis (pure pixel parallelism, no communication) spans hosts.
    """
    devices = np.array(jax.devices())
    n = devices.size
    mp = model_parallel_per_host
    per_host = max(1, n // max(1, jax.process_count()))
    if mp > per_host or per_host % mp:
        raise ValueError(
            f"model_parallel_per_host={mp} must divide chips/host={per_host}"
        )
    return Mesh(devices.reshape(n // mp, mp), axis_names)
