"""Multi-host setup helpers.

The reference is single-process (SURVEY.md §2.7); this module carries the
N>=2-hosts story from BASELINE.json. The runtime model is JAX
multi-controller SPMD: every host runs the SAME program, sees the global
mesh, and owns its local shard of every distributed array.

Launch pattern (per host; on GPU hosts nothing discovers the peers, so
the coordinator, process count and this host's id are spelled out):

    python -c "
    from spmm_denseblock_tpu.parallel.multihost import initialize, pod_mesh
    initialize("host0:12345", num_processes=2, process_id=0)
    mesh = pod_mesh()                 # ('row','col') over ALL devices
    ... same single-host code: dist_bsr_spmm_plan(bsr, mesh=mesh) ...
    "

Design notes for the sparse layer specifically:
- The reordering permutation is computed host-side and is DETERMINISTIC
  (seeded, see reorder/), so every host derives the same permutation
  from the same graph file — no broadcast needed; this mirrors the
  reference's replicate-preprocessing-per-run discipline.
- `shard_bsr` slices by block-row stripe; with a global mesh each host
  device_puts only its addressable stripes (jax.device_put with a
  NamedSharding over the global mesh does exactly this).
- Collectives in parallel/spmm.py are mesh-axis collectives: within a
  host they ride NVLink, across hosts the network, chosen by XLA and
  NCCL from the mesh — nothing in the SpMM code changes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

# jax.distributed.initialize must run before ANY backend-touching JAX
# call, so we cannot probe jax.process_count() to detect prior init
# (the probe itself initializes the backend).  Track it ourselves and
# additionally tolerate the "already initialized" error for the case
# where the caller ran initialize() through another code path.
_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """jax.distributed.initialize with explicit coordinator arguments.

    Each argument falls back to the environment (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID); all three are required."""
    import os

    global _initialized
    if _initialized:
        return
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            "multi-host initialize needs coordinator_address, num_processes "
            "and process_id (or JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES "
            "/ JAX_PROCESS_ID)"
        )
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        # Re-raise unless this is the benign double-init case.
        if "already initialized" not in str(e).lower():
            raise
    _initialized = True


def pod_mesh(
    row_parallelism: Optional[int] = None,
    axis_names: Tuple[str, str] = ("row", "col"),
) -> Mesh:
    """2D mesh over ALL devices of all hosts (every process must call
    this with the same arguments). row_parallelism defaults to the
    device count (pure stripe parallelism, col=1)."""
    devs = jax.devices()  # global across processes
    n = len(devs)
    rows = row_parallelism or n
    if n % rows != 0:
        raise ValueError(f"{n} devices not divisible by row_parallelism={rows}")
    return Mesh(np.asarray(devs).reshape(rows, n // rows), axis_names)


def is_coordinator() -> bool:
    return jax.process_index() == 0
