"""Device mesh helpers.

The reference is single-GPU (SURVEY.md §2.7) — this layer has no
counterpart there. Axis convention:

  "row"  — partitions the sparse matrix A by block-row ranges (each device
           owns a horizontal stripe of A and the matching stripe of C).
  "col"  — partitions the dense operand's feature dimension (tensor
           parallelism for the model layer weights).

The mesh follows the algorithm, not a topology: NVLink joins every card
of a host to every other at the same rate, so any device order serves
the ppermute ring in parallel/spmm.py.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = ("row", "col"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """2D mesh over the available devices; defaults to (n_devices, 1)."""
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devices), 1)
    n = shape[0] * shape[1]
    if n > len(devices):
        raise ValueError(f"mesh {shape} needs {n} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:n]).reshape(shape), axis_names)


def make_mesh_1d(
    n: Optional[int] = None, axis: str = "row", devices: Optional[Sequence] = None
) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    if n is None:
        n = len(devices)
    return Mesh(np.asarray(devices[:n]), (axis,))


def row_sharding(mesh: Mesh, axis: str = "row") -> NamedSharding:
    """Shard the leading dim over `axis`, replicate the rest."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
