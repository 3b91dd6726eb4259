"""Communication-volume model for the distributed SpMM strategies.

Why this exists: single-host CPU-mesh benchmarks CANNOT demonstrate
interconnect scaling — all N virtual devices share the same cores (total
compute is fixed) and XLA:CPU emulates collectives through shared
memory, so their cost model is unrelated to a multi-card host's. What a
CPU mesh CAN validate is correctness, partitioning overhead, and
total-throughput retention. The multi-card efficiency claim therefore
needs the link arithmetic made explicit — this module is that arithmetic
(compare per-device compute time against per-device collective bytes
over link bandwidth).

Hardware constants come from the `device_kind`-keyed table in
spmm_denseblock_tpu/hardware.py (default: H100 SXM, whose NVLink joins
every card of the host to every other at 450 GB/s each way). The model
has not been fitted to a multi-card measurement yet.

Per-call, per-device bytes for C = A @ B, A row-striped over n devices,
B row-sharded (K x F, dtype s bytes):

  allgather — every device RECEIVES the other shards of B once:
              (n-1)/n * K * F * s        (one tiled all-gather)
  ring      — same total volume, moved in n-1 neighbor ppermute steps of
              K/n * F * s each; each step overlaps the previous chunk's
              block GEMMs (the double-buffered schedule).
  halo      — only 2*halo neighbor chunks ever move:
              2*halo/n * K * F * s       (O(1) in n; needs bandedness)

Per-device compute: 2 * (nnzb/n) * b^2 * F flops.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from spmm_denseblock_tpu.hardware import DEFAULT_KIND, device_spec


def _peak(spec, dtype_flops: str) -> float:
    return spec.flops_bf16 if dtype_flops == "bf16" else spec.flops_f32


def comms_bytes_per_device(
    strategy: str, n: int, K: int, F: int, itemsize: int = 4, halo: int = 1
) -> float:
    """Bytes RECEIVED per device per SpMM call (send volume is equal)."""
    total_b = K * F * itemsize
    if n <= 1:
        return 0.0
    if strategy == "allgather":
        return (n - 1) / n * total_b
    if strategy == "ring":
        return (n - 1) / n * total_b  # n-1 steps of K/n rows each
    if strategy == "halo":
        return min(2 * halo, n - 1) / n * total_b
    raise ValueError(strategy)


def efficiency_model(
    strategy: str,
    n: int,
    nnzb: int,
    b: int,
    K: int,
    F: int,
    itemsize: int = 4,
    halo: int = 1,
    device_kind: str = DEFAULT_KIND,
    dtype_flops: str = "f32",
    overlap: bool = True,
) -> Dict:
    """Predicted scaling efficiency on real hardware.

    efficiency = T_comp / max(T_comp, T_comm) when the schedule overlaps
    communication with compute (ring/halo; XLA also overlaps the single
    all-gather with the first GEMMs when it can), else
    T_comp / (T_comp + T_comm).

    Returns the full term breakdown so artifacts can record the model
    next to the measurement."""
    spec = device_spec(device_kind)
    t_comp = (2.0 * nnzb / max(n, 1) * b * b * F) / _peak(spec, dtype_flops)
    bytes_dev = comms_bytes_per_device(strategy, n, K, F, itemsize, halo)
    t_comm = bytes_dev / spec.link_bytes_per_s
    if overlap:
        t_total = max(t_comp, t_comm)
    else:
        t_total = t_comp + t_comm
    eff = t_comp / t_total if t_total else 1.0
    return {
        "strategy": strategy,
        "n": n,
        "t_comp_us": t_comp * 1e6,
        "t_comm_us": t_comm * 1e6,
        "bytes_per_device": bytes_dev,
        "efficiency": eff,
        "device": spec.name,
    }


def min_nnzb_for_efficiency(
    strategy: str,
    n: int,
    b: int,
    K: int,
    F: int,
    target: float = 0.8,
    itemsize: int = 4,
    halo: int = 1,
    device_kind: str = DEFAULT_KIND,
    dtype_flops: str = "f32",
) -> int:
    """Smallest total nnzb for which the model predicts >= target
    efficiency (with overlap, efficiency hits 1.0 exactly when
    T_comp >= T_comm; the target shapes the non-overlapped reserve)."""
    spec = device_spec(device_kind)
    bytes_dev = comms_bytes_per_device(strategy, n, K, F, itemsize, halo)
    t_comm = bytes_dev / spec.link_bytes_per_s
    # T_comp >= target * t_comm  (overlap model)
    need_flops_dev = t_comm * target * _peak(spec, dtype_flops)
    nnzb_dev = need_flops_dev / (2.0 * b * b * F)
    return int(np.ceil(nnzb_dev * n)) if nnzb_dev else 0
