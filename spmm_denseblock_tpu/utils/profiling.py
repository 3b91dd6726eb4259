"""Profiling & observability — the aux subsystem the reference covers
with CUDA events, cudaProfilerStart/Stop markers and Nsight Compute
recipes (SURVEY.md §5.1; /root/reference/clang_omp.sh:40-43).

JAX equivalents:
- `trace(logdir)`: jax.profiler context — open the dump with
  TensorBoard/XProf for the device kernel timeline Nsight gave.
- `annotate(name)`: TraceAnnotation, the cudaProfiler marker analog.
- `device_info()`: device kind / memory / counts for bench records.
- `roofline(flops, bytes, secs)`: achieved intensity + rates; feed it
  per-chip peaks to get fraction-of-peak.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import jax


@contextlib.contextmanager
def trace(logdir: str, host: bool = False):
    """Capture a device trace viewable in TensorBoard/XProf."""
    jax.profiler.start_trace(logdir, create_perfetto_link=False)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Scoped trace annotation (shows up on the trace timeline)."""
    return jax.profiler.TraceAnnotation(name)


def device_info() -> Dict:
    devs = jax.devices()
    d = devs[0]
    info = {
        "backend": jax.default_backend(),
        "n_devices": len(devs),
        "platform": d.platform,
        "device_kind": getattr(d, "device_kind", "unknown"),
    }
    stats = None
    try:
        stats = d.memory_stats()
    except Exception:
        pass
    if stats:
        info["bytes_limit"] = stats.get("bytes_limit")
        info["bytes_in_use"] = stats.get("bytes_in_use")
    return info


def roofline(
    flops: float,
    bytes_moved: float,
    secs: float,
    peak_flops: Optional[float] = None,
    peak_bw: Optional[float] = None,
) -> Dict:
    """Achieved rates + (optionally) fraction of the machine roofline."""
    out = {
        "gflops": flops / secs / 1e9,
        "gb_s": bytes_moved / secs / 1e9,
        "intensity_flop_per_byte": flops / max(bytes_moved, 1.0),
        "ms": secs * 1e3,
    }
    if peak_flops and peak_bw:
        ridge = peak_flops / peak_bw
        bound = "compute" if out["intensity_flop_per_byte"] >= ridge else "memory"
        attainable = min(peak_flops, peak_bw * out["intensity_flop_per_byte"])
        out.update(
            bound=bound,
            frac_of_roofline=(flops / secs) / attainable,
        )
    return out
