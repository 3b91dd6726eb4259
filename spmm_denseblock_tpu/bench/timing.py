"""Host-clock timing of a device call.

JAX returns before the device has finished, so every timed call ends in
`jax.block_until_ready`. Warm-up calls compile and are not timed. The
reference times one call between CUDA events
(/root/reference/run_csrmm.cu:125-151); the host clock around a
synchronised call is the JAX analog.
"""

from __future__ import annotations

import time
from typing import Callable

import jax


def time_call(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> dict:
    """Time `iters` calls of fn(*args) after `warmup` untimed ones.

    Returns {"secs": median, "secs_min", "secs_max", "repeats"}."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    mid = len(times) // 2
    median = times[mid] if len(times) % 2 else 0.5 * (times[mid - 1] + times[mid])
    return {
        "secs": median,
        "secs_min": times[0],
        "secs_max": times[-1],
        "repeats": iters,
    }
