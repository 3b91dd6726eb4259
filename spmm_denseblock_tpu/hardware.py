"""Published peaks of the accelerators this library is measured on.

One table, keyed by `device_kind` as JAX reports it
(`jax.devices()[0].device_kind`). A device that is not in the table is an
error, not a default: a roofline share or a link model against the wrong
card's peaks would be a wrong number.

Source: NVIDIA H100 Tensor Core GPU data sheet (SXM5 part; dense rates,
no structured sparsity) and the NVIDIA Hopper architecture white paper.
The rates assume the card's full 700 W power limit; a card set below it
cannot hold its top clock under a matrix-heavy load, so every measured
number is reported beside the card's power limit.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DeviceSpec:
    name: str
    flops_f32: float    # IEEE f32, CUDA cores (no tensor cores)
    flops_tf32: float   # tensor cores
    flops_bf16: float   # tensor cores, f32 accumulate
    ops_int8: float     # tensor cores, int32 accumulate
    hbm_bytes_per_s: float
    link_bytes_per_s: float  # NVLink to another card, each way


H100_SXM = DeviceSpec(
    name="H100 SXM",
    flops_f32=67e12,
    flops_tf32=495e12,
    flops_bf16=989e12,
    ops_int8=1979e12,
    hbm_bytes_per_s=3.35e12,
    link_bytes_per_s=450e9,  # 900 GB/s total, all to all
)

DEVICES = {
    "NVIDIA H100 80GB HBM3": H100_SXM,
}

# The card the analytic models default to.
DEFAULT_KIND = "NVIDIA H100 80GB HBM3"


def device_spec(kind: str) -> DeviceSpec:
    """Peaks for a `device_kind`; raises KeyError for an unknown one."""
    try:
        return DEVICES[kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device_kind {kind!r}; known: "
            f"{sorted(DEVICES)} (add it to spmm_denseblock_tpu/hardware.py "
            "with its data-sheet source)"
        ) from None
