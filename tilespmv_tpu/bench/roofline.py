"""Per-device roofline table.

The reference reports GFLOPS = 2*nnz/t (tilespmv_cuda.h:1138) and the CSR5
driver adds a bandwidth figure GB/s = bytes(m,nnz)/t
(external/CSR5_cuda/detail/utils.h:10-20). SpMV is bound by device-memory
bandwidth, so the meaningful per-device figure is the share of peak
bandwidth the product sustains.

Peaks are keyed by `jax.Device.device_kind`. A device that is not in the
table is an error, never a default; the CPU has no roofline (None).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax


class Peak(NamedTuple):
    hbm_gbps: float        # device-memory bandwidth, GB/s
    fp32_gflops: float     # float32 outside the tensor cores
    fp64_gflops: float     # float64 outside the tensor cores
    source: str


_H100_SXM = Peak(hbm_gbps=3350.0, fp32_gflops=67e3, fp64_gflops=34e3,
                 source="NVIDIA H100 Tensor Core GPU data sheet, SXM5 "
                        "column (dense, 700 W)")

PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def peak_for(device: Optional[jax.Device] = None) -> Optional[Peak]:
    """The published peaks of `device` (default: the first JAX device);
    None on the CPU. Raises KeyError for an accelerator not in PEAKS."""
    dev = device if device is not None else jax.devices()[0]
    if dev.platform == "cpu":
        return None
    try:
        return PEAKS[dev.device_kind]
    except KeyError:
        raise KeyError(
            f"no roofline entry for device kind {dev.device_kind!r} "
            f"({dev.platform}); add its published peaks to "
            "bench/roofline.py::PEAKS") from None
