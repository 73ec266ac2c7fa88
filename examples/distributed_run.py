"""Distributed SpMV walkthrough: row partition with halo exchange, the
2-D block partition, and a strong-scaling sweep over whatever devices are
available (a virtual 8-device CPU mesh as written; identical code on real
cards — call `initialize_multihost()` first for several processes).

    python examples/distributed_run.py
"""
import jax

# must run before any backend initialization; on real cards, delete
# these two lines (and call initialize_multihost() first for several
# processes)
try:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
except RuntimeError:
    pass  # backends already up — use whatever devices exist

import numpy as np

from tilespmv_tpu.io import generate
from tilespmv_tpu.parallel import (DistributedSpMV, DistributedSpMV2D,
                                   make_mesh, make_mesh2d)
from tilespmv_tpu.bench.scaling import scaling_sweep


def main(quick: bool = False):
    """`quick` limits the scaling sweep to one device count (used by the
    test suite: each count is a separate shard_map compile on this box)."""
    ndev = len(jax.devices())
    csr = generate.get_matrix("banded_medium")
    x = np.linspace(-1, 1, csr.n).astype(np.float32)
    golden = csr.to_dense().astype(np.float64) @ x

    # 1-D row partition, selective halo exchange (auto falls back to
    # all-gather when packets would not be smaller)
    op = DistributedSpMV(csr, mesh=make_mesh(min(ndev, 8)), x_mode="auto")
    y = np.asarray(op(x))
    err = np.max(np.abs(y - golden) / (1 + np.abs(golden)))
    hp = op.halo
    print(f"1-D ({op.x_mode}): devices={min(ndev, 8)} err={err:.2e}"
          + (f"  halo packets={hp.max_pk} blocks/pair, "
             f"{hp.traffic_ratio:.2f}x of all-gather bytes" if hp else ""))

    # 2-D block partition: x sharded by columns (zero exchange), y
    # reduced with one psum over the column axis
    if ndev >= 4:
        op2 = DistributedSpMV2D(csr, mesh=make_mesh2d(2, 2))
        y2 = np.asarray(op2(x))
        err2 = np.max(np.abs(y2 - golden) / (1 + np.abs(golden)))
        print(f"2-D (2x2 blocks): err={err2:.2e}")

    # strong scaling (absolute numbers only meaningful on real chips)
    print("strong scaling:")
    counts = [d for d in (1, 2, 4, 8) if d <= ndev]
    scaling_sweep(csr, device_counts=counts[-1:] if quick else counts)


if __name__ == "__main__":
    main()
