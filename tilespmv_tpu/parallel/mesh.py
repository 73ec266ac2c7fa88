"""Device mesh helpers.

The reference is single-GPU (SURVEY.md §2.3); distribution is a new
subsystem: a 1-D (or 2-D) logical mesh over a plain list of devices, with
the tile grid row-partitioned along the "row" axis and x exchanged via
collectives. The mesh follows the algorithm, not the wiring: on cards
joined all to all (NVLink) every pair is equidistant.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


ROW_AXIS = "row"
COL_AXIS = "col"


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = (ROW_AXIS,)) -> Mesh:
    """1-D mesh over the first `n_devices` devices (default: all)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    if len(axis_names) == 1:
        return Mesh(np.array(devs[:n]), axis_names)
    raise ValueError("make_mesh is 1-D; use make_mesh2d")


def make_mesh2d(rows: int, cols: int,
                axis_names: Sequence[str] = (ROW_AXIS, COL_AXIS)) -> Mesh:
    """2-D (rows x cols) mesh for block-partitioned SpMV."""
    devs = jax.devices()
    if rows * cols > len(devs):
        raise ValueError(
            f"requested {rows}x{cols} devices, have {len(devs)}")
    grid = np.array(devs[: rows * cols]).reshape(rows, cols)
    return Mesh(grid, axis_names)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Bring up the multi-process JAX runtime before building meshes.

    Thin wrapper over `jax.distributed.initialize`. Where no cluster
    manager describes the job, pass all three arguments
    (`coordinator_address="localhost:<port>"` for processes on one host).
    After this, `jax.devices()` spans every process and
    `make_mesh`/`make_mesh2d` lay blocks across them; the same SPMD
    programs run unchanged.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
