"""Distributed tiled SpMV: row-partitioned tile grid over a device mesh.

New subsystem with no reference counterpart (the reference is single-GPU,
SURVEY.md §2.3). Design:

* The row space is split into `ndev` contiguous, tile-aligned blocks; each
  block is converted and planned independently (the per-device work is a
  complete single-chip TileSpMV problem).
* Per-device plans are *unified*: every device gets the same set of
  CSR-nnz-class / ELL-width-class engines, padded to the same shapes
  (padding tiles are inert: zero values scattered to block row 0). This
  makes the per-device program identical — pure SPMD — so the stacked plan
  shards with a single `P('row')` prefix spec.
* `shard_map` over the 1-D mesh runs the single-chip engine stack on each
  device's shard. x is either replicated (`x_mode="replicated"`) or sharded
  and reassembled with `jax.lax.all_gather` (`x_mode="allgather"`, the
  default — the all-gather overlaps with the leading engine work under
  XLA's scheduler).
* y comes back sharded by rows (`P('row')`) — no reduction needed, since a
  row block is owned by exactly one device.

This is the analog of how the reference balances work across warps
(tilespmv_cpu.h:68-118) lifted to the chip level: contiguous tile-row
ranges per worker, atomics replaced by ownership.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import DEFAULT_CONFIG, TileConfig
from ..core.convert import tile_create
from ..io.mmio import CSRMatrix
from ..ops.plan import ResidualEngine, SpMVPlan, build_plan
from ..ops.spmv import spmv
from .mesh import ROW_AXIS, make_mesh


def _row_block(csr: CSRMatrix, r0: int, r1: int,
               rows_padded: int) -> CSRMatrix:
    """Rows [r0, r1) of `csr`, re-based to local indices and padded with
    empty rows to `rows_padded`."""
    r1c = max(r0, min(r1, csr.m))
    indptr = csr.indptr[r0: r1c + 1] if r0 <= csr.m else csr.indptr[-1:]
    if indptr.size == 0:
        indptr = csr.indptr[-1:]
    start = int(indptr[0])
    stop = int(indptr[-1])
    local_ptr = (indptr - start).astype(np.int64)
    pad_rows = rows_padded - (local_ptr.size - 1)
    if pad_rows > 0:
        local_ptr = np.concatenate(
            [local_ptr, np.full(pad_rows, local_ptr[-1], np.int64)])
    return CSRMatrix((rows_padded, csr.n), local_ptr,
                     csr.indices[start:stop], csr.data[start:stop])


def _pad_leading(a: jax.Array, target: int) -> jax.Array:
    if a.shape[0] == target:
        return a
    pad = [(0, target - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return jnp.pad(a, pad)


def _pad_residual(e: ResidualEngine, target: int) -> ResidualEngine:
    """Pad a residual engine with zero-valued entries at the last local
    row (keeps rows sorted so segment sums stay valid)."""
    n0 = e.val.shape[0]
    if n0 == target:
        return e
    last_row = e.row[-1] if n0 else jnp.zeros((), jnp.int32)
    return ResidualEngine(
        val=_pad_leading(e.val, target),
        row=jnp.concatenate(
            [e.row, jnp.full(target - n0, last_row, jnp.int32)]),
        col=_pad_leading(e.col, target))


def _unify_plans(plans: list[SpMVPlan]) -> list[SpMVPlan]:
    """Give every plan the same treedef and leaf shapes (see module doc)."""
    from ..ops.plan import (ColEngine, CsrEngine, DenseEngine, EllEngine,
                            ResidualEngine, RowEngine)
    cdt = plans[0].dense.val.dtype

    def unify_simple(get, rebuild):
        target = max(get(p).val.shape[0] for p in plans)
        target = max(target, 8)
        out = []
        for p in plans:
            e = get(p)
            out.append(rebuild(e, target))
        return out

    denses = unify_simple(
        lambda p: p.dense,
        lambda e, t: DenseEngine(val=_pad_leading(e.val, t),
                                 tilerow=_pad_leading(e.tilerow, t),
                                 tilecol=_pad_leading(e.tilecol, t)))
    rows_ = unify_simple(
        lambda p: p.rows,
        lambda e, t: RowEngine(val=_pad_leading(e.val, t),
                               grow=_pad_leading(e.grow, t),
                               tilecol=_pad_leading(e.tilecol, t)))
    cols_ = unify_simple(
        lambda p: p.cols,
        lambda e, t: ColEngine(val=_pad_leading(e.val, t),
                               gcol=_pad_leading(e.gcol, t),
                               tilerow=_pad_leading(e.tilerow, t)))

    b = plans[0].tile_size
    # union of ELL width classes / CSR nnz classes across devices
    ell_widths = sorted({e.val.shape[1] for p in plans for e in p.ells})
    csr_ws = sorted({e.val.shape[1] for p in plans for e in p.csrs})

    def unified_ells(p):
        by_w = {e.val.shape[1]: e for e in p.ells}
        out = []
        for w in ell_widths:
            nt = max(max((e2.val.shape[0] for p2 in plans
                          for e2 in p2.ells if e2.val.shape[1] == w),
                         default=8), 8)
            e = by_w.get(w)
            if e is None:
                out.append(EllEngine(
                    val=jnp.zeros((nt, w, b), cdt),
                    col=jnp.zeros((nt, w, b), jnp.uint8),
                    tilerow=jnp.zeros(nt, jnp.int32),
                    tilecol=jnp.zeros(nt, jnp.int32)))
            else:
                out.append(EllEngine(
                    val=_pad_leading(e.val, nt),
                    col=_pad_leading(e.col, nt),
                    tilerow=_pad_leading(e.tilerow, nt),
                    tilecol=_pad_leading(e.tilecol, nt)))
        return tuple(out)

    def unified_csrs(p):
        by_w = {e.val.shape[1]: e for e in p.csrs}
        out = []
        for w in csr_ws:
            nt = max(max((e2.val.shape[0] for p2 in plans
                          for e2 in p2.csrs if e2.val.shape[1] == w),
                         default=8), 8)
            e = by_w.get(w)
            if e is None:
                out.append(CsrEngine(
                    val=jnp.zeros((nt, w), cdt),
                    rowcol=jnp.zeros((nt, w), jnp.uint8),
                    tilerow=jnp.zeros(nt, jnp.int32),
                    tilecol=jnp.zeros(nt, jnp.int32)))
            else:
                out.append(CsrEngine(
                    val=_pad_leading(e.val, nt),
                    rowcol=_pad_leading(e.rowcol, nt),
                    tilerow=_pad_leading(e.tilerow, nt),
                    tilecol=_pad_leading(e.tilecol, nt)))
        return tuple(out)

    res_n = max(max(p.residual.val.shape[0] for p in plans), 8)

    def unified_residual(p):
        return _pad_residual(p.residual, res_n)

    total_nnz = sum(p.nnz for p in plans)
    out = []
    for i, p in enumerate(plans):
        out.append(SpMVPlan(
            dense=denses[i], rows=rows_[i], cols=cols_[i],
            ells=unified_ells(p), csrs=unified_csrs(p),
            residual=unified_residual(p),
            m=p.m, n=p.n, tilem=p.tilem, tilen=p.tilen,
            tile_size=p.tile_size,
            nnz=total_nnz,  # uniform static metadata across shards
        ))
    return out


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Selective x-exchange plan (SURVEY.md §2.3): which 128-value x
    blocks each device must receive from each peer, derived from the
    per-partition set of occupied columns.

    Each shard's matrix is *column-renumbered* into a compact local x
    layout — [its own x2d rows ++ one `max_pk`-row packet segment per
    peer] — so the runtime is a sender-side row gather + one all-to-all
    + a concat: spans stay contiguous, no scatter."""
    rx: int              # own x2d rows per device
    max_pk: int          # packet rows per (src, dst) pair (padded)
    n_x_pad: int         # padded global x length (ndev * rx * 128)
    traffic_ratio: float  # halo bytes / all-gather bytes (per device)
    send_idx: np.ndarray  # (ndev, ndev*max_pk) local x2d rows to send
    local_blocks: list    # per-shard CSRMatrix over the OWN x segment
    foreign_blocks: list  # per-shard CSRMatrix over the packet segments
                          # (split so the all-to-all overlaps with the
                          # local-columns compute, SURVEY §5)


def _plan_halo(blocks: list, n: int, ndev: int) -> HaloPlan:
    XB = 128
    rx = max(1, -(-n // (ndev * XB)))
    n_x_pad = ndev * rx * XB
    # needed foreign blocks per (dst, src)
    need = []
    for d, blk in enumerate(blocks):
        gb = np.unique(blk.indices.astype(np.int64) >> 7)
        need.append(gb)
    per_pair = [[need[d][(need[d] // rx) == e] for e in range(ndev)]
                for d in range(ndev)]
    max_pk = max((pp.shape[0] for d in range(ndev)
                  for e, pp in enumerate(per_pair[d]) if e != d),
                 default=0)
    max_pk = max(max_pk, 1)
    # sender side: device e sends to d the blocks per_pair[d][e]
    send_idx = np.zeros((ndev, ndev * max_pk), np.int32)
    for e in range(ndev):
        for d in range(ndev):
            if d == e:
                continue
            loc = (per_pair[d][e] - e * rx).astype(np.int32)
            send_idx[e, d * max_pk: d * max_pk + loc.shape[0]] = loc
    # compact column map per shard: own rows first, then peer segments.
    # The matrix splits into a local part (own columns, computable before
    # the exchange lands) and a foreign part (packet columns).
    local_blocks, foreign_blocks = [], []
    n_own = rx * XB
    n_c = (rx + ndev * max_pk) * XB
    for d, blk in enumerate(blocks):
        cmap = np.full(ndev * rx, -1, np.int64)
        own = np.arange(d * rx, (d + 1) * rx)
        cmap[own] = np.arange(rx)
        for e in range(ndev):
            if e == d:
                continue
            gb = per_pair[d][e]
            cmap[gb] = rx + e * max_pk + np.arange(gb.shape[0])
        cols = blk.indices.astype(np.int64)
        newcols = cmap[cols >> 7] * XB + (cols & (XB - 1))
        rowid = np.repeat(np.arange(blk.m), np.diff(blk.indptr))
        for is_local in (True, False):
            sel = (newcols < n_own) if is_local else (newcols >= n_own)
            r_s, c_s, v_s = rowid[sel], newcols[sel], blk.data[sel]
            order = np.lexsort((c_s, r_s))
            indptr = np.concatenate(
                [[0], np.cumsum(np.bincount(r_s, minlength=blk.m))]
            ).astype(np.int64)
            sub = CSRMatrix(
                (blk.m, n_own if is_local else n_c), indptr,
                c_s[order].astype(np.int64), v_s[order])
            (local_blocks if is_local else foreign_blocks).append(sub)
    ag_bytes = (ndev - 1) * rx
    halo_bytes = ndev * max_pk
    ratio = halo_bytes / max(ag_bytes, 1)
    return HaloPlan(rx=rx, max_pk=max_pk, n_x_pad=n_x_pad,
                    traffic_ratio=ratio, send_idx=send_idx,
                    local_blocks=local_blocks,
                    foreign_blocks=foreign_blocks)


def _plan_blocks(tile_matrices, compute_dtype):
    """Per-shard plans unified to one SPMD program (shared by the 1-D and
    2-D partitions)."""
    return _unify_plans([build_plan(tm, compute_dtype=compute_dtype)
                         for tm in tile_matrices])


class DistributedSpMV:
    """Row-partitioned SpMV over a 1-D device mesh.

    >>> op = DistributedSpMV(csr, mesh=make_mesh())
    >>> y = op(x)          # y sharded P('row') over the mesh
    """

    def __init__(self, csr: CSRMatrix,
                 mesh: Optional[Mesh] = None,
                 config: TileConfig = DEFAULT_CONFIG,
                 compute_dtype=jnp.float32,
                 x_mode: str = "allgather"):
        if x_mode not in ("allgather", "replicated", "halo", "auto"):
            raise ValueError(f"unknown x_mode {x_mode!r}")
        self.mesh = mesh if mesh is not None else make_mesh()
        ndev = self.mesh.devices.size
        b = config.tile_size
        m, n = csr.shape
        tilem_total = -(-m // b)
        tilem_per = -(-tilem_total // ndev)
        rows_per = tilem_per * b
        self.m, self.n = m, n
        self.rows_per_device = rows_per
        self.compute_dtype = jnp.dtype(compute_dtype)
        # x padded to a multiple of ndev for even sharding
        self.n_pad = -(-n // ndev) * ndev

        blocks = [_row_block(csr, d * rows_per, (d + 1) * rows_per,
                             rows_per) for d in range(ndev)]

        if x_mode in ("halo", "auto"):
            halo = _plan_halo(blocks, n, ndev)
            if x_mode == "auto":
                # halo pays when the exchanged packets are meaningfully
                # smaller than an all-gather of the full x
                x_mode = ("halo" if ndev > 1 and halo.traffic_ratio < 0.75
                          else "allgather")
            elif ndev == 1:
                x_mode = "replicated"
        if x_mode == "halo":
            self.halo = halo
            self._send_idx = jax.device_put(
                jnp.asarray(halo.send_idx),
                NamedSharding(self.mesh, P(ROW_AXIS)))
        else:
            self.halo = None
        self.x_mode = x_mode

        if x_mode == "halo":
            # two plan stacks per shard: the LOCAL plan reads only the
            # shard's own x segment, so its compute is independent of the
            # packet exchange and XLA can overlap the all-to-all with it
            # (SURVEY §5: collectives overlapped with local tile compute)
            self.tile_matrices = [tile_create(b, config)
                                  for b in halo.local_blocks]
            tms_f = [tile_create(b, config) for b in halo.foreign_blocks]
            plans_l = _plan_blocks(self.tile_matrices, compute_dtype)
            plans_f = _plan_blocks(tms_f, compute_dtype)
            self.local_plan_struct = plans_l[0]
            sharding = NamedSharding(self.mesh, P(ROW_AXIS))
            self.plan_sharded = (
                jax.device_put(jax.tree.map(lambda *xs: jnp.stack(xs),
                                            *plans_l), sharding),
                jax.device_put(jax.tree.map(lambda *xs: jnp.stack(xs),
                                            *plans_f), sharding))
        else:
            self.tile_matrices = [tile_create(block, config)
                                  for block in blocks]
            plans = _plan_blocks(self.tile_matrices, compute_dtype)
            self.local_plan_struct = plans[0]
            stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *plans)
            # place the stacked plan sharded over the mesh
            self.plan_sharded = jax.device_put(
                stacked, NamedSharding(self.mesh, P(ROW_AXIS)))

        x_mode_ = x_mode
        n_ = n
        halo_ = self.halo

        if x_mode == "halo":
            def local_step(plan_stacks, x_in, sidx):
                stack_l, stack_f = plan_stacks
                local_l = jax.tree.map(lambda a: a[0], stack_l)
                local_f = jax.tree.map(lambda a: a[0], stack_f)
                # start the selective exchange, then compute the local-
                # columns plan while the packets are in flight (XLA's
                # scheduler runs the async all-to-all concurrently — the
                # local plan has no data dependence on it)
                x2 = x_in.reshape(halo_.rx, 128)
                send = jnp.take(x2, sidx[0], axis=0)  # (ndev*max_pk, 128)
                recv = jax.lax.all_to_all(send, ROW_AXIS,
                                          split_axis=0, concat_axis=0,
                                          tiled=True)
                y_local = spmv(local_l, x_in[: local_l.n])
                x_c = jnp.concatenate([x2, recv], axis=0).reshape(-1)
                y_foreign = spmv(local_f, x_c[: local_f.n])
                return y_local + y_foreign

            self._step = jax.jit(jax.shard_map(
                local_step, mesh=self.mesh,
                in_specs=((P(ROW_AXIS), P(ROW_AXIS)), P(ROW_AXIS),
                          P(ROW_AXIS)),
                out_specs=P(ROW_AXIS)))
        else:
            def local_step(plan_stack: SpMVPlan,
                           x_in: jax.Array) -> jax.Array:
                local = jax.tree.map(lambda a: a[0], plan_stack)
                if x_mode_ == "allgather":
                    x_full = jax.lax.all_gather(x_in, ROW_AXIS, tiled=True)
                else:
                    x_full = x_in
                return spmv(local, x_full[:n_])

            in_x_spec = P(ROW_AXIS) if x_mode == "allgather" else P()
            self._step = jax.jit(jax.shard_map(
                local_step, mesh=self.mesh,
                in_specs=(P(ROW_AXIS), in_x_spec),
                out_specs=P(ROW_AXIS)))

    @property
    def shape(self) -> tuple[int, int]:
        return (self.m, self.n)

    def __call__(self, x) -> jax.Array:
        x = jnp.asarray(x, dtype=self.compute_dtype)
        if x.shape != (self.n,):
            raise ValueError(f"x has shape {x.shape}, expected ({self.n},)")
        if self.x_mode == "halo":
            x = jnp.pad(x, (0, self.halo.n_x_pad - self.n))
            x = jax.device_put(x, NamedSharding(self.mesh, P(ROW_AXIS)))
            y = self._step(self.plan_sharded, x, self._send_idx)
            return y[: self.m]
        if self.n_pad != self.n:
            x = jnp.pad(x, (0, self.n_pad - self.n))
        if self.x_mode == "allgather":
            x = jax.device_put(x, NamedSharding(self.mesh, P(ROW_AXIS)))
        else:
            x = jax.device_put(x, NamedSharding(self.mesh, P()))
        y = self._step(self.plan_sharded, x)
        return y[: self.m]

    def flops(self) -> int:
        return 2 * self.local_plan_struct.nnz
