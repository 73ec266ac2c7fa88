"""Synthetic sparse-matrix corpus.

The reference benchmarks over 2,757 downloaded SuiteSparse matrices
(reference: external/CSR5_cuda/2757-matrix.csv, bench0.sh). This environment
has no network, so the framework ships deterministic generators that
reproduce the structural archetypes SuiteSparse covers — banded stencils,
power-law rows, dense blocks, full rows/columns, regular (ELL-like) rows —
so every per-tile format and the residual path get exercised and benchmarked.

All generators return canonical :class:`CSRMatrix` and are deterministic in
`seed`.
"""
from __future__ import annotations

import numpy as np

from .mmio import CSRMatrix, csr_from_coo


def _vals(rng: np.random.Generator, n: int, dtype) -> np.ndarray:
    # i % 10 value pattern keeps comparisons well conditioned, like the
    # reference driver's overwrite (main.cu:68-69); offset avoids zeros.
    return ((rng.integers(0, 10, n) + 1).astype(np.float64) / 4.0).astype(dtype)


def random_uniform(m: int, n: int, density: float, seed: int = 0,
                   dtype=np.float64) -> CSRMatrix:
    """Uniform random sparsity — mostly COO/CSR tiles + residual."""
    rng = np.random.default_rng(seed)
    nnz = max(1, int(m * n * density))
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    return csr_from_coo(m, n, rows, cols, _vals(rng, nnz, dtype))


def banded(m: int, n: int, bandwidth: int, seed: int = 0,
           dtype=np.float64) -> CSRMatrix:
    """Diagonal band — dense and ELL tiles along the diagonal."""
    rng = np.random.default_rng(seed)
    offs = np.arange(-bandwidth, bandwidth + 1)
    rows = np.repeat(np.arange(m), offs.size)
    cols = rows + np.tile(offs, m)
    ok = (cols >= 0) & (cols < n)
    rows, cols = rows[ok], cols[ok]
    return csr_from_coo(m, n, rows, cols, _vals(rng, rows.size, dtype))


def ell_regular(m: int, n: int, row_nnz: int, seed: int = 0,
                dtype=np.float64) -> CSRMatrix:
    """Every row has exactly `row_nnz` entries at regular strides — ELL tiles."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, max(1, n // max(1, row_nnz)), (m, 1))
    stride = max(1, n // max(1, row_nnz))
    cols = (base + np.arange(row_nnz)[None, :] * stride) % n
    rows = np.repeat(np.arange(m), row_nnz)
    return csr_from_coo(m, n, rows, cols.ravel(), _vals(rng, rows.size, dtype))


def dense_blocks(m: int, n: int, block: int = 16, num_blocks: int = 8,
                 seed: int = 0, dtype=np.float64) -> CSRMatrix:
    """Fully dense `block x block` blocks on a grid — dense tiles."""
    rng = np.random.default_rng(seed)
    bi = rng.integers(0, max(1, m // block), num_blocks)
    bj = rng.integers(0, max(1, n // block), num_blocks)
    rr, cc = np.meshgrid(np.arange(block), np.arange(block), indexing="ij")
    rows = (bi[:, None, None] * block + rr[None]).ravel()
    cols = (bj[:, None, None] * block + cc[None]).ravel()
    ok = (rows < m) & (cols < n)
    rows, cols = rows[ok], cols[ok]
    return csr_from_coo(m, n, rows, cols, _vals(rng, rows.size, dtype))


def full_rows(m: int, n: int, num_rows: int = 8, seed: int = 0,
              dtype=np.float64) -> CSRMatrix:
    """A few completely dense rows — dense-row tiles."""
    rng = np.random.default_rng(seed)
    ridx = rng.choice(m, size=min(num_rows, m), replace=False)
    rows = np.repeat(ridx, n)
    cols = np.tile(np.arange(n), ridx.size)
    return csr_from_coo(m, n, rows, cols, _vals(rng, rows.size, dtype))


def full_cols(m: int, n: int, num_cols: int = 8, seed: int = 0,
              dtype=np.float64) -> CSRMatrix:
    """A few completely dense columns — dense-col tiles."""
    rng = np.random.default_rng(seed)
    cidx = rng.choice(n, size=min(num_cols, n), replace=False)
    cols = np.tile(cidx, m)
    rows = np.repeat(np.arange(m), cidx.size)
    return csr_from_coo(m, n, rows, cols, _vals(rng, rows.size, dtype))


def power_law(m: int, n: int, avg_nnz_per_row: int = 8, alpha: float = 1.5,
              seed: int = 0, dtype=np.float64) -> CSRMatrix:
    """Power-law row lengths (scale-free graphs) — CSR tiles + long rows."""
    rng = np.random.default_rng(seed)
    raw = rng.pareto(alpha, m) + 1.0
    lens = np.minimum((raw / raw.mean() * avg_nnz_per_row).astype(np.int64), n)
    lens = np.maximum(lens, 1)
    rows = np.repeat(np.arange(m), lens)
    cols = rng.integers(0, n, rows.size)
    return csr_from_coo(m, n, rows, cols, _vals(rng, rows.size, dtype))


def stencil_2d(nx: int, ny: int, seed: int = 0,
               dtype=np.float64) -> CSRMatrix:
    """5-point 2D Poisson stencil on an nx x ny grid — the FEM/PDE
    archetype dominating SuiteSparse (banded with regular gaps at the
    grid pitch; exercises band + ELL selection across the pitch)."""
    rng = np.random.default_rng(seed)
    m = nx * ny
    i = np.arange(m)
    ix, iy = i % nx, i // nx
    rows, cols = [i], [i]
    for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        jx, jy = ix + dx, iy + dy
        ok = (jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny)
        rows.append(i[ok])
        cols.append((jy * nx + jx)[ok])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    return csr_from_coo(m, m, rows, cols, _vals(rng, rows.size, dtype))


def stencil_3d(nx: int, ny: int, nz: int, seed: int = 0,
               dtype=np.float64) -> CSRMatrix:
    """7-point 3D Poisson stencil — two distinct far diagonals (pitch
    nx and nx*ny) put single-diagonal tiles far from the main band."""
    rng = np.random.default_rng(seed)
    m = nx * ny * nz
    i = np.arange(m)
    ix = i % nx
    iy = (i // nx) % ny
    iz = i // (nx * ny)
    rows, cols = [i], [i]
    for dx, dy, dz in ((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
                       (0, 0, -1), (0, 0, 1)):
        jx, jy, jz = ix + dx, iy + dy, iz + dz
        ok = ((jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny)
              & (jz >= 0) & (jz < nz))
        rows.append(i[ok])
        cols.append(((jz * ny + jy) * nx + jx)[ok])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    return csr_from_coo(m, m, rows, cols, _vals(rng, rows.size, dtype))


def rectangular(m: int, n: int, avg_nnz_per_row: int = 8, seed: int = 0,
                dtype=np.float64) -> CSRMatrix:
    """Rectangular (tall m >> n or wide n >> m) uniform matrix — the
    LP/least-squares archetype; exercises non-square tile grids."""
    rng = np.random.default_rng(seed)
    nnz = m * avg_nnz_per_row
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    return csr_from_coo(m, n, rows, cols, _vals(rng, nnz, dtype))


def empty_stripes(m: int, n: int, period: int = 3, seed: int = 0,
                  dtype=np.float64) -> CSRMatrix:
    """Only every `period`-th row/column is populated — empty-row and
    empty-column stressor (empty tile-rows, x blocks never touched)."""
    rng = np.random.default_rng(seed)
    live_r = np.arange(0, m, period)
    nnz = live_r.size * 6
    rows = np.repeat(live_r, 6)
    cols = rng.integers(0, max(1, n // period), nnz) * period
    cols = np.minimum(cols, n - 1)
    return csr_from_coo(m, n, rows, cols, _vals(rng, nnz, dtype))


def duplicate_heavy(m: int, n: int, seed: int = 0,
                    dtype=np.float64) -> CSRMatrix:
    """COO input where ~75% of the entries are duplicates of earlier
    coordinates — exercises the loader/builder's canonical
    sort-and-sum path (the reference keeps duplicates and is
    order-sensitive; csr2tile.h:549-567)."""
    rng = np.random.default_rng(seed)
    base = m * 2
    rows = rng.integers(0, m, base)
    cols = rng.integers(0, n, base)
    pick = rng.integers(0, base, 3 * base)
    rows = np.concatenate([rows, rows[pick]])
    cols = np.concatenate([cols, cols[pick]])
    return csr_from_coo(m, n, rows, cols,
                        _vals(rng, rows.size, dtype))


def block_random(m: int, n: int, block: int = 16, density: float = 0.02,
                 fill: float = 0.6, seed: int = 0,
                 dtype=np.float64) -> CSRMatrix:
    """Random partially-filled 16x16 blocks (BSR-style circuits /
    graphs): tiles dense enough for the dense class but not full."""
    rng = np.random.default_rng(seed)
    bm, bn = m // block, n // block
    nblocks = max(1, int(bm * bn * density))
    bi = rng.integers(0, bm, nblocks)
    bj = rng.integers(0, bn, nblocks)
    per = max(1, int(block * block * fill))
    rr = rng.integers(0, block, (nblocks, per))
    cc = rng.integers(0, block, (nblocks, per))
    rows = (bi[:, None] * block + rr).ravel()
    cols = (bj[:, None] * block + cc).ravel()
    return csr_from_coo(m, n, rows, cols, _vals(rng, rows.size, dtype))


def permuted_banded(m: int, n: int, bandwidth: int, seed: int = 0,
                    dtype=np.float64) -> CSRMatrix:
    """A banded matrix under a random symmetric row/col permutation —
    locality destroyed, same degree profile (the scattered tiles must
    stay correct)."""
    rng = np.random.default_rng(seed)
    b = banded(m, n, bandwidth, seed=seed, dtype=dtype)
    perm = rng.permutation(m)
    rows = perm[np.repeat(np.arange(m), np.diff(b.indptr))]
    cols = perm[b.indices.astype(np.int64) % m]
    return csr_from_coo(m, n, rows, cols, b.data)


def diag_plus_hubs(m: int, n: int, bandwidth: int = 2, hubs: int = 4,
                   seed: int = 0, dtype=np.float64) -> CSRMatrix:
    """Near-diagonal band + a few full hub rows/columns — the
    circuit-simulation archetype (band tiles + full-row tiles + hub
    columns every row block touches)."""
    rng = np.random.default_rng(seed)
    b = banded(m, n, bandwidth, seed=seed, dtype=dtype)
    hub_r = rng.choice(m, hubs, replace=False)
    hub_c = rng.choice(n, hubs, replace=False)
    rows = np.concatenate([
        np.repeat(np.arange(m), np.diff(b.indptr)),
        np.repeat(hub_r, n), np.tile(np.arange(m), hubs)])
    cols = np.concatenate([
        b.indices.astype(np.int64),
        np.tile(np.arange(n), hubs), np.repeat(hub_c, m)])
    return csr_from_coo(m, n, rows, cols,
                        _vals(rng, rows.size, dtype))


def hypersparse(m: int, n: int, density: float = 1e-5, seed: int = 0,
                dtype=np.float64) -> CSRMatrix:
    """~1e-5 density uniform — most rows empty, nearly every entry in
    its own tile (all residual)."""
    return random_uniform(m, n, density, seed=seed, dtype=dtype)


def mixed_structure(m: int, n: int, seed: int = 0,
                    dtype=np.float64) -> CSRMatrix:
    """Superposition hitting all seven formats + residual in one matrix."""
    parts = [
        banded(m, n, 2, seed=seed, dtype=dtype),
        random_uniform(m, n, 2.0 / max(m, 1), seed=seed + 1, dtype=dtype),
        dense_blocks(m, n, num_blocks=max(2, m // 128), seed=seed + 2,
                     dtype=dtype),
        full_rows(m, n, num_rows=2, seed=seed + 3, dtype=dtype),
        full_cols(m, n, num_cols=2, seed=seed + 4, dtype=dtype),
        ell_regular(m, n, 4, seed=seed + 5, dtype=dtype),
    ]
    rows = np.concatenate(
        [np.repeat(np.arange(p.m), np.diff(p.indptr)) for p in parts])
    cols = np.concatenate([p.indices.astype(np.int64) for p in parts])
    vals = np.concatenate([p.data for p in parts])
    return csr_from_coo(m, n, rows, cols, vals)


# Named corpus used by tests and the benchmark sweep. Shapes chosen so the
# small ones convert instantly and the large ones stress HBM bandwidth.
CORPUS = {
    "mixed_small": lambda: mixed_structure(256, 256, seed=0),
    "mixed_medium": lambda: mixed_structure(4096, 4096, seed=1),
    "banded_medium": lambda: banded(8192, 8192, 8, seed=2),
    "uniform_sparse": lambda: random_uniform(8192, 8192, 0.001, seed=3),
    "powerlaw_medium": lambda: power_law(8192, 8192, 16, seed=4),
    "ell_medium": lambda: ell_regular(8192, 8192, 12, seed=5),
    "dense_blocks_medium": lambda: dense_blocks(4096, 4096, num_blocks=2048,
                                                seed=6),
    "mixed_large": lambda: mixed_structure(65536, 65536, seed=7),
    "banded_large": lambda: banded(262144, 262144, 16, seed=8),
    "powerlaw_large": lambda: power_law(262144, 262144, 24, seed=9),
    # SuiteSparse-scale web-graph archetype (~5.5M nnz at 2e-5 density)
    "powerlaw_huge": lambda: power_law(524288, 524288, 11, seed=77),
    # --- SuiteSparse structural archetypes ---
    "stencil2d_medium": lambda: stencil_2d(128, 128, seed=20),
    "stencil2d_large": lambda: stencil_2d(512, 512, seed=21),
    "stencil3d_large": lambda: stencil_3d(64, 64, 64, seed=22),
    "tall_rect": lambda: rectangular(131072, 4096, 8, seed=23),
    "wide_rect": lambda: rectangular(4096, 131072, 96, seed=24),
    "empty_stripes_medium": lambda: empty_stripes(16384, 16384, 3,
                                                  seed=25),
    "duplicate_heavy_medium": lambda: duplicate_heavy(8192, 8192,
                                                      seed=26),
    "block_random_large": lambda: block_random(65536, 65536,
                                               density=0.004, seed=27),
    "permuted_banded_medium": lambda: permuted_banded(16384, 16384, 8,
                                                      seed=28),
    "diag_hubs_medium": lambda: diag_plus_hubs(16384, 16384, seed=29),
    "hypersparse_large": lambda: hypersparse(262144, 262144, 1e-5,
                                             seed=30),
}


def get_matrix(name: str) -> CSRMatrix:
    if name not in CORPUS:
        raise KeyError(f"unknown corpus matrix {name!r}; "
                       f"available: {sorted(CORPUS)}")
    return CORPUS[name]()
