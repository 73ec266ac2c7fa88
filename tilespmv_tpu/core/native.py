"""ctypes bridge to the native converter (native/tileconv.cpp).

Builds `native/libtileconv.so` on first use if a C++ toolchain is present;
falls back silently to the NumPy converter otherwise. The native analysis
does the reference's 4-pass conversion work (csr2tile.h) in one CSR-aware
O(nnz) pass; Python keeps the (vectorized, cheap) payload bucket fills.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading
from typing import Optional

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libtileconv.so"
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    # always invoke make: it is a timestamp no-op when the .so is up to
    # date, and it rebuilds a stale committed .so after source edits
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                       capture_output=True, timeout=120)
        return _LIB_PATH.exists()
    except Exception:
        return _LIB_PATH.exists()


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it if needed; None if
    unavailable (disabled via TILESPMV_NATIVE=0, no toolchain, ...)."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("TILESPMV_NATIVE", "1") == "0":
            return None
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            return None
        lib.tc_analyze.restype = ctypes.c_void_p
        lib.tc_analyze.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_double, ctypes.c_int64, ctypes.c_double,
            ctypes.c_int32, ctypes.c_double, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.tc_scalars.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.tc_export.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 13
        lib.tc_release.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def _init_fill_symbols(lib) -> bool:
    try:
        lib.tc_fill.restype = ctypes.c_int32
        lib.tc_fill.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.tc_fill_scalars.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.tc_fill_export.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        return True
    except AttributeError:
        return False


def _export_fill(lib, h, vdt: np.dtype) -> Optional[dict]:
    """Export the native payload buckets (tc_fill must have returned 1).
    Returns {bucket: {field: ndarray}} mirroring convert.py's fills."""
    sc = np.zeros(17, np.int64)
    lib.tc_fill_scalars(h, sc.ctypes.data)
    (csr_k, csr_nnz, coo_k, coo_nnz, ell_k, ell_len, hyb_k, hyb_ell,
     hyb_coo, dns_k, dns_len, dr_k, dr_rows, dr_len, dc_k, dc_cols,
     dc_len) = (int(v) for v in sc)
    f = dict(
        csr=dict(tile_ids=np.zeros(csr_k, np.int32),
                 nnz_ptr=np.zeros(csr_k + 1, np.int64),
                 rowptr=np.zeros((csr_k, 16), np.uint8),
                 row=np.zeros(csr_nnz, np.uint8),
                 col=np.zeros(csr_nnz, np.uint8),
                 val=np.zeros(csr_nnz, vdt)),
        coo=dict(tile_ids=np.zeros(coo_k, np.int32),
                 nnz_ptr=np.zeros(coo_k + 1, np.int64),
                 row=np.zeros(coo_nnz, np.uint8),
                 col=np.zeros(coo_nnz, np.uint8),
                 val=np.zeros(coo_nnz, vdt)),
        ell=dict(tile_ids=np.zeros(ell_k, np.int32),
                 width=np.zeros(ell_k, np.int16),
                 ptr=np.zeros(ell_k + 1, np.int64),
                 col=np.zeros(ell_len, np.uint8),
                 val=np.zeros(ell_len, vdt)),
        hyb=dict(tile_ids=np.zeros(hyb_k, np.int32),
                 width=np.zeros(hyb_k, np.int16),
                 ell_ptr=np.zeros(hyb_k + 1, np.int64),
                 ell_col=np.zeros(hyb_ell, np.uint8),
                 ell_val=np.zeros(hyb_ell, vdt),
                 coo_ptr=np.zeros(hyb_k + 1, np.int64),
                 coo_row=np.zeros(hyb_coo, np.uint8),
                 coo_col=np.zeros(hyb_coo, np.uint8),
                 coo_val=np.zeros(hyb_coo, vdt)),
        dns=dict(tile_ids=np.zeros(dns_k, np.int32),
                 ptr=np.zeros(dns_k + 1, np.int64),
                 val=np.zeros(dns_len, vdt)),
        dnsrow=dict(tile_ids=np.zeros(dr_k, np.int32),
                    row_ptr=np.zeros(dr_k + 1, np.int64),
                    row_ids=np.zeros(dr_rows, np.uint8),
                    ptr=np.zeros(dr_k + 1, np.int64),
                    val=np.zeros(dr_len, vdt)),
        dnscol=dict(tile_ids=np.zeros(dc_k, np.int32),
                    col_ptr=np.zeros(dc_k + 1, np.int64),
                    col_ids=np.zeros(dc_cols, np.uint8),
                    ptr=np.zeros(dc_k + 1, np.int64),
                    val=np.zeros(dc_len, vdt)))
    order = [("csr", "tile_ids"), ("csr", "nnz_ptr"), ("csr", "rowptr"),
             ("csr", "row"), ("csr", "col"), ("csr", "val"),
             ("coo", "tile_ids"), ("coo", "nnz_ptr"), ("coo", "row"),
             ("coo", "col"), ("coo", "val"),
             ("ell", "tile_ids"), ("ell", "width"), ("ell", "ptr"),
             ("ell", "col"), ("ell", "val"),
             ("hyb", "tile_ids"), ("hyb", "width"), ("hyb", "ell_ptr"),
             ("hyb", "ell_col"), ("hyb", "ell_val"), ("hyb", "coo_ptr"),
             ("hyb", "coo_row"), ("hyb", "coo_col"), ("hyb", "coo_val"),
             ("dns", "tile_ids"), ("dns", "ptr"), ("dns", "val"),
             ("dnsrow", "tile_ids"), ("dnsrow", "row_ptr"),
             ("dnsrow", "row_ids"), ("dnsrow", "ptr"), ("dnsrow", "val"),
             ("dnscol", "tile_ids"), ("dnscol", "col_ptr"),
             ("dnscol", "col_ids"), ("dnscol", "ptr"), ("dnscol", "val")]
    bufs = (ctypes.c_void_p * len(order))(
        *[f[b][k].ctypes.data for (b, k) in order])
    lib.tc_fill_export(h, bufs)
    return f


def analyze(m: int, n: int, indptr: np.ndarray, indices: np.ndarray,
            data: np.ndarray, cfg) -> Optional[dict]:
    """Run the native analysis (+ payload bucket fills when the value
    dtype allows); returns the converter-internal dict or None when the
    native path can't serve this config."""
    if cfg.tile_size != 16:
        return None
    lib = get_lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    data64 = np.ascontiguousarray(data, dtype=np.float64)
    nnz = int(indptr[-1])
    force = {"csr": 0, "coo": 1, "ell": 2, "dns": 4}.get(
        cfg.force_format, -1)
    h = lib.tc_analyze(
        m, n, nnz, cfg.tile_size,
        indptr.ctypes.data, indices.ctypes.data, data64.ctypes.data,
        cfg.dense_threshold, cfg.coo_nnz_threshold, cfg.ell_cv_threshold,
        1 if cfg.enable_hyb else 0, cfg.hyb_cv_threshold, cfg.hyb_max_coo,
        force, np.dtype(cfg.value_dtype).itemsize)
    if not h:
        return None
    try:
        scalars = np.zeros(4, np.int64)
        lib.tc_scalars(h, scalars.ctypes.data)
        tilenum, tilem, tilen, _ = (int(v) for v in scalars)
        vdt = np.dtype(cfg.value_dtype)
        fill = None
        if (vdt.itemsize in (4, 8) and vdt.kind == "f"
                and _init_fill_symbols(lib)
                and lib.tc_fill(h, vdt.itemsize)):
            fill = _export_fill(lib, h, vdt)
        out = dict(
            tilem=tilem, tilen=tilen,
            tile_ptr=np.zeros(tilem + 1, np.int64),
            tile_rowidx=np.zeros(tilenum, np.int32),
            tile_colidx=np.zeros(tilenum, np.int32),
            counts=np.zeros(tilenum, np.int64),
            fmt=np.zeros(tilenum, np.int8),
        )
        if fill is None:
            # full export: the NumPy bucket fills need the sorted stream,
            # histograms, and selector side outputs
            out.update(
                row_hist=np.zeros((tilenum, 16), np.uint8),
                col_hist=np.zeros((tilenum, 16), np.uint8),
                ell_width=np.zeros(tilenum, np.int16),
                hyb_width=np.zeros(tilenum, np.int16),
                hyb_coo=np.zeros(tilenum, np.int32),
                val_s=np.zeros(nnz, np.float64),
                ri_s=np.zeros(nnz, np.uint8),
                ci_s=np.zeros(nnz, np.uint8),
            )

        def ptr(key):
            return out[key].ctypes.data if key in out else None
        lib.tc_export(
            h,
            ptr("tile_ptr"), ptr("tile_rowidx"), ptr("tile_colidx"),
            ptr("counts"), ptr("row_hist"), ptr("col_hist"), ptr("fmt"),
            ptr("ell_width"), ptr("hyb_width"), ptr("hyb_coo"),
            ptr("val_s"), ptr("ri_s"), ptr("ci_s"))
        if fill is not None:
            out["fill"] = fill
        return out
    finally:
        lib.tc_release(h)


def parse_coord_body(body: bytes, nnz: int, field: str):
    """Parse a Matrix Market coordinate body natively
    (native/mmio_parse.cpp); returns (rows, cols, vals) or None to fall
    back to the NumPy tokenizer."""
    lib = get_lib()
    if lib is None:
        return None
    try:
        lib.mm_parse_coord.restype = ctypes.c_int64
        lib.mm_parse_coord.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
    except AttributeError:
        return None
    fcode = {"pattern": 0, "real": 1, "integer": 1, "complex": 2}[field]
    rows = np.empty(nnz, np.int64)
    cols = np.empty(nnz, np.int64)
    vals = np.empty(nnz, np.float64)
    got = lib.mm_parse_coord(body, len(body), nnz, fcode,
                             rows.ctypes.data, cols.ctypes.data,
                             vals.ctypes.data)
    if got != nnz:
        return None
    return rows, cols, vals
