// Native tile-conversion core for tilespmv-tpu.
//
// C++ equivalent of the reference's OpenMP host converter
// (reference: src/csr2tile.h convert_step1..4 + Tile_create) rebuilt as a
// single CSR-aware pass: for each tile-row band, occupied tiles are
// discovered with an epoch-stamped scratch table (no per-nnz linear tile
// search like csr2tile.h:403-419), per-tile row/column histograms and the
// format selector run in-band, and all nonzeros are scattered once into a
// tile-sorted stream (tile-major, then row-in-tile, then col-in-tile —
// canonical CSR input keeps this order for free). Python consumes the
// stream with its existing vectorized bucket fills.
//
// Exposed via a C ABI for ctypes. Two-phase protocol:
//   h = tc_analyze(...)            -> opaque handle (all analysis done)
//   tc_scalars(h, out[8])          -> tilenum etc.
//   tc_export_*(h, buffers...)     -> copy results into numpy buffers
//   tc_release(h)
//
// Selector semantics match tilespmv_tpu/core/convert.py exactly (which in
// turn matches reference csr2tile.h:140-328, including the C int truncation
// of rowlen*collen*0.75 and the disabled-by-default HYB branch).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

struct TileRec {
    int32_t col;          // tile-column
    int64_t nnz;
    uint8_t row_hist[16];
    uint8_t col_hist[16];
    int8_t fmt;
    int16_t ell_width;
    int16_t hyb_width;
    int32_t hyb_coo;
};

// Payload bucket arrays (the reference's convert_step4, csr2tile.h:330-627)
// filled natively in one pass over the tile-sorted stream — value arrays
// are raw bytes holding the FINAL dtype (f32 or f64 by `vb`), so Python
// wraps them zero-copy-equivalent instead of re-scattering 6M-nnz NumPy
// masks.
struct Fill {
    int32_t vb = 4;
    // CSR: packed stream + per-tile row starts
    std::vector<int32_t> csr_tid; std::vector<int64_t> csr_nnzptr{0};
    std::vector<uint8_t> csr_rowptr, csr_row, csr_col, csr_val;
    // COO: packed stream
    std::vector<int32_t> coo_tid; std::vector<int64_t> coo_nnzptr{0};
    std::vector<uint8_t> coo_row, coo_col, coo_val;
    // ELL: width-major slots, zero-padded
    std::vector<int32_t> ell_tid; std::vector<int16_t> ell_w;
    std::vector<int64_t> ell_ptr{0};
    std::vector<uint8_t> ell_col, ell_val;
    // HYB: ELL part + COO overflow
    std::vector<int32_t> hyb_tid; std::vector<int16_t> hyb_w;
    std::vector<int64_t> hyb_ellptr{0};
    std::vector<uint8_t> hyb_ellcol, hyb_ellval;
    std::vector<int64_t> hyb_cooptr{0};
    std::vector<uint8_t> hyb_coorow, hyb_coocol, hyb_cooval;
    // DNS: col-major densified tile
    std::vector<int32_t> dns_tid; std::vector<int64_t> dns_ptr{0};
    std::vector<uint8_t> dns_val;
    // DNSROW: packed full rows
    std::vector<int32_t> dr_tid; std::vector<int64_t> dr_rowptr{0};
    std::vector<uint8_t> dr_rowids; std::vector<int64_t> dr_ptr{0};
    std::vector<uint8_t> dr_val;
    // DNSCOL: packed full columns, col-major
    std::vector<int32_t> dc_tid; std::vector<int64_t> dc_colptr{0};
    std::vector<uint8_t> dc_colids; std::vector<int64_t> dc_ptr{0};
    std::vector<uint8_t> dc_val;
};

struct Analysis {
    int64_t m = 0, n = 0, nnz = 0;
    int32_t B = 16;
    int64_t tilem = 0, tilen = 0, tilenum = 0;

    std::vector<int64_t> tile_ptr;      // tilem+1
    std::vector<int32_t> tile_rowidx;   // tilenum
    std::vector<int32_t> tile_colidx;   // tilenum
    std::vector<int64_t> tile_counts;   // tilenum
    std::vector<uint8_t> row_hist;      // tilenum*16
    std::vector<uint8_t> col_hist;      // tilenum*16
    std::vector<int8_t> fmt;            // tilenum
    std::vector<int16_t> ell_width;     // tilenum
    std::vector<int16_t> hyb_width;     // tilenum
    std::vector<int32_t> hyb_coo;       // tilenum

    std::vector<double> val_s;          // nnz, tile-sorted
    std::vector<uint8_t> ri_s;          // nnz
    std::vector<uint8_t> ci_s;          // nnz

    Fill fill;
    bool filled = false;
};

struct Config {
    double dense_threshold;
    int64_t coo_nnz_threshold;
    double ell_cv_threshold;
    int32_t enable_hyb;
    double hyb_cv_threshold;
    int64_t hyb_max_coo;
    int32_t force_format;   // -1 = selector; else FMT_* code (0/1/2/4)
    int32_t value_bytes;    // sizeof value for the HYB io-size model
};

// Format codes (tilespmv_tpu/config.py)
constexpr int8_t FMT_CSR = 0, FMT_COO = 1, FMT_ELL = 2, FMT_HYB = 3,
                 FMT_DNS = 4, FMT_DNSROW = 5, FMT_DNSCOL = 6;

void select_format(TileRec& t, int64_t rowlen, int64_t collen,
                   const Config& cfg) {
    const int64_t nnz = t.nnz;
    if (cfg.force_format >= 0) {
        t.fmt = static_cast<int8_t>(cfg.force_format);
        if (t.fmt == FMT_ELL) {
            uint8_t w = 0;
            for (int r = 0; r < 16; ++r) w = std::max(w, t.row_hist[r]);
            t.ell_width = w;
        }
        return;
    }
    // (a) dense — note the int truncation (csr2tile.h:150)
    const int64_t dense_th = static_cast<int64_t>(
        static_cast<double>(rowlen) * static_cast<double>(collen)
        * cfg.dense_threshold);
    if (nnz >= dense_th) { t.fmt = FMT_DNS; return; }
    // (b) COO
    if (nnz <= cfg.coo_nnz_threshold) { t.fmt = FMT_COO; return; }
    // (c) dense-row / dense-col, gated on divisibility
    if (nnz % collen == 0 || nnz % rowlen == 0) {
        bool row_mult = true; int full_rows = 0;
        for (int r = 0; r < 16; ++r) {
            if (t.row_hist[r] % collen != 0) { row_mult = false; break; }
            if (t.row_hist[r] == collen) ++full_rows;
        }
        if (row_mult && full_rows > 0) { t.fmt = FMT_DNSROW; return; }
        bool col_mult = true; int full_cols = 0;
        for (int c = 0; c < 16; ++c) {
            if (t.col_hist[c] % rowlen != 0) { col_mult = false; break; }
            if (t.col_hist[c] == rowlen) ++full_cols;
        }
        if (col_mult && full_cols > 0) { t.fmt = FMT_DNSCOL; return; }
    }
    // (d) ELL by row-length coefficient of variation
    const double mean = static_cast<double>(nnz) / rowlen;
    double var = 0.0;
    uint8_t bwidth = 0;
    for (int64_t r = 0; r < rowlen; ++r) {
        const double d = t.row_hist[r] - mean;
        var += d * d;
        bwidth = std::max(bwidth, t.row_hist[r]);
    }
    var /= rowlen;
    const double cv = std::sqrt(var) / mean;
    if (cv <= cfg.ell_cv_threshold) {
        t.fmt = FMT_ELL;
        t.ell_width = bwidth;
        return;
    }
    // (e) HYB width search (disabled by default, csr2tile.h:308-316)
    if (cfg.enable_hyb && cv >= cfg.hyb_cv_threshold) {
        const int64_t vb = cfg.value_bytes;
        auto iosize = [&](int64_t w, int64_t coonum) {
            const int64_t ell = w * rowlen;
            return ell * vb + (ell + 1) / 2 + coonum * (vb + 1);
        };
        int64_t w_cur = bwidth;
        int64_t prior = iosize(bwidth, 0);
        int64_t coo_prior = 0;
        for (int64_t wi = bwidth - 1; wi > 0; --wi) {
            int64_t coonext = 0;
            for (int64_t r = 0; r < rowlen; ++r)
                if (t.row_hist[r] > wi) coonext += t.row_hist[r] - wi;
            const int64_t nxt = iosize(wi, coonext);
            if (prior <= nxt) { w_cur = wi + 1; break; }
            w_cur = wi; prior = nxt; coo_prior = coonext;
        }
        if (coo_prior <= cfg.hyb_max_coo) {
            t.fmt = FMT_HYB;
            t.hyb_width = static_cast<int16_t>(w_cur);
            t.hyb_coo = static_cast<int32_t>(coo_prior);
            return;
        }
    }
    t.fmt = FMT_CSR;
}

}  // namespace

extern "C" {

void* tc_analyze(int64_t m, int64_t n, int64_t nnz, int32_t B,
                 const int64_t* indptr, const int32_t* indices,
                 const double* data,
                 double dense_threshold, int64_t coo_nnz_threshold,
                 double ell_cv_threshold, int32_t enable_hyb,
                 double hyb_cv_threshold, int64_t hyb_max_coo,
                 int32_t force_format, int32_t value_bytes) {
    if (B != 16) return nullptr;  // kernels + nibble codec assume 16
    Config cfg{dense_threshold, coo_nnz_threshold, ell_cv_threshold,
               enable_hyb, hyb_cv_threshold, hyb_max_coo, force_format,
               value_bytes};
    auto* a = new Analysis();
    a->m = m; a->n = n; a->nnz = nnz; a->B = B;
    a->tilem = (m + B - 1) / B;
    a->tilen = (n + B - 1) / B;
    a->tile_ptr.assign(a->tilem + 1, 0);
    a->val_s.resize(nnz);
    a->ri_s.resize(nnz);
    a->ci_s.resize(nnz);

    // epoch-stamped tile-column table (per band)
    std::vector<int64_t> stamp(a->tilen, -1);
    std::vector<int32_t> slot_of_col(a->tilen, 0);

    std::vector<TileRec> band_tiles, tmp_tiles;
    std::vector<int32_t> perm;
    std::vector<int64_t> band_cursor;   // per-tile write cursor
    band_tiles.reserve(1024);

    int64_t out_pos = 0;                // global position in the stream
    for (int64_t band = 0; band < a->tilem; ++band) {
        const int64_t r0 = band * B;
        const int64_t r1 = std::min<int64_t>(m, r0 + B);
        band_tiles.clear();
        // pass 1: discover tiles, histograms, counts
        for (int64_t r = r0; r < r1; ++r) {
            const uint8_t ri = static_cast<uint8_t>(r - r0);
            for (int64_t k = indptr[r]; k < indptr[r + 1]; ++k) {
                const int32_t c = indices[k];
                const int32_t tc = c >> 4;          // B == 16 (guarded)
                const uint8_t ci = static_cast<uint8_t>(c & 15);
                int32_t s;
                if (stamp[tc] != band) {
                    stamp[tc] = band;
                    s = static_cast<int32_t>(band_tiles.size());
                    slot_of_col[tc] = s;
                    // value-initialized: histograms start zeroed
                    band_tiles.push_back(TileRec{tc, 0, {0}, {0},
                                                 -1, 0, 0, 0});
                } else {
                    s = slot_of_col[tc];
                }
                TileRec& t = band_tiles[s];
                ++t.nnz;
                ++t.row_hist[ri];
                ++t.col_hist[ci];
            }
        }
        // order tiles by tile-column WITHOUT moving the fat records:
        // sort a slot permutation, then rebuild via the permutation
        perm.resize(band_tiles.size());
        for (size_t s = 0; s < perm.size(); ++s) perm[s] = (int32_t)s;
        std::sort(perm.begin(), perm.end(),
                  [&](int32_t x, int32_t y) {
                      return band_tiles[x].col < band_tiles[y].col;
                  });
        tmp_tiles.resize(band_tiles.size());
        for (size_t s = 0; s < perm.size(); ++s)
            tmp_tiles[s] = band_tiles[perm[s]];
        band_tiles.swap(tmp_tiles);
        for (size_t s = 0; s < band_tiles.size(); ++s)
            slot_of_col[band_tiles[s].col] = static_cast<int32_t>(s);
        // selector + cursors
        const int64_t rowlen = r1 - r0;
        band_cursor.assign(band_tiles.size(), 0);
        {
            int64_t acc = out_pos;
            for (size_t s = 0; s < band_tiles.size(); ++s) {
                TileRec& t = band_tiles[s];
                const int64_t collen =
                    (t.col == a->tilen - 1) ? (n - (a->tilen - 1) * B) : B;
                select_format(t, rowlen, collen, cfg);
                band_cursor[s] = acc;
                acc += t.nnz;
            }
        }
        // pass 2: scatter nonzeros into the tile-sorted stream. Walking
        // rows ascending with ascending columns lands each tile's entries
        // in (row-in-tile, col-in-tile) order automatically.
        for (int64_t r = r0; r < r1; ++r) {
            const uint8_t ri = static_cast<uint8_t>(r - r0);
            for (int64_t k = indptr[r]; k < indptr[r + 1]; ++k) {
                const int32_t c = indices[k];
                const int32_t s = slot_of_col[c >> 4];
                const int64_t pos = band_cursor[s]++;
                a->val_s[pos] = data[k];
                a->ri_s[pos] = ri;
                a->ci_s[pos] = static_cast<uint8_t>(c & 15);
            }
        }
        // commit band tiles
        a->tile_ptr[band + 1] = a->tile_ptr[band]
            + static_cast<int64_t>(band_tiles.size());
        for (const TileRec& t : band_tiles) {
            a->tile_rowidx.push_back(static_cast<int32_t>(band));
            a->tile_colidx.push_back(t.col);
            a->tile_counts.push_back(t.nnz);
            for (int i = 0; i < 16; ++i) a->row_hist.push_back(t.row_hist[i]);
            for (int i = 0; i < 16; ++i) a->col_hist.push_back(t.col_hist[i]);
            a->fmt.push_back(t.fmt);
            a->ell_width.push_back(t.ell_width);
            a->hyb_width.push_back(t.hyb_width);
            a->hyb_coo.push_back(t.hyb_coo);
            out_pos += t.nnz;
        }
    }
    a->tilenum = static_cast<int64_t>(a->tile_rowidx.size());
    return a;
}

void tc_scalars(void* h, int64_t out[4]) {
    auto* a = static_cast<Analysis*>(h);
    out[0] = a->tilenum;
    out[1] = a->tilem;
    out[2] = a->tilen;
    out[3] = a->nnz;
}

void tc_export(void* h,
               int64_t* tile_ptr, int32_t* tile_rowidx, int32_t* tile_colidx,
               int64_t* tile_counts, uint8_t* row_hist, uint8_t* col_hist,
               int8_t* fmt, int16_t* ell_width, int16_t* hyb_width,
               int32_t* hyb_coo, double* val_s, uint8_t* ri_s,
               uint8_t* ci_s) {
    auto* a = static_cast<Analysis*>(h);
    // null destinations are skipped (light export: when the native fill
    // serves the buckets, Python doesn't need the sorted stream or the
    // 2x16-byte-per-tile histograms — 240 MB at 6M tiles)
    auto cp = [](auto* dst, const auto& src) {
        if (dst)
            std::memcpy(dst, src.data(),
                        src.size() * sizeof(src[0]));
    };
    cp(tile_ptr, a->tile_ptr);
    cp(tile_rowidx, a->tile_rowidx);
    cp(tile_colidx, a->tile_colidx);
    cp(tile_counts, a->tile_counts);
    cp(row_hist, a->row_hist);
    cp(col_hist, a->col_hist);
    cp(fmt, a->fmt);
    cp(ell_width, a->ell_width);
    cp(hyb_width, a->hyb_width);
    cp(hyb_coo, a->hyb_coo);
    cp(val_s, a->val_s);
    cp(ri_s, a->ri_s);
    cp(ci_s, a->ci_s);
}

void tc_release(void* h) {
    delete static_cast<Analysis*>(h);
}

// ---- payload bucket fills (reference convert_step4, csr2tile.h:330-627;
// semantics mirror tilespmv_tpu/core/convert.py tile_create's NumPy
// scatters, which remain the tested reference implementation) ----

static inline void put_val(std::vector<uint8_t>& v, int64_t idx, double x,
                           int vb) {
    if (vb == 4) reinterpret_cast<float*>(v.data())[idx] =
        static_cast<float>(x);
    else reinterpret_cast<double*>(v.data())[idx] = x;
}

int32_t tc_fill(void* h, int32_t value_bytes) {
    auto* a = static_cast<Analysis*>(h);
    if (value_bytes != 4 && value_bytes != 8) return 0;
    Fill& f = a->fill;
    f.vb = value_bytes;
    const int64_t vb = value_bytes;
    const int B = a->B;

    // sizing pass over the tile table: bucket membership + array lengths
    int64_t csr_nnz = 0, coo_nnz = 0, ell_len = 0, hyb_ell = 0,
            hyb_coo = 0, dns_len = 0, dr_rows = 0, dr_len = 0,
            dc_cols = 0, dc_len = 0;
    for (int64_t t = 0; t < a->tilenum; ++t) {
        const int64_t cnt = a->tile_counts[t];
        const int64_t rowlen = (a->tile_rowidx[t] == a->tilem - 1)
            ? (a->m - (a->tilem - 1) * B) : B;
        const int64_t collen = (a->tile_colidx[t] == a->tilen - 1)
            ? (a->n - (a->tilen - 1) * B) : B;
        const int32_t ti = static_cast<int32_t>(t);
        switch (a->fmt[t]) {
        case FMT_CSR:
            f.csr_tid.push_back(ti);
            csr_nnz += cnt;
            f.csr_nnzptr.push_back(csr_nnz);
            break;
        case FMT_COO:
            f.coo_tid.push_back(ti);
            coo_nnz += cnt;
            f.coo_nnzptr.push_back(coo_nnz);
            break;
        case FMT_ELL:
            f.ell_tid.push_back(ti);
            f.ell_w.push_back(a->ell_width[t]);
            ell_len += static_cast<int64_t>(a->ell_width[t]) * rowlen;
            f.ell_ptr.push_back(ell_len);
            break;
        case FMT_HYB:
            f.hyb_tid.push_back(ti);
            f.hyb_w.push_back(a->hyb_width[t]);
            hyb_ell += static_cast<int64_t>(a->hyb_width[t]) * rowlen;
            f.hyb_ellptr.push_back(hyb_ell);
            hyb_coo += a->hyb_coo[t];
            f.hyb_cooptr.push_back(hyb_coo);
            break;
        case FMT_DNS:
            f.dns_tid.push_back(ti);
            dns_len += rowlen * collen;
            f.dns_ptr.push_back(dns_len);
            break;
        case FMT_DNSROW: {
            f.dr_tid.push_back(ti);
            int64_t nr = 0;
            for (int r = 0; r < B; ++r)
                if (a->row_hist[t * B + r] == collen) {
                    f.dr_rowids.push_back(static_cast<uint8_t>(r));
                    ++nr;
                }
            dr_rows += nr;
            f.dr_rowptr.push_back(dr_rows);
            dr_len += nr * collen;
            f.dr_ptr.push_back(dr_len);
            break;
        }
        case FMT_DNSCOL: {
            f.dc_tid.push_back(ti);
            int64_t nc = 0;
            for (int c = 0; c < B; ++c)
                if (a->col_hist[t * B + c] == rowlen) {
                    f.dc_colids.push_back(static_cast<uint8_t>(c));
                    ++nc;
                }
            dc_cols += nc;
            f.dc_colptr.push_back(dc_cols);
            dc_len += nc * rowlen;
            f.dc_ptr.push_back(dc_len);
            break;
        }
        }
    }
    f.csr_rowptr.resize(f.csr_tid.size() * B);
    f.csr_row.resize(csr_nnz); f.csr_col.resize(csr_nnz);
    f.csr_val.resize(csr_nnz * vb);
    f.coo_row.resize(coo_nnz); f.coo_col.resize(coo_nnz);
    f.coo_val.resize(coo_nnz * vb);
    f.ell_col.assign(ell_len, 0); f.ell_val.assign(ell_len * vb, 0);
    f.hyb_ellcol.assign(hyb_ell, 0); f.hyb_ellval.assign(hyb_ell * vb, 0);
    f.hyb_coorow.resize(hyb_coo); f.hyb_coocol.resize(hyb_coo);
    f.hyb_cooval.resize(hyb_coo * vb);
    f.dns_val.assign(dns_len * vb, 0);
    f.dr_val.resize(dr_len * vb);
    f.dc_val.assign(dc_len * vb, 0);

    // fill pass: walk the tile-sorted stream once; entries of each tile
    // arrive in (row-in-tile, col-in-tile) order so the within-row slot
    // is a running counter
    int64_t pos = 0;
    size_t kcsr = 0, kcoo = 0, kell = 0, khyb = 0, kdns = 0, kdr = 0,
           kdc = 0;
    int64_t hyb_coo_cur = 0;
    for (int64_t t = 0; t < a->tilenum; ++t) {
        const int64_t cnt = a->tile_counts[t];
        const int64_t rowlen = (a->tile_rowidx[t] == a->tilem - 1)
            ? (a->m - (a->tilem - 1) * B) : B;
        const int8_t fm = a->fmt[t];
        switch (fm) {
        case FMT_CSR: {
            const int64_t base = f.csr_nnzptr[kcsr];
            // row starts: exclusive scan of the row histogram
            uint8_t* rp = f.csr_rowptr.data() + kcsr * B;
            int acc = 0;
            for (int r = 0; r < B; ++r) {
                rp[r] = static_cast<uint8_t>(acc);
                acc += a->row_hist[t * B + r];
            }
            for (int64_t k = 0; k < cnt; ++k) {
                f.csr_row[base + k] = a->ri_s[pos + k];
                f.csr_col[base + k] = a->ci_s[pos + k];
                put_val(f.csr_val, base + k, a->val_s[pos + k], f.vb);
            }
            ++kcsr;
            break;
        }
        case FMT_COO: {
            const int64_t base = f.coo_nnzptr[kcoo];
            for (int64_t k = 0; k < cnt; ++k) {
                f.coo_row[base + k] = a->ri_s[pos + k];
                f.coo_col[base + k] = a->ci_s[pos + k];
                put_val(f.coo_val, base + k, a->val_s[pos + k], f.vb);
            }
            ++kcoo;
            break;
        }
        case FMT_ELL: {
            const int64_t base = f.ell_ptr[kell];
            int64_t slot = 0; int prev = -1;
            for (int64_t k = 0; k < cnt; ++k) {
                const int ri = a->ri_s[pos + k];
                slot = (ri == prev) ? slot + 1 : 0;
                prev = ri;
                const int64_t d = base + slot * rowlen + ri;
                f.ell_col[d] = a->ci_s[pos + k];
                put_val(f.ell_val, d, a->val_s[pos + k], f.vb);
            }
            ++kell;
            break;
        }
        case FMT_HYB: {
            const int64_t base = f.hyb_ellptr[khyb];
            const int64_t w = f.hyb_w[khyb];
            int64_t slot = 0; int prev = -1;
            for (int64_t k = 0; k < cnt; ++k) {
                const int ri = a->ri_s[pos + k];
                slot = (ri == prev) ? slot + 1 : 0;
                prev = ri;
                if (slot < w) {
                    const int64_t d = base + slot * rowlen + ri;
                    f.hyb_ellcol[d] = a->ci_s[pos + k];
                    put_val(f.hyb_ellval, d, a->val_s[pos + k], f.vb);
                } else {
                    f.hyb_coorow[hyb_coo_cur] = a->ri_s[pos + k];
                    f.hyb_coocol[hyb_coo_cur] = a->ci_s[pos + k];
                    put_val(f.hyb_cooval, hyb_coo_cur, a->val_s[pos + k],
                            f.vb);
                    ++hyb_coo_cur;
                }
            }
            ++khyb;
            break;
        }
        case FMT_DNS: {
            const int64_t base = f.dns_ptr[kdns];
            for (int64_t k = 0; k < cnt; ++k) {
                const int64_t d = base
                    + static_cast<int64_t>(a->ci_s[pos + k]) * rowlen
                    + a->ri_s[pos + k];
                put_val(f.dns_val, d, a->val_s[pos + k], f.vb);
            }
            ++kdns;
            break;
        }
        case FMT_DNSROW: {
            // all full rows packed in stream order
            const int64_t base = f.dr_ptr[kdr];
            for (int64_t k = 0; k < cnt; ++k)
                put_val(f.dr_val, base + k, a->val_s[pos + k], f.vb);
            ++kdr;
            break;
        }
        case FMT_DNSCOL: {
            const int64_t base = f.dc_ptr[kdc];
            int64_t slot = 0; int prev = -1;
            for (int64_t k = 0; k < cnt; ++k) {
                const int ri = a->ri_s[pos + k];
                slot = (ri == prev) ? slot + 1 : 0;
                prev = ri;
                // rank within row == packed column index (canonical CSR:
                // every row lists the same full columns in order)
                const int64_t d = base + slot * rowlen + ri;
                put_val(f.dc_val, d, a->val_s[pos + k], f.vb);
            }
            ++kdc;
            break;
        }
        }
        pos += cnt;
    }
    a->filled = true;
    return 1;
}

void tc_fill_scalars(void* h, int64_t out[17]) {
    auto* a = static_cast<Analysis*>(h);
    const Fill& f = a->fill;
    out[0] = static_cast<int64_t>(f.csr_tid.size());
    out[1] = f.csr_nnzptr.back();
    out[2] = static_cast<int64_t>(f.coo_tid.size());
    out[3] = f.coo_nnzptr.back();
    out[4] = static_cast<int64_t>(f.ell_tid.size());
    out[5] = f.ell_ptr.back();
    out[6] = static_cast<int64_t>(f.hyb_tid.size());
    out[7] = f.hyb_ellptr.back();
    out[8] = f.hyb_cooptr.back();
    out[9] = static_cast<int64_t>(f.dns_tid.size());
    out[10] = f.dns_ptr.back();
    out[11] = static_cast<int64_t>(f.dr_tid.size());
    out[12] = f.dr_rowptr.back();
    out[13] = f.dr_ptr.back();
    out[14] = static_cast<int64_t>(f.dc_tid.size());
    out[15] = f.dc_colptr.back();
    out[16] = f.dc_ptr.back();
}

void tc_fill_export(void* h, void** bufs) {
    auto* a = static_cast<Analysis*>(h);
    const Fill& f = a->fill;
    auto cp = [](void* dst, const auto& src) {
        if (!src.empty())
            std::memcpy(dst, src.data(), src.size() * sizeof(src[0]));
    };
    int i = 0;
    cp(bufs[i++], f.csr_tid); cp(bufs[i++], f.csr_nnzptr);
    cp(bufs[i++], f.csr_rowptr); cp(bufs[i++], f.csr_row);
    cp(bufs[i++], f.csr_col); cp(bufs[i++], f.csr_val);
    cp(bufs[i++], f.coo_tid); cp(bufs[i++], f.coo_nnzptr);
    cp(bufs[i++], f.coo_row); cp(bufs[i++], f.coo_col);
    cp(bufs[i++], f.coo_val);
    cp(bufs[i++], f.ell_tid); cp(bufs[i++], f.ell_w);
    cp(bufs[i++], f.ell_ptr); cp(bufs[i++], f.ell_col);
    cp(bufs[i++], f.ell_val);
    cp(bufs[i++], f.hyb_tid); cp(bufs[i++], f.hyb_w);
    cp(bufs[i++], f.hyb_ellptr); cp(bufs[i++], f.hyb_ellcol);
    cp(bufs[i++], f.hyb_ellval); cp(bufs[i++], f.hyb_cooptr);
    cp(bufs[i++], f.hyb_coorow); cp(bufs[i++], f.hyb_coocol);
    cp(bufs[i++], f.hyb_cooval);
    cp(bufs[i++], f.dns_tid); cp(bufs[i++], f.dns_ptr);
    cp(bufs[i++], f.dns_val);
    cp(bufs[i++], f.dr_tid); cp(bufs[i++], f.dr_rowptr);
    cp(bufs[i++], f.dr_rowids); cp(bufs[i++], f.dr_ptr);
    cp(bufs[i++], f.dr_val);
    cp(bufs[i++], f.dc_tid); cp(bufs[i++], f.dc_colptr);
    cp(bufs[i++], f.dc_colids); cp(bufs[i++], f.dc_ptr);
    cp(bufs[i++], f.dc_val);
}

}  // extern "C"
