// beatkit: native host-side kernels for mesh and assembly setup.
//
// The port's own copy of the JAX package's fenicsx_beat_tpu/native/beatkit.cpp.
// The reference delegates these functions to external native libraries
// (DOLFINx C++ mesh topology, PETSc matrix assembly: reference
// src/beat/geometry.py:112-139 and src/beat/base_model.py:114-124).  The
// host-side setup (entity enumeration, COO->ELL conversion, P1 geometry and
// assembly, point location, bandwidth-reducing node ordering) is host C++
// with a plain C interface, bound with ctypes by
// fenicsx_beat_tpu_torch/native/__init__.py, where each function's numpy
// twin stands beside it.  No CUDA here.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC beatkit.cpp -o libbeatkit.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// unique_rows_i32: lexicographic-unique rows of an int32 [n, k] array
// (entity enumeration: unique facets/edges from per-cell candidates).
// Writes unique rows to `out` (caller-allocated, n*k), returns their count.
int64_t unique_rows_i32(const int32_t* rows, int64_t n, int64_t k, int32_t* out) {
    std::vector<int64_t> idx(n);
    std::iota(idx.begin(), idx.end(), 0);
    auto less = [rows, k](int64_t a, int64_t b) {
        const int32_t* ra = rows + a * k;
        const int32_t* rb = rows + b * k;
        for (int64_t j = 0; j < k; ++j) {
            if (ra[j] != rb[j]) return ra[j] < rb[j];
        }
        return false;
    };
    std::sort(idx.begin(), idx.end(), less);
    auto equal = [rows, k](int64_t a, int64_t b) {
        return std::memcmp(rows + a * k, rows + b * k, k * sizeof(int32_t)) == 0;
    };
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (i == 0 || !equal(idx[i], idx[i - 1])) {
            std::memcpy(out + m * k, rows + idx[i] * k, k * sizeof(int32_t));
            ++m;
        }
    }
    return m;
}

// ---------------------------------------------------------------------------
// coo_to_ell: convert COO triplets (duplicates summed) into a padded ELL
// matrix with a fixed row width.
//
// Pass 1 (ell_width): max nonzeros per row after dedup.  Pass 2 (fill):
// write column indices (padded with `pad_col`) and values.  Both passes
// share the sort, so the caller invokes coo_to_ell once with out buffers
// sized from a prior ell_width call.
int64_t ell_width(const int64_t* rows_sorted_counts, int64_t nrows) {
    int64_t w = 0;
    for (int64_t i = 0; i < nrows; ++i) w = std::max(w, rows_sorted_counts[i]);
    return w;
}

// Sorts (row, col) pairs, sums duplicates, fills padded ELL arrays.
// cols_out: [nrows * width] int32 (pre-filled by callee with pad_col)
// vals_out: [nrows * width] float64
// Returns the actual max row width (<= width); -1 if width was too small.
int64_t coo_to_ell_f64(const int64_t* rows, const int64_t* cols, const double* vals,
                       int64_t nnz, int64_t nrows, int64_t width, int32_t pad_col,
                       int32_t* cols_out, double* vals_out) {
    // pack (row, col) into one 64-bit key and sort (key, val) pairs directly
    // for cache locality; 4-pass LSD radix (16 bits each) beats std::sort on
    // the ~10M-entry assemblies of fine meshes.
    struct Entry {
        uint64_t key;
        double val;
    };
    std::vector<Entry> e(nnz);
    // keys fit in 64 bits when nrows * ncols < 2^64; FEM dofs are << 2^31 so
    // row << 32 | col is exact.
    for (int64_t i = 0; i < nnz; ++i) {
        e[i].key = ((uint64_t)rows[i] << 32) | (uint32_t)cols[i];
        e[i].val = vals[i];
    }
    {
        std::vector<Entry> tmp(nnz);
        Entry* src = e.data();
        Entry* dst = tmp.data();
        const int BITS = 16;
        const int64_t BUCKETS = 1 << BITS;
        std::vector<int64_t> count(BUCKETS);
        for (int pass = 0; pass < 4; ++pass) {
            int shift = pass * BITS;
            std::fill(count.begin(), count.end(), 0);
            for (int64_t i = 0; i < nnz; ++i) count[(src[i].key >> shift) & (BUCKETS - 1)]++;
            int64_t sum = 0;
            for (int64_t b = 0; b < BUCKETS; ++b) {
                int64_t c = count[b];
                count[b] = sum;
                sum += c;
            }
            for (int64_t i = 0; i < nnz; ++i)
                dst[count[(src[i].key >> shift) & (BUCKETS - 1)]++] = src[i];
            std::swap(src, dst);
        }
        // 4 passes => result back in e.data()
    }
    for (int64_t r = 0; r < nrows; ++r) {
        for (int64_t j = 0; j < width; ++j) {
            cols_out[r * width + j] = pad_col;
            vals_out[r * width + j] = 0.0;
        }
    }
    int64_t max_w = 0;
    int64_t i = 0;
    while (i < nnz) {
        int64_t r = (int64_t)(e[i].key >> 32);
        int64_t w = 0;
        while (i < nnz && (int64_t)(e[i].key >> 32) == r) {
            uint64_t key = e[i].key;
            double v = 0.0;
            while (i < nnz && e[i].key == key) {
                v += e[i].val;
                ++i;
            }
            if (w >= width) return -1;
            cols_out[r * width + w] = (int32_t)(uint32_t)key;
            vals_out[r * width + w] = v;
            ++w;
        }
        max_w = std::max(max_w, w);
    }
    return max_w;
}

// ---------------------------------------------------------------------------
// p1_geometry: one-pass P1 simplex cell geometry for tdim == gdim == d
// (d in {1,2,3}).  The NumPy pipeline materializes five [nc, d(+1), d]
// temporaries across ~15 strided passes (gather, subtract, 9 cofactor
// writes, transpose, sum, concatenate) — measured 45 s of the 59 s
// dx=0.1 stencil assembly on one vCPU; this loop touches each cell once.
//
// coords: [n, d] f64 (C-order), cells: [nc, d+1] int32.
// Outputs (caller-allocated): edges [nc, d, d] (row i = x_{i+1} - x_0),
// volume [nc] (= |det E| / d!), grads [nc, d+1, d] (physical gradients of
// the d+1 P1 basis functions; rows 1..d equal inv(E)^T, row 0 their
// negative sum — the layout fem.CellGeometry expects, with inv_edges a
// view of rows 1..d).
// Returns 0, or -1 when any cell Jacobian is exactly singular
// (degenerate zero-volume cell; caller raises like numpy.linalg).
int64_t p1_geometry(const double* coords, const int32_t* cells, int64_t nc,
                    int32_t d, double* edges, double* volume, double* grads) {
    const double fact = (d == 3) ? 6.0 : (d == 2 ? 2.0 : 1.0);
    if (d == 3) {
        for (int64_t ci = 0; ci < nc; ++ci) {
            const int32_t* cv = cells + ci * 4;
            const double* x0 = coords + (int64_t)cv[0] * 3;
            double* E = edges + ci * 9;
            for (int i = 0; i < 3; ++i) {
                const double* xi = coords + (int64_t)cv[i + 1] * 3;
                E[i * 3 + 0] = xi[0] - x0[0];
                E[i * 3 + 1] = xi[1] - x0[1];
                E[i * 3 + 2] = xi[2] - x0[2];
            }
            const double a = E[0], b = E[1], c = E[2];
            const double p = E[3], q = E[4], r = E[5];
            const double u = E[6], v = E[7], w = E[8];
            const double A = q * w - r * v;
            const double B = r * u - p * w;
            const double C = p * v - q * u;
            const double det = a * A + b * B + c * C;
            if (det == 0.0) return -1;
            const double s = 1.0 / det;
            volume[ci] = (det < 0 ? -det : det) / fact;
            double* G = grads + ci * 12;  // [4, 3]; row i+1 = grad xi_i
            G[3] = A * s;       G[4] = B * s;       G[5] = C * s;
            G[6] = (c * v - b * w) * s; G[7] = (a * w - c * u) * s; G[8] = (b * u - a * v) * s;
            G[9] = (b * r - c * q) * s; G[10] = (c * p - a * r) * s; G[11] = (a * q - b * p) * s;
            G[0] = -(G[3] + G[6] + G[9]);
            G[1] = -(G[4] + G[7] + G[10]);
            G[2] = -(G[5] + G[8] + G[11]);
        }
        return 0;
    }
    if (d == 2) {
        for (int64_t ci = 0; ci < nc; ++ci) {
            const int32_t* cv = cells + ci * 3;
            const double* x0 = coords + (int64_t)cv[0] * 2;
            double* E = edges + ci * 4;
            for (int i = 0; i < 2; ++i) {
                const double* xi = coords + (int64_t)cv[i + 1] * 2;
                E[i * 2 + 0] = xi[0] - x0[0];
                E[i * 2 + 1] = xi[1] - x0[1];
            }
            const double a = E[0], b = E[1], c = E[2], dd = E[3];
            const double det = a * dd - b * c;
            if (det == 0.0) return -1;
            const double s = 1.0 / det;
            volume[ci] = (det < 0 ? -det : det) / fact;
            double* G = grads + ci * 6;  // [3, 2]
            G[2] = dd * s;  G[3] = -c * s;
            G[4] = -b * s;  G[5] = a * s;
            G[0] = -(G[2] + G[4]);
            G[1] = -(G[3] + G[5]);
        }
        return 0;
    }
    if (d == 1) {
        for (int64_t ci = 0; ci < nc; ++ci) {
            const int32_t* cv = cells + ci * 2;
            const double e = coords[cv[1]] - coords[cv[0]];
            if (e == 0.0) return -1;
            edges[ci] = e;
            volume[ci] = e < 0 ? -e : e;
            double* G = grads + ci * 2;
            G[1] = 1.0 / e;
            G[0] = -G[1];
        }
        return 0;
    }
    return -2;  // unsupported dimension: caller falls back to NumPy
}

// ---------------------------------------------------------------------------
// p1_stencil_offsets: the distinct column offsets cd[c,j] - cd[c,i] over
// all cells and local (i, j) slots, written sorted to out_offs.  Returns
// the offset count K, or -1 once the set exceeds max_offsets (unstructured
// mesh: the caller declines the stencil format).  Replaces nd*nd numpy
// unique() passes over [nc] difference vectors.
int64_t p1_stencil_offsets(const int64_t* cd, int64_t nc, int32_t nd,
                           int64_t max_offsets, int64_t* out_offs) {
    std::vector<int64_t> offs;
    offs.reserve((size_t)max_offsets + 1);
    for (int64_t c = 0; c < nc; ++c) {
        const int64_t* r = cd + c * nd;
        for (int32_t i = 0; i < nd; ++i) {
            for (int32_t j = 0; j < nd; ++j) {
                const int64_t d = r[j] - r[i];
                auto it = std::lower_bound(offs.begin(), offs.end(), d);
                if (it == offs.end() || *it != d) {
                    if ((int64_t)offs.size() >= max_offsets) return -1;
                    offs.insert(it, d);
                }
            }
        }
    }
    std::copy(offs.begin(), offs.end(), out_offs);
    return (int64_t)offs.size();
}

// ---------------------------------------------------------------------------
// p1_stencil_assemble: one-pass consistent-mass + anisotropic-stiffness
// scatter into the [n, K] stencil tables.  Replaces the numpy slot loop
// (nd*nd searchsorted + 2 bincounts over n*K each, plus the per-slot
// conductivity einsums — measured 5.5 s of the 6.9 s dx=0.1 assembly on
// one vCPU); this touches each cell once.
//
// cd: [nc, nd] int64 cell dofs; vol: [nc]; grads: [nc, nd, g] physical
// basis gradients; mc: per-cell conductivity [g, g] blocks read at
// mc + c*mc_stride (mc_stride 0 broadcasts one tensor); base: [nd, nd]
// closed-form P1 mass matrix / volume; offs: [K] sorted output of
// p1_stencil_offsets.  mst/kst: [n*K] zero-initialized accumulators,
// mst[row*K + k] accumulating column offset offs[k].
// Returns 0, or -1 if some dof difference is absent from offs (caller
// bug: offs not built from this cd).
int64_t p1_stencil_assemble(const int64_t* cd, int64_t nc, int32_t nd,
                            const double* vol, const double* grads, int32_t g,
                            const double* mc, int64_t mc_stride,
                            const double* base, const int64_t* offs, int64_t K,
                            double* mst, double* kst) {
    double MG[4][3];  // (M . grad phi_j) per cell; nd <= 4, g <= 3
    if (nd > 4 || g > 3) return -2;
    for (int64_t c = 0; c < nc; ++c) {
        const int64_t* r = cd + c * nd;
        const double v = vol[c];
        const double* Gc = grads + c * (int64_t)nd * g;
        const double* M = mc + c * mc_stride;
        for (int32_t j = 0; j < nd; ++j) {
            const double* Gj = Gc + j * g;
            for (int32_t a = 0; a < g; ++a) {
                double s = 0.0;
                for (int32_t b = 0; b < g; ++b) s += M[a * g + b] * Gj[b];
                MG[j][a] = s;
            }
        }
        for (int32_t i = 0; i < nd; ++i) {
            const double* Gi = Gc + i * g;
            for (int32_t j = 0; j < nd; ++j) {
                const int64_t d = r[j] - r[i];
                const int64_t* it = std::lower_bound(offs, offs + K, d);
                if (it == offs + K || *it != d) return -1;
                const int64_t idx = r[i] * K + (it - offs);
                mst[idx] += v * base[i * nd + j];
                double ke = 0.0;
                for (int32_t a = 0; a < g; ++a) ke += Gi[a] * MG[j][a];
                kst[idx] += v * ke;
            }
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// p1_stencil_offsets_i32: int32 variant of p1_stencil_offsets (P1 cell
// dofs ARE mesh.cells, which is int32 — avoids a [nc, nd] int64 cast that
// costs ~0.6 GB of host traffic at the 20M-cell dx=0.05 resolution).
int64_t p1_stencil_offsets_i32(const int32_t* cd, int64_t nc, int32_t nd,
                               int64_t max_offsets, int64_t* out_offs) {
    std::vector<int64_t> offs;
    offs.reserve((size_t)max_offsets + 1);
    for (int64_t c = 0; c < nc; ++c) {
        const int32_t* r = cd + c * nd;
        for (int32_t i = 0; i < nd; ++i) {
            for (int32_t j = 0; j < nd; ++j) {
                const int64_t d = (int64_t)r[j] - r[i];
                auto it = std::lower_bound(offs.begin(), offs.end(), d);
                if (it == offs.end() || *it != d) {
                    if ((int64_t)offs.size() >= max_offsets) return -1;
                    offs.insert(it, d);
                }
            }
        }
    }
    std::copy(offs.begin(), offs.end(), out_offs);
    return (int64_t)offs.size();
}

// ---------------------------------------------------------------------------
// Inline per-cell P1 geometry for tdim == gdim == d in {2, 3}: volume and
// physical basis gradients G[i][a] (rows 1..d = inv(E)^T, row 0 = -sum).
// Returns 0, or -1 on an exactly singular Jacobian.
static inline int p1_cell_geom(const double* coords, const int32_t* r, int32_t d,
                               double* vol, double G[4][3]) {
    if (d == 3) {
        const double* x0 = coords + (int64_t)r[0] * 3;
        const double* x1 = coords + (int64_t)r[1] * 3;
        const double* x2 = coords + (int64_t)r[2] * 3;
        const double* x3 = coords + (int64_t)r[3] * 3;
        const double a = x1[0] - x0[0], b = x1[1] - x0[1], cc = x1[2] - x0[2];
        const double p = x2[0] - x0[0], q = x2[1] - x0[1], s = x2[2] - x0[2];
        const double u = x3[0] - x0[0], v = x3[1] - x0[1], w = x3[2] - x0[2];
        const double A = q * w - s * v;
        const double B = s * u - p * w;
        const double C = p * v - q * u;
        const double det = a * A + b * B + cc * C;
        if (det == 0.0) return -1;
        const double iv = 1.0 / det;
        G[1][0] = A * iv;                G[1][1] = B * iv;                G[1][2] = C * iv;
        G[2][0] = (cc * v - b * w) * iv; G[2][1] = (a * w - cc * u) * iv; G[2][2] = (b * u - a * v) * iv;
        G[3][0] = (b * s - cc * q) * iv; G[3][1] = (cc * p - a * s) * iv; G[3][2] = (a * q - b * p) * iv;
        G[0][0] = -(G[1][0] + G[2][0] + G[3][0]);
        G[0][1] = -(G[1][1] + G[2][1] + G[3][1]);
        G[0][2] = -(G[1][2] + G[2][2] + G[3][2]);
        *vol = (det < 0 ? -det : det) * (1.0 / 6.0);
        return 0;
    }
    const double* x0 = coords + (int64_t)r[0] * 2;
    const double* x1 = coords + (int64_t)r[1] * 2;
    const double* x2 = coords + (int64_t)r[2] * 2;
    const double a = x1[0] - x0[0], b = x1[1] - x0[1];
    const double p = x2[0] - x0[0], q = x2[1] - x0[1];
    const double det = a * q - b * p;
    if (det == 0.0) return -1;
    const double iv = 1.0 / det;
    G[1][0] = q * iv;  G[1][1] = -p * iv;
    G[2][0] = -b * iv; G[2][1] = a * iv;
    G[0][0] = -(G[1][0] + G[2][0]);
    G[0][1] = -(G[1][1] + G[2][1]);
    *vol = (det < 0 ? -det : det) * 0.5;
    return 0;
}

// ---------------------------------------------------------------------------
// p1_ell_assemble_direct: geometry + consistent-mass/stiffness assembly
// fused in one pass over the cells, straight into a width-bounded padded
// ELL layout with a COO spill for rows that exceed `width` (e.g. the
// welded apex of the LV ellipsoid, degree ~2*n_theta vs the typical ~15).
// The COO pipeline this replaces materializes 16*nc triplets, radix-sorts
// them, and pads every row to the GLOBAL max degree ([n, ~300] at
// production LV resolutions) — minutes of host time and gigabytes moved.
//
// Row entries are kept column-sorted by insertion (binary search +
// memmove; typical row ~15 entries).  Mass and stiffness share the
// pattern by construction.  Spilled (row, col) pairs may repeat across
// cells; the caller dedup-sums the tail (it is tiny).
//
// counts [n], cols/mvals/kvals [n*width] are caller-zeroed.  Returns the
// max row count on success (>= 0); -1 degenerate cell; -2 unsupported d;
// -4 tail capacity exceeded (caller retries with a larger tail_cap).
// tail_n_out receives the tail length.
int64_t p1_ell_assemble_direct(const double* coords, const int32_t* cells,
                               int64_t nc, int32_t d, const double* mc,
                               int64_t mc_stride, int64_t n, int32_t width,
                               int32_t* counts, int32_t* cols, double* mvals,
                               double* kvals, int64_t tail_cap,
                               int64_t* tail_n_out, int32_t* tail_rows,
                               int32_t* tail_cols, double* tail_mvals,
                               double* tail_kvals) {
    (void)n;
    if (d != 2 && d != 3) return -2;
    const int32_t nd = d + 1;
    const double mass_diag = 2.0 / ((double)(d + 1) * (d + 2));
    const double mass_off = 1.0 / ((double)(d + 1) * (d + 2));
    double G[4][3], MG[4][3];
    int64_t tail_n = 0;
    int64_t max_cnt = 0;
    for (int64_t c = 0; c < nc; ++c) {
        const int32_t* r = cells + c * nd;
        const double* M = mc + c * mc_stride;
        double vol;
        if (p1_cell_geom(coords, r, d, &vol, G) != 0) return -1;
        for (int32_t j = 0; j < nd; ++j) {
            for (int32_t a = 0; a < d; ++a) {
                double s = 0.0;
                for (int32_t b = 0; b < d; ++b) s += M[a * d + b] * G[j][b];
                MG[j][a] = s;
            }
        }
        for (int32_t i = 0; i < nd; ++i) {
            const int64_t row = r[i];
            int32_t* rc = cols + row * (int64_t)width;
            double* rm = mvals + row * (int64_t)width;
            double* rk = kvals + row * (int64_t)width;
            for (int32_t j = 0; j < nd; ++j) {
                const int32_t col = r[j];
                const double me = vol * (i == j ? mass_diag : mass_off);
                double ke = 0.0;
                for (int32_t a = 0; a < d; ++a) ke += G[i][a] * MG[j][a];
                ke *= vol;
                const int32_t cnt = counts[row];
                int32_t lo = 0, hi = cnt;
                while (lo < hi) {
                    const int32_t mid = (lo + hi) >> 1;
                    if (rc[mid] < col) lo = mid + 1; else hi = mid;
                }
                if (lo < cnt && rc[lo] == col) {
                    rm[lo] += me;
                    rk[lo] += ke;
                } else if (cnt < width) {
                    const int32_t nmove = cnt - lo;
                    if (nmove > 0) {
                        std::memmove(rc + lo + 1, rc + lo, nmove * sizeof(int32_t));
                        std::memmove(rm + lo + 1, rm + lo, nmove * sizeof(double));
                        std::memmove(rk + lo + 1, rk + lo, nmove * sizeof(double));
                    }
                    rc[lo] = col;
                    rm[lo] = me;
                    rk[lo] = ke;
                    counts[row] = cnt + 1;
                    if (cnt + 1 > max_cnt) max_cnt = cnt + 1;
                } else {
                    if (tail_n >= tail_cap) return -4;
                    tail_rows[tail_n] = (int32_t)row;
                    tail_cols[tail_n] = col;
                    tail_mvals[tail_n] = me;
                    tail_kvals[tail_n] = ke;
                    ++tail_n;
                }
            }
        }
    }
    *tail_n_out = tail_n;
    return max_cnt;
}

// ---------------------------------------------------------------------------
// p1_stencil_assemble_direct: geometry + mass/stiffness scatter fused in a
// single pass over the cells, never materializing the [nc, ...] geometry
// arrays (edges 1.4 GB + grads 1.9 GB at dx=0.05; the host's sustained
// bandwidth is low and erratic, so bytes-not-moved is the lever).  P1,
// tdim == gdim == d in {2, 3}; cell dofs == mesh.cells (int32).
//
// Per cell: edge matrix E, det, physical basis gradients G (rows 1..d =
// inv(E)^T, row 0 = -sum), vol = |det|/d!; then for each local (i, j):
// mst[r_i*K + k(d_ij)] += vol * (1+delta_ij)/((d+1)(d+2)),
// kst[...] += vol * G_i . (M_c G_j).  vol_out (nullable) receives the
// cell volumes as a by-product.
// Returns 0; -1 on an exactly singular cell (degenerate mesh, caller
// raises LinAlgError); -2 on unsupported d; -3 when a dof difference is
// absent from offs (caller bug).
int64_t p1_stencil_assemble_direct(const double* coords, const int32_t* cells,
                                   int64_t nc, int32_t d, const double* mc,
                                   int64_t mc_stride, const int64_t* offs,
                                   int64_t K, double* mst, double* kst,
                                   double* vol_out) {
    if (d != 2 && d != 3) return -2;
    const int32_t nd = d + 1;
    const double mass_diag = 2.0 / ((double)(d + 1) * (d + 2));
    const double mass_off = 1.0 / ((double)(d + 1) * (d + 2));
    double G[4][3], MG[4][3];
    for (int64_t c = 0; c < nc; ++c) {
        const int32_t* r = cells + c * nd;
        const double* M = mc + c * mc_stride;
        double vol;
        if (p1_cell_geom(coords, r, d, &vol, G) != 0) return -1;
        if (vol_out) vol_out[c] = vol;
        for (int32_t j = 0; j < nd; ++j) {
            for (int32_t a = 0; a < d; ++a) {
                double s = 0.0;
                for (int32_t b = 0; b < d; ++b) s += M[a * d + b] * G[j][b];
                MG[j][a] = s;
            }
        }
        for (int32_t i = 0; i < nd; ++i) {
            for (int32_t j = 0; j < nd; ++j) {
                const int64_t dij = (int64_t)r[j] - r[i];
                const int64_t* it = std::lower_bound(offs, offs + K, dij);
                if (it == offs + K || *it != dij) return -3;
                const int64_t idx = (int64_t)r[i] * K + (it - offs);
                mst[idx] += vol * (i == j ? mass_diag : mass_off);
                double ke = 0.0;
                for (int32_t a = 0; a < d; ++a) ke += G[i][a] * MG[j][a];
                kst[idx] += vol * ke;
            }
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// locate_points: containing cell per physical point (barycentric test with
// a bounding-box prefilter), one pass over the cells for ALL points.  The
// numpy path reads the full [nc, d+1, d] inverse-Jacobian array per point
// (~1.9 GB x n_points at dx=0.05); this reads each cell's coords once and
// needs no precomputed geometry.  Already-located points are skipped, so
// the pass ends early once every point is found.
// coords [n, g], cells [nc, d+1] int32, pts [np, g]; out [np] int64
// (-1 = not found).  tdim == gdim == g in {2, 3}.
void locate_points(const double* coords, const int32_t* cells, int64_t nc,
                   int32_t g, const double* pts, int64_t np_, double tol,
                   int64_t* out) {
    const int32_t nd = g + 1;
    for (int64_t p = 0; p < np_; ++p) out[p] = -1;
    int64_t remaining = np_;
    for (int64_t c = 0; c < nc && remaining > 0; ++c) {
        const int32_t* r = cells + c * nd;
        // cell bbox
        double lo[3], hi[3];
        for (int32_t a = 0; a < g; ++a) {
            lo[a] = hi[a] = coords[(int64_t)r[0] * g + a];
        }
        for (int32_t i = 1; i < nd; ++i) {
            const double* x = coords + (int64_t)r[i] * g;
            for (int32_t a = 0; a < g; ++a) {
                lo[a] = std::min(lo[a], x[a]);
                hi[a] = std::max(hi[a], x[a]);
            }
        }
        double inv[3][3];  // inverse edge matrix, computed lazily per cell
        bool have_inv = false;
        for (int64_t p = 0; p < np_; ++p) {
            if (out[p] >= 0) continue;
            const double* pt = pts + p * g;
            bool in_box = true;
            for (int32_t a = 0; a < g; ++a) {
                if (pt[a] < lo[a] - tol || pt[a] > hi[a] + tol) { in_box = false; break; }
            }
            if (!in_box) continue;
            if (!have_inv) {
                const double* x0 = coords + (int64_t)r[0] * g;
                double E[3][3];
                for (int32_t i = 0; i < g; ++i) {
                    const double* xi = coords + (int64_t)r[i + 1] * g;
                    for (int32_t a = 0; a < g; ++a) E[i][a] = xi[a] - x0[a];
                }
                double det;
                if (g == 3) {
                    const double A = E[1][1] * E[2][2] - E[1][2] * E[2][1];
                    const double B = E[1][2] * E[2][0] - E[1][0] * E[2][2];
                    const double C = E[1][0] * E[2][1] - E[1][1] * E[2][0];
                    det = E[0][0] * A + E[0][1] * B + E[0][2] * C;
                    if (det == 0.0) break;  // degenerate cell: skip it
                    const double iv = 1.0 / det;
                    // inv[i][j] = (E^-1)[i][j]; xi = (p - x0) . E^-1 rows?
                    // We need xi = (p - x0) @ inv(E) with xi_i the i-th
                    // reference coordinate: xi = inv(E)^T (p - x0) in
                    // matrix terms where E rows are edges.  Store
                    // inv[i][a] = d xi_i / d x_a = (E^{-1})[a][i].
                    inv[0][0] = A * iv;
                    inv[0][1] = B * iv;
                    inv[0][2] = C * iv;
                    inv[1][0] = (E[0][2] * E[2][1] - E[0][1] * E[2][2]) * iv;
                    inv[1][1] = (E[0][0] * E[2][2] - E[0][2] * E[2][0]) * iv;
                    inv[1][2] = (E[0][1] * E[2][0] - E[0][0] * E[2][1]) * iv;
                    inv[2][0] = (E[0][1] * E[1][2] - E[0][2] * E[1][1]) * iv;
                    inv[2][1] = (E[0][2] * E[1][0] - E[0][0] * E[1][2]) * iv;
                    inv[2][2] = (E[0][0] * E[1][1] - E[0][1] * E[1][0]) * iv;
                } else {
                    det = E[0][0] * E[1][1] - E[0][1] * E[1][0];
                    if (det == 0.0) break;
                    const double iv = 1.0 / det;
                    inv[0][0] = E[1][1] * iv;
                    inv[0][1] = -E[1][0] * iv;
                    inv[1][0] = -E[0][1] * iv;
                    inv[1][1] = E[0][0] * iv;
                }
                have_inv = true;
            }
            const double* x0 = coords + (int64_t)r[0] * g;
            double xi[3], lam0 = 1.0;
            bool inside = true;
            for (int32_t i = 0; i < g; ++i) {
                double s = 0.0;
                for (int32_t a = 0; a < g; ++a) s += inv[i][a] * (pt[a] - x0[a]);
                xi[i] = s;
                lam0 -= s;
                if (s < -tol) { inside = false; break; }
            }
            if (inside && lam0 >= -tol) {
                out[p] = c;
                --remaining;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// rcm_ordering: reverse Cuthill-McKee over a CSR adjacency graph
// (bandwidth-reducing node permutation; improves gather locality of a
// partitioned SpMV).  perm_out[new_index] = old_index.
void rcm_ordering(const int64_t* indptr, const int32_t* indices, int64_t n,
                  int32_t* perm_out) {
    std::vector<int64_t> degree(n);
    for (int64_t i = 0; i < n; ++i) degree[i] = indptr[i + 1] - indptr[i];
    std::vector<uint8_t> visited(n, 0);
    std::vector<int32_t> order;
    order.reserve(n);
    std::vector<int32_t> queue;
    std::vector<int64_t> cand;

    for (;;) {
        // next unvisited node of minimum degree (new component seed)
        int64_t seed = -1, best = INT64_MAX;
        for (int64_t i = 0; i < n; ++i) {
            if (!visited[i] && degree[i] < best) {
                best = degree[i];
                seed = i;
            }
        }
        if (seed < 0) break;
        queue.clear();
        queue.push_back((int32_t)seed);
        visited[seed] = 1;
        size_t head = 0;
        while (head < queue.size()) {
            int32_t u = queue[head++];
            order.push_back(u);
            cand.clear();
            for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
                int32_t v = indices[e];
                if (!visited[v]) {
                    visited[v] = 1;
                    cand.push_back(v);
                }
            }
            // stable: ties keep their CSR order, as the numpy twin's sorted()
            std::stable_sort(cand.begin(), cand.end(), [&degree](int64_t a, int64_t b) {
                return degree[a] < degree[b];
            });
            for (int64_t v : cand) queue.push_back((int32_t)v);
        }
    }
    // reverse
    for (int64_t i = 0; i < n; ++i) perm_out[i] = order[n - 1 - i];
}

}  // extern "C"
