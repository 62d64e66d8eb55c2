// The port's copy of ipx_tpu/native/ipxlu.cc.
// ipxlu — sparse LU kernel for basis matrices.
//
// Native host-side component of the ipx_tpu solver, providing the capability
// the reference solver gets from the external BASICLU package (used through
// reference: src/basiclu_wrapper.cc): factorization of an m-by-m basis matrix
// given column-wise, hypersparse triangular solves (FTRAN/BTRAN with sparse
// right-hand sides via depth-first reach), and factorization updates when one
// basis column is exchanged.
//
// Design (written from scratch, not derived from BASICLU):
//  * Right-looking Markowitz factorization with threshold partial pivoting:
//    pivot search over column count classes in increasing order, choosing the
//    eligible entry (|a_ij| >= pivottol * colmax_j) with minimum Markowitz
//    count (colcount-1)*(rowcount-1); bounded search effort.
//  * Columns whose largest active entry is <= an absolute tolerance are
//    treated as dependent and replaced by unit columns (rank detection
//    contract of reference: src/lu_update.h:20-40).
//  * Updates use the product form of the inverse (PFI): each exchange appends
//    an elementary eta; refactorization is recommended once the accumulated
//    eta size exceeds the factor size or after m updates. (The reference
//    wraps Forrest-Tomlin updates with the same cost-driven refresh policy,
//    reference: src/basiclu_wrapper.cc:278-287.)
//
// All solves operate in "position space" (pivot order). rowperm/colperm map
// positions to original row indices / basis positions:
//   B[rowperm[k], colperm[l]] = ((L+I)*U)[k, l].
//
// The C API at the bottom is consumed from Python via ctypes
// (ipx_tpu/basis/lu.py).

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <limits>
#include <queue>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#include <cstdlib>
// On small VMs the Linux scheduler can leave both members of an OpenMP team
// timesharing ONE cpu (measured here: 20x slowdown of every parallel
// region). Binding threads to distinct places fixes it; libgomp reads the
// environment at first team creation, so set it at dlopen time unless the
// user chose a policy.
__attribute__((constructor)) static void ipxlu_bind_omp_threads() {
    setenv("OMP_PROC_BIND", "spread", /*overwrite=*/0);
}
#endif

typedef int64_t ipxint;

namespace {

struct SparseCols {
    // simple CSC container in position space. Indices are int32 (positions
    // are < m < 2^31): the triangular solves are memory-latency/bandwidth
    // bound and halving the index traffic is a measurable win on large
    // factors.
    std::vector<ipxint> ptr;
    std::vector<int32_t> idx;
    std::vector<double> val;
    void clear(ipxint n) { ptr.assign(n + 1, 0); idx.clear(); val.clear(); }
};

struct Eta {
    ipxint pos;                  // basis position whose column was replaced
    double diag;                 // w[pos]
    std::vector<ipxint> idx;     // off-diagonal pattern (basis positions)
    std::vector<double> val;
};

// Forrest-Tomlin row eta: the row transformation [I 0; -alpha' 1] recorded
// when the spiked row is eliminated from U (reference concept:
// src/forrest_tomlin.cc:304-360; this implementation is written against
// this kernel's position-space factor layout, not the reference's).
struct FtEta {
    ipxint target;               // position of the eliminated row
    std::vector<int32_t> pos;    // positions k with alpha_k != 0
    std::vector<double> alpha;
};

struct IpxLu {
    ipxint m = 0;
    double pivottol = 0.0625;

    // factors in position space
    SparseCols L, U;             // L strictly lower (unit diag implicit),
                                 // U strictly upper; diag separate
    SparseCols Lt, Ut;           // row-wise (transposed) copies
    std::vector<double> Udiag;
    std::vector<ipxint> rowperm, colperm;      // position -> row / column
    std::vector<ipxint> rowperm_inv, colperm_inv;
    std::vector<ipxint> dependent;             // positions patched to unit
    ipxint factor_nnz = 0;
    ipxint bnnz = 0;
    bool have_factors = false;

    // update mode: 0 = product-form (PFI) etas, 1 = Forrest-Tomlin
    // (lu_kernel=1 in the parameters; reference: src/basis.cc:24-29)
    int update_mode = 0;

    // --- Forrest-Tomlin state (all in position space of the fresh
    // factors; logical pivot order tracked separately so no physical
    // permutation of the factor files is ever needed) ---
    bool ft_valid = false;
    std::vector<ipxint> ft_order;    // order[t] = position of t-th pivot
    std::vector<ipxint> ft_opos;     // position -> order index
    // dynamic U column file: per position, (row position | -1 tombstone,
    // value); replaced columns bump their generation so row-file entries
    // referencing them become stale
    std::vector<std::vector<int32_t>> ftU_ri;
    std::vector<std::vector<double>> ftU_rv;
    std::vector<double> ftU_diag;
    std::vector<int32_t> ft_colgen;
    // row file: per row position, (column position, entry slot in that
    // column's file, column generation at insert)
    std::vector<std::vector<int32_t>> ftR_ci, ftR_pp, ftR_cg;
    std::vector<FtEta> ft_etas;
    std::vector<double> ft_spike;    // FTRAN intermediate before the U
    bool ft_spike_dense = true;      // spike array written densely last
    std::vector<ipxint> ft_spike_pat;  // else its nonzero positions
    // PFI eta reader index: for each position p, the etas whose transposed
    // application READS p (p in idx(e) or p == pos(e)); lets the sparse
    // BTRAN touch only etas intersecting its pattern instead of scanning
    // the whole chain per solve. Rebuilt empty at factorize.
    std::vector<std::vector<int32_t>> eta_rd;
    std::vector<ipxint> eta_stamp;   // per-eta dedupe stamps
    ipxint eta_stampval = 0;
                                     // solve (= L'^{-1} a), position space
    std::vector<double> ft_rwork;    // row-elimination accumulator (zeroed)
    ipxint ftU_nnz0 = 0, ftU_nnz = 0, ftR_nnz = 0;

    // PFI update state
    std::vector<Eta> etas;
    ipxint eta_nnz = 0;
    // Measured wall-clock seconds spent applying the eta chain since the
    // last factorization. Every solve pays for the chain even when the
    // triangular part is hypersparse, so once this exceeds the (also
    // measured) cost of a refactorization, refreshing amortizes — the same
    // cost-driven refresh idea as the reference's update_cost test
    // (reference: src/basiclu_wrapper.cc:278-287), but with both sides of
    // the trade measured rather than modeled.
    double t_eta = 0.0;

    // pending update data
    std::vector<double> ftran_sol;   // dense, basis-position space
    bool ftran_sol_dense = true;     // written densely last time
    std::vector<ipxint> ftran_sol_pat;  // else its nonzero positions
    bool xw_ft_dense = true;         // ditto for the xw_ft workspace
    ipxint xw_ft_nz = -1;
    std::vector<ipxint> ftran_pat;
    bool ftran_pat_valid = false;
    bool have_ftran = false;
    ipxint btran_pos = -1;

    // workspaces. `work` is reserved for the sparse solve paths and must be
    // all-zero between calls; dense solves use workd/work2.
    std::vector<double> work;        // sparse-path accumulator (kept zero)
    std::vector<double> works;       // 2nd sparse-path accumulator (kept zero)
    std::vector<double> workd;       // dense-path accumulator
    std::vector<double> work2;
    std::vector<ipxint> stack, flag, pattern;
    std::vector<ipxint> spat2, spat3;   // sparse-solve pattern workspaces
    ipxint flagstamp = 0;

    // stats of last solves (for hypersparsity accounting in the wrapper)
    ipxint last_nz = -1;

    // factorization phase timings (seconds, accumulated)
    double t_search = 0.0, t_elim = 0.0, t_build = 0.0;
    double t_s_scan = 0.0, t_s_col = 0.0, t_s_row = 0.0;
    ipxint n_steps = 0;
    long long n_cloop = 0, n_cvisit = 0, n_centry = 0;
    double t_mv_scan = 0.0; long long n_mv_scans = 0;
    double t_last_factorize = 0.0;   // wall clock of the last factorize()
    ipxint elim_stamp = 0;        // monotone stamp counter (never reset)

    // factorization workspaces reused across calls (capacity persists)
    std::vector<std::vector<ipxint>> f_colrow, f_rowpat, f_Lrows, f_Ucols;
    std::vector<std::vector<double>> f_colval, f_Lvals, f_Uvals;
    std::vector<ipxint> f_rowcount, f_wpos, f_stamp, f_rstamp, f_sstamp;
    std::vector<char> f_colpiv, f_rowpiv;
    std::vector<double> f_colmax;      // cached per-column max |value|
    std::vector<char> f_cmvalid;

    // bound model (raw pointers owned by the Python side; arrays are kept
    // alive by the caller for the lifetime of the binding) + concatenated
    // basis-column storage [A | I] for native refactorization
    ipxint mb_n = -1;
    const ipxint *mb_Ap = nullptr, *mb_Ai = nullptr;
    const double* mb_Ax = nullptr;
    const ipxint *mb_ARp = nullptr, *mb_ARi = nullptr;
    const double* mb_ARx = nullptr;
    std::vector<ipxint> mb_Bi;     // A row indices + slack unit block
    std::vector<double> mb_Bx;
    std::vector<ipxint> mb_begin, mb_end;

    // crossover / push-loop workspaces
    std::vector<double> xw_row;        // n+m accumulator
    std::vector<ipxint> xw_rowpat, xw_rowstamp;
    ipxint xw_rowstampval = 0;
    std::vector<double> xw_bt, xw_ft;
    std::vector<ipxint> xw_btpat, xw_ftpat;

    // Blocked candidate FTRANs (multi-RHS): when solves run dense (high
    // fill), the factor traversal dominates and is identical for every
    // rhs, so candidate columns known ahead (maxvolume / drop-dual lists)
    // are solved TOGETHER in one blocked pass (row-major m x W so the
    // per-entry axpy vectorizes over the block), then corrected per
    // consumption by applying only the etas appended since the block was
    // built. No reference counterpart (BASICLU solves one rhs at a time).
    std::vector<double> bb_X;          // slot space, row-major (m, bb_W)
    std::vector<ipxint> bb_cols;       // candidate column per slot, -1 used
    ipxint bb_W = 0;
    size_t bb_eta_base = 0;            // etas already applied to the block
    ipxint bb_gen = -1;                // factorization generation of block
    ipxint factor_gen = 0;             // bumped by every factorize()

    // splitted-normal operator state for the phase-2 CR loop
    // (counterpart of reference: src/splitted_normal_matrix.{h,cc}):
    // N is the nonbasic partition of AI in ORIGINAL row space, columns
    // scaled; uscale scales the basic columns per basis slot; freepos are
    // the BASIC_FREE slots whose rows/columns of C are unit vectors. The
    // operator runs through the eta-aware FTRAN/BTRAN, so it works on a
    // STALE factorization plus updates — a refactorization is only taken
    // when cost-driven (need_fresh), unlike the reference which requires
    // fresh factors each IPM iteration (reference:
    // src/kkt_solver_basis.cc:58-66). Row indices are int32 to halve index
    // traffic in the NN' product.
    std::vector<ipxint> Nptr;
    std::vector<int32_t> Nidx;
    std::vector<double> Nval;
    std::vector<double> uscale;
    std::vector<ipxint> freepos;
    bool have_splitted = false;
    double t_B = 0.0, t_Bt = 0.0, t_NNt = 0.0;
    std::vector<double> s_w, s_wr, s_res, s_Cres, s_step, s_Cstep;
};

// clears inner vectors, keeping their heap capacity
template <typename T>
static void reset_nested(std::vector<std::vector<T>>& v, size_t n) {
    v.resize(n);
    for (auto& inner : v) inner.clear();
}

// ---------------------------------------------------------------------
// Factorization
// ---------------------------------------------------------------------

struct CountList {
    // doubly-linked lists of indices bucketed by count, plus a bitset over
    // class occupancy so "next nonempty class >= c" is a find-first-set
    // scan instead of a linear probe (the linear probe was measured at
    // 1.3e9 iterations on a 40k network crash basis whose occupied classes
    // are sparse in count-space)
    std::vector<ipxint> head, next, prev, count;
    std::vector<uint64_t> bits;
    void init(ipxint n) {
        head.assign(n + 2, -1);
        next.assign(n, -1);
        prev.assign(n, -1);
        count.assign(n, 0);
        bits.assign(((size_t)n + 2 + 63) / 64, 0);
    }
    inline void set_bit(ipxint c) { bits[c >> 6] |= 1ull << (c & 63); }
    inline void clear_bit(ipxint c) { bits[c >> 6] &= ~(1ull << (c & 63)); }
    void insert(ipxint j, ipxint c) {
        count[j] = c;
        next[j] = head[c];
        prev[j] = -1;
        if (head[c] >= 0) prev[head[c]] = j;
        else set_bit(c);
        head[c] = j;
    }
    void remove(ipxint j) {
        ipxint c = count[j];
        if (c < 0) return;              // not in any list
        if (prev[j] >= 0) next[prev[j]] = next[j];
        else {
            head[c] = next[j];
            if (head[c] < 0) clear_bit(c);
        }
        if (next[j] >= 0) prev[next[j]] = prev[j];
        next[j] = prev[j] = -1;
        count[j] = -1;
    }
    void update(ipxint j, ipxint c) { remove(j); insert(j, c); }
    bool contains(ipxint j) const { return count[j] >= 0; }
    // smallest nonempty class index >= c, or -1 if none
    ipxint next_nonempty(ipxint c) const {
        if (c < 0) c = 0;
        size_t w = (size_t)c >> 6;
        if (w >= bits.size()) return -1;
        uint64_t word = bits[w] & (~0ull << (c & 63));
        while (true) {
            if (word)
                return (ipxint)((w << 6) + __builtin_ctzll(word));
            if (++w >= bits.size()) return -1;
            word = bits[w];
        }
    }
};

static void ft_build(IpxLu& lu);   // defined with the FT machinery below

// Builds factors from the active-matrix elimination. Returns status bits:
// bit 0 (1): numerically unstable (not detected here; caller tests),
// bit 1 (2): singular, dependent columns replaced by unit columns.
int factorize(IpxLu& lu, const ipxint* Bbegin, const ipxint* Bend,
              const ipxint* Bi, const double* Bx, int strict_abs) {
    const ipxint m = lu.m;
    const double t_fact0 = std::chrono::duration<double>(
        std::chrono::steady_clock::now().time_since_epoch()).count();
    const double abstol = strict_abs ? 1e-3 : 1e-14;  // kLuDependencyTol
    lu.ft_valid = false;      // rebuilt at the end when update_mode == 1
    lu.etas.clear();
    reset_nested(lu.eta_rd, m);
    lu.eta_stamp.clear();
    lu.eta_nnz = 0;
    lu.t_eta = 0.0;
    lu.have_ftran = false;
    lu.btran_pos = -1;
    lu.dependent.clear();

    // ---- load B into dynamic column structure (workspaces reused) ----
    reset_nested(lu.f_colrow, m);
    reset_nested(lu.f_colval, m);
    reset_nested(lu.f_rowpat, m);
    auto& colrow = lu.f_colrow;
    auto& colval = lu.f_colval;
    auto& rowpat = lu.f_rowpat;
    lu.f_rowcount.assign(m, 0);
    auto& rowcount = lu.f_rowcount;
    ipxint bnnz = 0;
    for (ipxint j = 0; j < m; j++) {
        ipxint len = Bend[j] - Bbegin[j];
        colrow[j].reserve(len);
        colval[j].reserve(len);
        for (ipxint p = Bbegin[j]; p < Bend[j]; p++) {
            if (Bx[p] == 0.0) continue;
            colrow[j].push_back(Bi[p]);
            colval[j].push_back(Bx[p]);
            rowpat[Bi[p]].push_back(j);
            rowcount[Bi[p]]++;
            bnnz++;
        }
    }
    lu.bnnz = bnnz > 0 ? bnnz : 1;

    CountList clist;
    clist.init(m);
    for (ipxint j = 0; j < m; j++)
        clist.insert(j, (ipxint)colrow[j].size());

    lu.f_colpiv.assign(m, 0);
    lu.f_rowpiv.assign(m, 0);
    auto& colpivotal = lu.f_colpiv;
    auto& rowpivotal = lu.f_rowpiv;
    lu.rowperm.assign(m, -1);
    lu.colperm.assign(m, -1);
    lu.rowperm_inv.assign(m, -1);
    lu.colperm_inv.assign(m, -1);
    lu.Udiag.assign(m, 0.0);

    // raw factor storage during elimination (original row / column indices)
    reset_nested(lu.f_Lrows, m);
    reset_nested(lu.f_Lvals, m);
    reset_nested(lu.f_Ucols, m);
    reset_nested(lu.f_Uvals, m);
    auto& Lrows = lu.f_Lrows;
    auto& Lvals = lu.f_Lvals;
    auto& Ucols = lu.f_Ucols;
    auto& Uvals = lu.f_Uvals;

    // dense workspaces for column updates
    lu.f_wpos.assign(m, -1);
    lu.f_stamp.assign(m, -1);
    lu.f_rstamp.assign(m, -1);
    lu.f_sstamp.assign(m, -1);
    lu.f_colmax.assign(m, 0.0);
    lu.f_cmvalid.assign(m, 0);
    auto& wpos = lu.f_wpos;
    auto& stamp = lu.f_stamp;
    auto& rstamp = lu.f_rstamp;
    auto& sstamp = lu.f_sstamp;
    auto& colmax_c = lu.f_colmax;
    auto& cmvalid = lu.f_cmvalid;

    // row count list for the bidirectional Markowitz search
    CountList rlist;
    rlist.init(m);
    for (ipxint i = 0; i < m; i++)
        rlist.insert(i, rowcount[i]);

    auto get_colmax = [&](ipxint j) -> double {
        if (!cmvalid[j]) {
            double cm = 0.0;
            for (double v : colval[j]) cm = std::max(cm, std::fabs(v));
            colmax_c[j] = cm;
            cmvalid[j] = 1;
        }
        return colmax_c[j];
    };

    // Caps on the Markowitz search effort per pivot step (overridable for
    // experiments via IPXLU_SEARCH_CAPS="classes,cols,rows"). Measured
    // round 4: 2/4/2 gives the same fill as 3/16/8 on every family
    // (network fill 1.0, staircase 1.9-2.0, dense-fill 10.2) at half the
    // search cost — the count-class ordering already concentrates good
    // pivots in the first few candidates.
    ipxint kClassCap = 2;      // count classes examined per side
    ipxint kColCap = 4;        // columns per class
    ipxint kRowCap = 2;        // rows per class
    if (const char* caps = std::getenv("IPXLU_SEARCH_CAPS")) {
        long a, b2, c2;
        if (std::sscanf(caps, "%ld,%ld,%ld", &a, &b2, &c2) == 3) {
            kClassCap = (ipxint)a;
            kColCap = (ipxint)b2;
            kRowCap = (ipxint)c2;
        }
    }

    auto now_s2 = []() {
        return std::chrono::duration<double>(
            std::chrono::steady_clock::now().time_since_epoch()).count();
    };

    // Dense-tail switch: when the active submatrix becomes dense enough,
    // sparse elimination's per-entry bookkeeping dominates; finish with a
    // contiguous dense partial-pivoting elimination (vectorizable axpys).
    const ipxint kDenseTailMax = 2048;     // memory cap (r^2 doubles)
    const double kDenseTailFrac = 0.20;    // active density trigger

    ipxint rank = 0;
    for (ipxint k = 0; k < m; k++) {
        // check the dense-tail trigger periodically
        if ((k & 63) == 0 && m - rank <= kDenseTailMax && rank > 0) {
            ipxint r = 0;
            ipxint act = 0;
            for (ipxint j = 0; j < m; j++)
                if (!colpivotal[j]) {
                    r++;
                    act += (ipxint)colrow[j].size();
                }
            if (r > 0 && act > kDenseTailFrac * (double)r * (double)r) {
                double t0d = now_s2();
                // gather remaining rows/cols
                std::vector<ipxint> rrows, rcols;
                rrows.reserve(r);
                rcols.reserve(r);
                for (ipxint i = 0; i < m; i++)
                    if (!rowpivotal[i]) rrows.push_back(i);
                for (ipxint j = 0; j < m; j++)
                    if (!colpivotal[j]) rcols.push_back(j);
                const ipxint nr = (ipxint)rrows.size();
                const ipxint nc = (ipxint)rcols.size();
                std::vector<ipxint> rowof(m, -1);
                for (ipxint t = 0; t < nr; t++) rowof[rrows[t]] = t;
                // dense block, column-major
                std::vector<double> D((size_t)nr * nc, 0.0);
                for (ipxint t = 0; t < nc; t++) {
                    ipxint j = rcols[t];
                    double* col = D.data() + (size_t)t * nr;
                    for (size_t q = 0; q < colrow[j].size(); q++)
                        col[rowof[colrow[j][q]]] = colval[j][q];
                    colrow[j].clear();
                    colval[j].clear();
                }
                // dense elimination with row swaps; dependent columns are
                // swapped to the end of the active range
                std::vector<ipxint> rmap(rrows);   // dense row -> original
                ipxint width = nc;
                ipxint t = 0;
                while (t < width) {
                    ipxint kk = rank;   // next factor position
                    double* col = D.data() + (size_t)t * nr;
                    // pivot row: max |entry| in rows t..nr-1... rows are
                    // consumed top-down in step order (step index = t)
                    ipxint step = t;
                    double best = 0.0;
                    ipxint pr = -1;
                    for (ipxint i = step; i < nr; i++) {
                        double a = std::fabs(col[i]);
                        if (a > best) { best = a; pr = i; }
                    }
                    if (pr < 0 || best <= abstol) {
                        // dependent: swap column to the end of the range
                        width--;
                        if (t != width) {
                            double* last = D.data() + (size_t)width * nr;
                            std::swap_ranges(col, col + nr, last);
                            std::swap(rcols[t], rcols[width]);
                        }
                        continue;
                    }
                    // swap pivot row into position `step`
                    if (pr != step) {
                        for (ipxint q = t; q < nc; q++) {
                            double* cq = D.data() + (size_t)q * nr;
                            std::swap(cq[step], cq[pr]);
                        }
                        std::swap(rmap[step], rmap[pr]);
                    }
                    const double piv = col[step];
                    const ipxint jorig = rcols[t];
                    const ipxint rorig = rmap[step];
                    lu.rowperm[kk] = rorig;
                    lu.colperm[kk] = jorig;
                    lu.rowperm_inv[rorig] = kk;
                    lu.colperm_inv[jorig] = kk;
                    lu.Udiag[kk] = piv;
                    rowpivotal[rorig] = 1;
                    colpivotal[jorig] = 1;
                    clist.remove(jorig);
                    rlist.remove(rorig);
                    rank++;
                    auto& Lr = Lrows[kk];
                    auto& Lv = Lvals[kk];
                    for (ipxint i = step + 1; i < nr; i++) {
                        double v = col[i];
                        if (v != 0.0) {
                            Lr.push_back(rmap[i]);
                            Lv.push_back(v / piv);
                            col[i] = v / piv;   // keep multiplier in place
                        }
                    }
                    auto& Uc = Ucols[kk];
                    auto& Uv = Uvals[kk];
                    // rank-1 update of the trailing block + record U row
                    for (ipxint q = t + 1; q < width; q++) {
                        double* cq = D.data() + (size_t)q * nr;
                        double u = cq[step];
                        if (u != 0.0) {
                            Uc.push_back(rcols[q]);
                            Uv.push_back(u);
                            for (ipxint i = step + 1; i < nr; i++)
                                cq[i] -= col[i] * u;
                        }
                    }
                    t++;
                }
                lu.t_elim += now_s2() - t0d;
                break;      // post-loop handles any remaining (dependent)
            }
        }
        double t0_ = now_s2();
        lu.n_steps++;
        // ---- bidirectional Markowitz pivot search ----
        // Examine the smallest nonempty column AND row count classes
        // (bounded effort), choosing the eligible entry with minimum
        // (ccount-1)*(rcount-1); |value| breaks ties. The optimal bound
        // (cmin-1)*(rmin-1) allows early exit.
        ipxint bestcol = -1, bestrow = -1;
        double bestval = 0.0;
        ipxint bestmark = -1;

        ipxint cmin = clist.next_nonempty(1);
        if (cmin < 0) cmin = m + 1;
        ipxint rmin = rlist.next_nonempty(1);
        if (rmin < 0) rmin = m + 1;
        lu.t_s_scan += now_s2() - t0_;
        double ts_col0 = now_s2();
        const ipxint lower_bound = (cmin <= m && rmin <= m)
            ? (cmin - 1) * (rmin - 1) : 0;

        auto consider = [&](ipxint j, ipxint i, double val, ipxint mark) {
            if (bestmark < 0 || mark < bestmark ||
                (mark == bestmark && std::fabs(val) > std::fabs(bestval))) {
                bestmark = mark; bestcol = j; bestrow = i; bestval = val;
            }
        };

        // column classes
        ipxint classes = 0;
        for (ipxint c = cmin; c >= 0 && c <= m && classes < kClassCap;
             c = clist.next_nonempty(c + 1)) {
            lu.n_cloop++;
            classes++;
            if (bestmark >= 0 && (c - 1) * (rmin - 1) >= bestmark)
                break;
            ipxint seen = 0;
            for (ipxint j = clist.head[c]; j >= 0 && seen < kColCap;
                 j = clist.next[j], seen++) {
                lu.n_cvisit++;
                double cm = get_colmax(j);
                if (cm <= abstol) continue;
                double thresh = lu.pivottol * cm;
                lu.n_centry += (long long)colrow[j].size();
                for (size_t t = 0; t < colrow[j].size(); t++) {
                    double av = std::fabs(colval[j][t]);
                    if (av >= thresh) {
                        ipxint i = colrow[j][t];
                        consider(j, i, colval[j][t],
                                 (c - 1) * (rowcount[i] - 1));
                    }
                }
                if (bestmark == lower_bound) break;
            }
            if (bestmark == lower_bound) break;
        }

        lu.t_s_col += now_s2() - ts_col0;
        double ts_row0 = now_s2();
        // row classes (skip if already optimal)
        if (bestmark != lower_bound) {
            lu.flagstamp++;   // reuse global stamp for row-pattern dedupe
            classes = 0;
            for (ipxint rc = rmin; rc >= 0 && rc <= m && classes < kClassCap;
                 rc = rlist.next_nonempty(rc + 1)) {
                classes++;
                if (bestmark >= 0 && (cmin - 1) * (rc - 1) >= bestmark)
                    break;
                ipxint seen = 0;
                ipxint i = rlist.head[rc];
                while (i >= 0 && seen < kRowCap) {
                    ipxint inext = rlist.next[i];
                    if (rowcount[i] != rc) {
                        // stale class entry: re-file and skip
                        rlist.update(i, rowcount[i]);
                        i = inext;
                        continue;
                    }
                    seen++;
                    for (ipxint j : rowpat[i]) {
                        if (colpivotal[j] || sstamp[j] == lu.flagstamp)
                            continue;
                        sstamp[j] = lu.flagstamp;
                        double cm = get_colmax(j);
                        if (cm <= abstol) continue;
                        // find a_ij
                        double aij = 0.0;
                        bool found = false;
                        for (size_t t = 0; t < colrow[j].size(); t++)
                            if (colrow[j][t] == i) {
                                aij = colval[j][t];
                                found = true;
                                break;
                            }
                        if (!found) continue;
                        if (std::fabs(aij) >= lu.pivottol * cm)
                            consider(j, i,
                                     aij, ((ipxint)colrow[j].size() - 1)
                                     * (rc - 1));
                    }
                    if (bestmark == lower_bound) break;
                    i = inext;
                }
                if (bestmark == lower_bound) break;
            }
        }
        lu.t_s_row += now_s2() - ts_row0;
        lu.t_search += now_s2() - t0_;
        if (bestcol < 0)
            break;      // no eligible pivot: remaining columns dependent
        t0_ = now_s2();

        const ipxint r = bestrow, jc = bestcol;
        const double pivval = bestval;
        lu.rowperm[k] = r;
        lu.colperm[k] = jc;
        lu.rowperm_inv[r] = k;
        lu.colperm_inv[jc] = k;
        lu.Udiag[k] = pivval;
        rowpivotal[r] = 1;
        colpivotal[jc] = 1;
        clist.remove(jc);
        rlist.remove(r);
        rank++;

        // ---- form L column (multipliers) ----
        auto& Lr = Lrows[k];
        auto& Lv = Lvals[k];
        for (size_t t = 0; t < colrow[jc].size(); t++) {
            ipxint i = colrow[jc][t];
            if (i == r) continue;
            Lr.push_back(i);
            Lv.push_back(colval[jc][t] / pivval);
            rowcount[i]--;          // rlist revalidated lazily in the search
        }
        rowcount[r] -= 1;
        colrow[jc].clear(); colval[jc].clear();

        // ---- process pivot row: collect U entries, then update columns ----
        auto& Uc = Ucols[k];
        auto& Uv = Uvals[k];
        for (ipxint j : rowpat[r]) {
            if (colpivotal[j] || rstamp[j] == k) continue;
            rstamp[j] = k;
            // Single pass over the column: stamp+record positions for the
            // L merge below AND locate entry (r, j). A monotone stamp
            // counter uniquely marks this (pivot, column) pass, so no
            // clear pass is needed afterwards.
            auto& cr = colrow[j];
            auto& cv = colval[j];
            const ipxint sv = ++lu.elim_stamp;
            ipxint found = -1;
            for (size_t t = 0; t < cr.size(); t++) {
                ipxint i = cr[t];
                stamp[i] = sv;
                wpos[i] = (ipxint)t;
                if (i == r) found = (ipxint)t;
            }
            if (found < 0) continue;          // stale pattern entry
            double u = cv[found];
            cr[found] = cr.back(); cr.pop_back();
            cv[found] = cv.back(); cv.pop_back();
            if (found < (ipxint)cr.size())
                wpos[cr[found]] = found;       // swapped-in entry moved
            Uc.push_back(j);
            Uv.push_back(u);

            // column update: col_j -= u * Lcol (L never contains row r, so
            // the stale stamp[r] entry is never consulted).
            for (size_t t = 0; t < Lr.size(); t++) {
                ipxint i = Lr[t];
                double delta = -Lv[t] * u;
                if (stamp[i] == sv) {
                    cv[wpos[i]] += delta;
                } else {
                    cr.push_back(i);
                    cv.push_back(delta);
                    rowpat[i].push_back(j);
                    rowcount[i]++;  // rlist revalidated lazily
                }
            }
            clist.update(j, (ipxint)cr.size());
            cmvalid[j] = 0;
        }
        rowpat[r].clear();
        lu.t_elim += now_s2() - t0_;
    }
    double tb0_ = now_s2();

    int status = 0;
    if (rank < m) {
        status |= 2;
        // pair leftover rows and columns arbitrarily; unit pivots
        std::vector<ipxint> freerows, freecols;
        for (ipxint i = 0; i < m; i++)
            if (!rowpivotal[i]) freerows.push_back(i);
        for (ipxint j = 0; j < m; j++)
            if (!colpivotal[j]) freecols.push_back(j);
        ipxint k = rank;
        for (size_t t = 0; t < freerows.size(); t++, k++) {
            lu.rowperm[k] = freerows[t];
            lu.colperm[k] = freecols[t];
            lu.rowperm_inv[freerows[t]] = k;
            lu.colperm_inv[freecols[t]] = k;
            lu.Udiag[k] = 1.0;
            lu.dependent.push_back(k);
        }
        // Dependent columns are replaced by unit columns in L*U: remove any
        // U entries recorded for them during elimination so that column k of
        // (L+I)U is exactly e_k (contract of reference: src/lu_update.h:43-60).
        std::vector<char> depcol(m, 0);
        for (ipxint d : lu.dependent) depcol[d] = 1;
        for (ipxint kk = 0; kk < m; kk++) {
            auto& uc = Ucols[kk];
            auto& uv = Uvals[kk];
            size_t keep = 0;
            for (size_t t = 0; t < uc.size(); t++) {
                if (!depcol[lu.colperm_inv[uc[t]]]) {
                    uc[keep] = uc[t];
                    uv[keep] = uv[t];
                    keep++;
                }
            }
            uc.resize(keep);
            uv.resize(keep);
        }
    }

    // ---- convert raw factors to position-space CSC + CSR ----
    // Column entries are left UNSORTED: every consumer (dense and DFS
    // triangular solves, transpose construction, scatter products) is
    // order-independent, and skipping the per-column sort saves ~20% of
    // factorization time at high fill. ipxlu_get_factors' Python caller
    // sorts on conversion to scipy.
    auto build = [&](std::vector<std::vector<ipxint>>& ridx,
                     std::vector<std::vector<double>>& rval,
                     const std::vector<ipxint>& perm_inv,
                     SparseCols& C, SparseCols& Ct) {
        ipxint nnz = 0;
        for (ipxint k = 0; k < m; k++) nnz += (ipxint)ridx[k].size();
        C.ptr.assign(m + 1, 0);
        C.idx.resize(nnz); C.val.resize(nnz);
        // column k holds entries with positions perm_inv[orig]
        ipxint p = 0;
        for (ipxint k = 0; k < m; k++) {
            C.ptr[k] = p;
            for (size_t t = 0; t < ridx[k].size(); t++) {
                C.idx[p] = perm_inv[ridx[k][t]];
                C.val[p] = rval[k][t];
                p++;
            }
            ridx[k].clear(); rval[k].clear();
        }
        C.ptr[m] = p;
        // transpose
        Ct.ptr.assign(m + 1, 0);
        Ct.idx.resize(nnz); Ct.val.resize(nnz);
        std::vector<ipxint> cnt(m + 1, 0);
        for (ipxint t = 0; t < nnz; t++) cnt[C.idx[t] + 1]++;
        for (ipxint i = 0; i < m; i++) cnt[i + 1] += cnt[i];
        for (ipxint i = 0; i <= m; i++) Ct.ptr[i] = cnt[i];
        std::vector<ipxint> fill(cnt.begin(), cnt.end());
        for (ipxint k = 0; k < m; k++)
            for (ipxint t = C.ptr[k]; t < C.ptr[k + 1]; t++) {
                ipxint q = fill[C.idx[t]]++;
                Ct.idx[q] = k;
                Ct.val[q] = C.val[t];
            }
    };
    // L columns: entries are original rows -> positions (assigned later steps)
    build(Lrows, Lvals, lu.rowperm_inv, lu.L, lu.Lt);
    // U rows: entries are original cols -> positions; U is stored row-wise
    // first (Ucols[k] = row k of U), i.e. build gives CSR in lu.Ut... build
    // treats input as columns; passing rows yields the transpose, so:
    build(Ucols, Uvals, lu.colperm_inv, lu.Ut, lu.U);

    lu.t_build += now_s2() - tb0_;
    lu.t_last_factorize = now_s2() - t_fact0;
    lu.factor_gen++;                   // invalidates candidate ftran blocks
    lu.factor_nnz = (ipxint)(lu.L.idx.size() + lu.U.idx.size()) + m;
    lu.have_factors = true;
    lu.work.assign(m, 0.0);
    lu.works.assign(m, 0.0);
    lu.workd.assign(m, 0.0);
    lu.work2.assign(m, 0.0);
    lu.stack.resize(2 * m);
    lu.flag.assign(m, -1);
    lu.pattern.resize(m);
    lu.spat2.resize(m);
    lu.spat3.resize(m);
    lu.flagstamp = 0;
    lu.ftran_sol.assign(m, 0.0);
    lu.ftran_sol_dense = false;
    lu.ftran_sol_pat.clear();
    if (lu.update_mode == 1)
        ft_build(lu);           // fwd-declared; rebuilds the FT structures
    else
        lu.ft_valid = false;
    return status;
}

// ---------------------------------------------------------------------
// Triangular solves (position space)
// ---------------------------------------------------------------------

// Sparse reach: DFS from the nonzero pattern of the rhs through the graph of
// the triangular factor C (edges k -> C.idx[p] for p in column k). Emits
// positions in topological order suitable for the numeric phase.
// `lower`: solve proceeds k ascending (L) or descending (U).
static ipxint reach(const SparseCols& C, const ipxint* rhs_pat, ipxint nrhs,
                    std::vector<ipxint>& stack, std::vector<ipxint>& flag,
                    ipxint stampval, ipxint* out) {
    // iterative DFS with explicit stack of (node, next edge ptr)
    ipxint top = 0;      // output count (filled from end)
    ipxint nout = 0;
    ipxint* nodestack = stack.data();
    for (ipxint s = 0; s < nrhs; s++) {
        ipxint root = rhs_pat[s];
        if (flag[root] == stampval) continue;
        ipxint depth = 0;
        nodestack[0] = root;
        std::vector<ipxint> edge(1, C.ptr[root]);
        while (depth >= 0) {
            ipxint node = nodestack[depth];
            bool descended = false;
            ipxint pend = C.ptr[node + 1];
            while (edge[depth] < pend) {
                ipxint child = C.idx[edge[depth]++];
                if (flag[child] != stampval) {
                    flag[child] = stampval;
                    depth++;
                    nodestack[depth] = child;
                    if ((ipxint)edge.size() <= depth) edge.push_back(0);
                    edge[depth] = C.ptr[child];
                    descended = true;
                    break;
                }
            }
            if (!descended) {
                out[nout++] = node;   // post-order = topological for solve
                depth--;
            } else {
                continue;
            }
        }
        flag[root] = stampval;
    }
    (void)top;
    return nout;
}

// Numeric sparse solve with unit or explicit diagonal.
// Solves C x = b where C is triangular represented column-wise with
// entries strictly off-diagonal; diag == nullptr means unit diagonal.
static ipxint sparse_solve(const SparseCols& C, const double* diag,
                           IpxLu& lu, ipxint nrhs, const ipxint* rhs_pat,
                           double* x /* dense, pre-scattered */,
                           ipxint* out_pat) {
    lu.flagstamp++;
    ipxint nout = reach(C, rhs_pat, nrhs, lu.stack, lu.flag, lu.flagstamp,
                        out_pat);
    // topological order from DFS post-order: dependencies (children) come
    // before parents... For a solve over column-structure, node k's solution
    // updates its children C.idx (which are solved later in the elimination
    // order). Post-order emits children first, but we need k BEFORE its
    // children. So process in reverse.
    for (ipxint t = nout - 1; t >= 0; t--) {
        ipxint k = out_pat[t];
        double xk = x[k];
        if (diag) { xk /= diag[k]; x[k] = xk; }
        if (xk != 0.0) {
            for (ipxint p = C.ptr[k]; p < C.ptr[k + 1]; p++)
                x[C.idx[p]] -= C.val[p] * xk;
        }
    }
    // reverse output so caller sees processing order
    std::reverse(out_pat, out_pat + nout);
    return nout;
}

// dense lower solve (unit diag), ascending positions
static void dense_lsolve(const SparseCols& L, double* x, ipxint m) {
    for (ipxint k = 0; k < m; k++) {
        double xk = x[k];
        if (xk != 0.0)
            for (ipxint p = L.ptr[k]; p < L.ptr[k + 1]; p++)
                x[L.idx[p]] -= L.val[p] * xk;
    }
}

// dense upper solve with diag, descending positions
static void dense_usolve(const SparseCols& U, const double* diag, double* x,
                         ipxint m) {
    for (ipxint k = m - 1; k >= 0; k--) {
        double xk = x[k] / diag[k];
        x[k] = xk;
        if (xk != 0.0)
            for (ipxint p = U.ptr[k]; p < U.ptr[k + 1]; p++)
                x[U.idx[p]] -= U.val[p] * xk;
    }
}

// dense "upper transpose" solve: U^T y = b, ascending positions, diag first
static void dense_utsolve(const SparseCols& Ut, const double* diag, double* x,
                          ipxint m) {
    for (ipxint k = 0; k < m; k++) {
        double xk = x[k] / diag[k];
        x[k] = xk;
        if (xk != 0.0)
            for (ipxint p = Ut.ptr[k]; p < Ut.ptr[k + 1]; p++)
                x[Ut.idx[p]] -= Ut.val[p] * xk;
    }
}

// dense "lower transpose" solve: L^T y = b, descending positions, unit diag
static void dense_ltsolve(const SparseCols& Lt, double* x, ipxint m) {
    for (ipxint k = m - 1; k >= 0; k--) {
        double xk = x[k];
        if (xk != 0.0)
            for (ipxint p = Lt.ptr[k]; p < Lt.ptr[k + 1]; p++)
                x[Lt.idx[p]] -= Lt.val[p] * xk;
    }
}

// Applies eta inverses for FTRAN: x := E^{-1} x for each eta in order.
static double now_monotonic_s();

static void apply_etas_ftran(IpxLu& lu, double* x) {
    if (lu.etas.empty()) return;
    const double t0 = now_monotonic_s();
    for (const Eta& e : lu.etas) {
        double xp = x[e.pos] / e.diag;
        if (x[e.pos] != 0.0 || xp != 0.0) {
            x[e.pos] = xp;
            if (xp != 0.0)
                for (size_t t = 0; t < e.idx.size(); t++)
                    x[e.idx[t]] -= e.val[t] * xp;
        }
    }
    lu.t_eta += now_monotonic_s() - t0;
}

// Applies eta inverse transposes for BTRAN (most recent first):
// u = E^{-T} b: u_p = (b_p - w_off·b_off)/w_p.
static void apply_etas_btran(IpxLu& lu, double* x) {
    if (lu.etas.empty()) return;
    const double t0 = now_monotonic_s();
    for (auto it = lu.etas.rbegin(); it != lu.etas.rend(); ++it) {
        const Eta& e = *it;
        double acc = x[e.pos];
        for (size_t t = 0; t < e.idx.size(); t++)
            acc -= e.val[t] * x[e.idx[t]];
        x[e.pos] = acc / e.diag;
    }
    lu.t_eta += now_monotonic_s() - t0;
}

// ---------------------------------------------------------------------
// Forrest-Tomlin update machinery (update_mode == 1). Capability
// counterpart of reference: src/forrest_tomlin.cc (FT update over a
// factorization kernel, dense triangular solves, no hypersparsity) —
// re-architected around this kernel's position-space factors with a
// logical pivot order instead of the reference's physically permuted
// compressed files.
// ---------------------------------------------------------------------

// (Re)initializes the FT structures from the fresh factors.
static void ft_build(IpxLu& lu) {
    const ipxint m = lu.m;
    lu.ft_order.resize(m);
    lu.ft_opos.resize(m);
    for (ipxint k = 0; k < m; k++) {
        lu.ft_order[k] = k;
        lu.ft_opos[k] = k;
    }
    lu.ftU_ri.assign(m, {});
    lu.ftU_rv.assign(m, {});
    lu.ftR_ci.assign(m, {});
    lu.ftR_pp.assign(m, {});
    lu.ftR_cg.assign(m, {});
    lu.ft_colgen.assign(m, 0);
    lu.ftU_diag = lu.Udiag;
    for (ipxint k = 0; k < m; k++) {
        for (ipxint p = lu.U.ptr[k]; p < lu.U.ptr[k + 1]; p++) {
            int32_t r = lu.U.idx[p];
            int32_t slot = (int32_t)lu.ftU_ri[k].size();
            lu.ftU_ri[k].push_back(r);
            lu.ftU_rv[k].push_back(lu.U.val[p]);
            lu.ftR_ci[r].push_back((int32_t)k);
            lu.ftR_pp[r].push_back(slot);
            lu.ftR_cg[r].push_back(0);
        }
    }
    lu.ft_etas.clear();
    lu.ftU_nnz0 = lu.ftU_nnz = (ipxint)lu.U.idx.size() + m;
    lu.ftR_nnz = 0;
    lu.ft_spike.assign(m, 0.0);
    lu.ft_rwork.assign(m, 0.0);
    lu.ft_valid = true;
}

// FTRAN under FT: rowperm gather -> L solve -> row etas -> U solve in the
// logical pivot order -> colperm scatter. The pre-U-solve intermediate is
// stashed as the spike for a following update.
static void ft_ftran_dense(IpxLu& lu, const double* b, double* x) {
    const ipxint m = lu.m;
    double* w = lu.workd.data();
    for (ipxint k = 0; k < m; k++) w[k] = b[lu.rowperm[k]];
    dense_lsolve(lu.L, w, m);
    if (!lu.ft_etas.empty()) {
        const double t0 = now_monotonic_s();
        for (const FtEta& e : lu.ft_etas) {
            double acc = 0.0;
            for (size_t j = 0; j < e.pos.size(); j++)
                acc += e.alpha[j] * w[e.pos[j]];
            w[e.target] -= acc;
        }
        lu.t_eta += now_monotonic_s() - t0;
    }
    std::memcpy(lu.ft_spike.data(), w, m * sizeof(double));
    lu.ft_spike_dense = true;
    for (ipxint t = m - 1; t >= 0; t--) {
        ipxint k = lu.ft_order[t];
        double xk = w[k] / lu.ftU_diag[k];
        w[k] = xk;
        if (xk != 0.0) {
            const auto& ri = lu.ftU_ri[k];
            const auto& rv = lu.ftU_rv[k];
            for (size_t q = 0; q < ri.size(); q++) {
                int32_t r = ri[q];
                if (r >= 0) w[r] -= rv[q] * xk;
            }
        }
    }
    for (ipxint k = 0; k < m; k++) x[lu.colperm[k]] = w[k];
}

// BTRAN under FT: colperm gather -> U' solve in the logical order ->
// transposed row etas (reverse order) -> L' solve -> rowperm scatter.
static void ft_btran_dense(IpxLu& lu, const double* b, double* x) {
    const ipxint m = lu.m;
    double* w = lu.workd.data();
    for (ipxint k = 0; k < m; k++) w[k] = b[lu.colperm[k]];
    for (ipxint t = 0; t < m; t++) {
        ipxint k = lu.ft_order[t];
        double acc = w[k];
        const auto& ri = lu.ftU_ri[k];
        const auto& rv = lu.ftU_rv[k];
        for (size_t q = 0; q < ri.size(); q++) {
            int32_t r = ri[q];
            if (r >= 0) acc -= rv[q] * w[r];
        }
        w[k] = acc / lu.ftU_diag[k];
    }
    if (!lu.ft_etas.empty()) {
        const double t0 = now_monotonic_s();
        for (auto it = lu.ft_etas.rbegin(); it != lu.ft_etas.rend(); ++it) {
            const FtEta& e = *it;
            double wt = w[e.target];
            if (wt != 0.0)
                for (size_t j = 0; j < e.pos.size(); j++)
                    w[e.pos[j]] -= e.alpha[j] * wt;
        }
        lu.t_eta += now_monotonic_s() - t0;
    }
    dense_ltsolve(lu.Lt, w, m);
    for (ipxint k = 0; k < m; k++) x[lu.rowperm[k]] = w[k];
}

// Applies the staged exchange as a Forrest-Tomlin update: replace column p
// by the staged spike, eliminate the spiked row into a row eta, move p to
// the end of the logical order. Returns -1 singular, 1 unstable
// (new-diagonal error vs the expected pivot > kFtDiagErrorTol), 0 ok,
// -2 staging missing.
static ipxint ft_update(IpxLu& lu, double pivot) {
    const ipxint m = lu.m;
    if (!lu.have_ftran || lu.btran_pos < 0)
        return -2;
    const ipxint bpos = lu.btran_pos;
    const ipxint p = lu.colperm_inv[bpos];
    const double* s = lu.ft_spike.data();
    const double d_old = lu.ftU_diag[p];

    // invalidate the old column p (its row-file entries go stale)
    lu.ftU_nnz -= 1;
    for (int32_t r : lu.ftU_ri[p])
        if (r >= 0) lu.ftU_nnz--;
    lu.ft_colgen[p]++;
    lu.ftU_ri[p].clear();
    lu.ftU_rv[p].clear();

    // seed the row elimination with the valid entries of row p, removing
    // them from U (tombstones) as they are consumed
    double* rw = lu.ft_rwork.data();
    // (order index, position) min-heap via sorted scan: fills only go
    // forward in the order, so a lazy binary heap suffices
    std::vector<std::pair<ipxint, ipxint>> heap;
    auto heap_push = [&](ipxint k) {
        heap.emplace_back(lu.ft_opos[k], k);
        std::push_heap(heap.begin(), heap.end(),
                       std::greater<std::pair<ipxint, ipxint>>());
    };
    {
        const auto& ci = lu.ftR_ci[p];
        const auto& pp = lu.ftR_pp[p];
        const auto& cg = lu.ftR_cg[p];
        for (size_t t = 0; t < ci.size(); t++) {
            int32_t k = ci[t];
            if (lu.ft_colgen[k] != cg[t]) continue;        // stale
            int32_t slot = pp[t];
            if (lu.ftU_ri[k][slot] != (int32_t)p) continue;  // tombstoned
            if (rw[k] == 0.0 && lu.ftU_rv[k][slot] != 0.0) heap_push(k);
            rw[k] += lu.ftU_rv[k][slot];
            lu.ftU_ri[k][slot] = -1;                       // remove from U
            lu.ftU_nnz--;
        }
        lu.ftR_ci[p].clear();
        lu.ftR_pp[p].clear();
        lu.ftR_cg[p].clear();
    }

    FtEta eta;
    eta.target = p;
    double d = s[p];
    while (!heap.empty()) {
        std::pop_heap(heap.begin(), heap.end(),
                      std::greater<std::pair<ipxint, ipxint>>());
        ipxint k = heap.back().second;
        heap.pop_back();
        double v = rw[k];
        if (v == 0.0) continue;        // duplicate heap entry or cancelled
        rw[k] = 0.0;
        double a = v / lu.ftU_diag[k];
        eta.pos.push_back((int32_t)k);
        eta.alpha.push_back(a);
        d -= a * s[k];
        // rw -= a * (row k of U): valid row-file entries of k (all at
        // columns later in the order)
        const auto& ci = lu.ftR_ci[k];
        const auto& pp = lu.ftR_pp[k];
        const auto& cg = lu.ftR_cg[k];
        for (size_t t = 0; t < ci.size(); t++) {
            int32_t j = ci[t];
            if (lu.ft_colgen[j] != cg[t]) continue;
            int32_t slot = pp[t];
            if (lu.ftU_ri[j][slot] != (int32_t)k) continue;
            double u = lu.ftU_rv[j][slot];
            if (u == 0.0) continue;
            if (rw[j] == 0.0) heap_push(j);
            rw[j] -= a * u;
        }
    }
    const double d_new = pivot * d_old;
    if (d == 0.0 || !std::isfinite(d) || !std::isfinite(1.0 / d)
        || d_new == 0.0 || !std::isfinite(d_new)
        || !std::isfinite(1.0 / d_new)) {
        // leave U without row/col p content; caller must refactorize
        lu.have_ftran = false;
        lu.btran_pos = -1;
        lu.ft_valid = false;
        return -1;
    }

    // insert the spike as the new column p (entries become upper
    // triangular once p moves to the end of the order)
    {
        auto& ri = lu.ftU_ri[p];
        auto& rv = lu.ftU_rv[p];
        const int32_t gen = lu.ft_colgen[p];
        for (ipxint k = 0; k < m; k++) {
            if (k == p) continue;
            double v = s[k];
            if (v == 0.0) continue;
            int32_t slot = (int32_t)ri.size();
            ri.push_back((int32_t)k);
            rv.push_back(v);
            lu.ftR_ci[k].push_back((int32_t)p);
            lu.ftR_pp[k].push_back(slot);
            lu.ftR_cg[k].push_back(gen);
            lu.ftU_nnz++;
        }
        // insert the determinant-identity diagonal pivot*d_old (the
        // reference's numerically preferred choice, reference:
        // src/forrest_tomlin.cc:158-166) and keep the eliminated value d
        // for the stability monitor below (ADVICE r3)
        lu.ftU_diag[p] = pivot * d_old;
        lu.ftU_nnz++;
    }

    // move p to the end of the logical order
    {
        ipxint tp = lu.ft_opos[p];
        for (ipxint t = tp; t < m - 1; t++) {
            lu.ft_order[t] = lu.ft_order[t + 1];
            lu.ft_opos[lu.ft_order[t]] = t;
        }
        lu.ft_order[m - 1] = p;
        lu.ft_opos[p] = m - 1;
    }

    lu.ftR_nnz += (ipxint)eta.pos.size();
    lu.ft_etas.push_back(std::move(eta));
    lu.have_ftran = false;
    lu.btran_pos = -1;

    // stability: the determinant update gives d_new = pivot * d_old
    const double d_exp = pivot * d_old;
    const double err = std::fabs(d - d_exp) /
        std::max(std::fabs(d), std::fabs(d_exp));
    return err > 1e-8 ? 1 : 0;         // kFtDiagErrorTol
}

// Full dense FTRAN: solves B x = b. b and x in user spaces.
static void ftran_dense(IpxLu& lu, const double* b, double* x) {
    const ipxint m = lu.m;
    if (lu.update_mode == 1 && lu.ft_valid) {
        ft_ftran_dense(lu, b, x);
        return;
    }
    double* w = lu.workd.data();
    for (ipxint k = 0; k < m; k++) w[k] = b[lu.rowperm[k]];
    dense_lsolve(lu.L, w, m);
    dense_usolve(lu.U, lu.Udiag.data(), w, m);
    // to basis-position space
    double* s = lu.work2.data();
    for (ipxint k = 0; k < m; k++) s[lu.colperm[k]] = w[k];
    apply_etas_ftran(lu, s);
    std::memcpy(x, s, m * sizeof(double));
}

// Full dense BTRAN: solves B^T x = b.
static void btran_dense(IpxLu& lu, const double* b, double* x) {
    const ipxint m = lu.m;
    if (lu.update_mode == 1 && lu.ft_valid) {
        ft_btran_dense(lu, b, x);
        return;
    }
    double* s = lu.work2.data();
    std::memcpy(s, b, m * sizeof(double));
    apply_etas_btran(lu, s);
    double* w = lu.workd.data();
    for (ipxint k = 0; k < m; k++) w[k] = s[lu.colperm[k]];
    dense_utsolve(lu.Ut, lu.Udiag.data(), w, m);
    dense_ltsolve(lu.Lt, w, m);
    for (ipxint k = 0; k < m; k++) x[lu.rowperm[k]] = w[k];
}

// Applies eta inverses for FTRAN on a SPARSE vector, extending the pattern
// as fill occurs. x dense storage; pattern list appended in place.
static ipxint apply_etas_ftran_sparse(IpxLu& lu, double* x, ipxint* pat,
                                      ipxint nz) {
    // membership tracked with a stamp so entries are never added twice
    // (value==0 tests would re-add exactly-cancelled entries and could
    // overflow the pattern buffer)
    lu.flagstamp++;
    const ipxint st = lu.flagstamp;
    for (ipxint t = 0; t < nz; t++) lu.flag[pat[t]] = st;
    const double t0 = now_monotonic_s();
    for (const Eta& e : lu.etas) {
        double xp = x[e.pos];
        if (xp == 0.0) continue;
        xp /= e.diag;
        x[e.pos] = xp;
        for (size_t t = 0; t < e.idx.size(); t++) {
            ipxint j = e.idx[t];
            x[j] -= e.val[t] * xp;
            if (lu.flag[j] != st) {
                lu.flag[j] = st;
                pat[nz++] = j;
            }
        }
    }
    lu.t_eta += now_monotonic_s() - t0;
    return nz;
}

// Sparse FTRAN with pattern tracking. Returns nz (pattern in out_pat, values
// dense in x) or -1 if the result should be treated dense.
// Hypersparse FTRAN under Forrest-Tomlin (beyond the reference's
// dense-only generic FT): sparse L solve, forward row etas with pattern
// membership, sparse spike snapshot, then a U solve over the reach of the
// dynamic U column files in descending logical order. Returns nz or -2
// when the pattern exceeds m/8 (caller falls back to the dense path).
static ipxint ft_ftran_sparse(IpxLu& lu, ipxint nb, const ipxint* bi,
                              const double* bx, double* x,
                              ipxint* out_pat, bool assume_zero = false) {
    const ipxint m = lu.m;
    const ipxint CAP = m / 8;
    double* w = lu.work.data();
    ipxint* pat0 = lu.pattern.data();
    ipxint npat = 0;
    for (ipxint t = 0; t < nb; t++) {
        ipxint k = lu.rowperm_inv[bi[t]];
        w[k] = bx[t];
        pat0[npat++] = k;
    }
    ipxint* pat2 = lu.spat2.data();
    ipxint n2 = sparse_solve(lu.L, nullptr, lu, npat, pat0, w, pat2);
    if (n2 > CAP) {
        for (ipxint t = 0; t < n2; t++) w[pat2[t]] = 0.0;
        return -2;
    }
    // forward row etas; membership via a fresh stamp on the eta pattern
    lu.flagstamp++;
    const ipxint st = lu.flagstamp;
    ipxint* pat = pat0;              // eta-phase (growing) pattern
    npat = n2;
    for (ipxint t = 0; t < n2; t++) {
        pat[t] = pat2[t];
        lu.flag[pat2[t]] = st;
    }
    bool bail = false;
    if (!lu.ft_etas.empty()) {
        const double t0 = now_monotonic_s();
        for (const FtEta& e : lu.ft_etas) {
            double acc = 0.0;
            for (size_t j = 0; j < e.pos.size(); j++) {
                ipxint pj = e.pos[j];
                if (lu.flag[pj] == st && w[pj] != 0.0)
                    acc += e.alpha[j] * w[pj];
            }
            if (acc != 0.0) {
                w[e.target] -= acc;
                if (lu.flag[e.target] != st) {
                    lu.flag[e.target] = st;
                    pat[npat++] = e.target;
                    if (npat > CAP) { bail = true; break; }
                }
            }
        }
        lu.t_eta += now_monotonic_s() - t0;
    }
    if (!bail) {
        // sparse spike snapshot (read by a following ft_update)
        if (lu.ft_spike_dense) {
            std::fill(lu.ft_spike.begin(), lu.ft_spike.end(), 0.0);
            lu.ft_spike_dense = false;
        } else {
            for (ipxint k : lu.ft_spike_pat) lu.ft_spike[k] = 0.0;
        }
        lu.ft_spike_pat.assign(pat, pat + npat);
        for (ipxint t = 0; t < npat; t++)
            lu.ft_spike[pat[t]] = w[pat[t]];
        // U-solve reach over the dynamic column files
        lu.flagstamp++;
        const ipxint st2 = lu.flagstamp;
        ipxint* stck = lu.stack.data();
        ipxint* upat = lu.spat3.data();
        ipxint nu = 0;
        ipxint top = 0;
        for (ipxint t = 0; t < npat; t++) {
            if (lu.flag[pat[t]] != st2) {
                lu.flag[pat[t]] = st2;
                stck[top++] = pat[t];
            }
        }
        while (top) {
            ipxint k = stck[--top];
            upat[nu++] = k;
            if (nu > CAP) { bail = true; break; }
            const auto& ri = lu.ftU_ri[k];
            for (size_t q = 0; q < ri.size(); q++) {
                int32_t r = ri[q];
                if (r >= 0 && lu.flag[r] != st2) {
                    lu.flag[r] = st2;
                    stck[top++] = r;
                }
            }
        }
        if (!bail) {
            std::sort(upat, upat + nu, [&](ipxint a, ipxint b) {
                return lu.ft_opos[a] > lu.ft_opos[b];
            });
            for (ipxint t = 0; t < nu; t++) {
                ipxint k = upat[t];
                double xk = w[k] / lu.ftU_diag[k];
                w[k] = xk;
                if (xk != 0.0) {
                    const auto& ri = lu.ftU_ri[k];
                    const auto& rv = lu.ftU_rv[k];
                    for (size_t q = 0; q < ri.size(); q++) {
                        int32_t r = ri[q];
                        if (r >= 0) w[r] -= rv[q] * xk;
                    }
                }
            }
            if (!assume_zero)
                std::fill(x, x + m, 0.0);
            ipxint nz = 0;
            for (ipxint t = 0; t < nu; t++) {
                ipxint k = upat[t];
                double v = w[k];
                w[k] = 0.0;
                if (v != 0.0) {
                    ipxint j = lu.colperm[k];
                    x[j] = v;
                    out_pat[nz++] = j;
                }
            }
            return nz;
        }
        // bail after U-reach started: zero everything touched
        for (ipxint t = 0; t < nu; t++) w[upat[t]] = 0.0;
    }
    for (ipxint t = 0; t < npat; t++) w[pat[t]] = 0.0;
    return -2;
}

static ipxint ftran_sparse(IpxLu& lu, ipxint nb, const ipxint* bi,
                           const double* bx, double* x, ipxint* out_pat,
                           bool assume_zero = false) {
    const ipxint m = lu.m;
    if (lu.update_mode == 1 && lu.ft_valid) {
        if (nb <= m / 8) {
            ipxint nz = ft_ftran_sparse(lu, nb, bi, bx, x, out_pat,
                                        assume_zero);
            if (nz >= 0)
                return nz;
        }
        // dense fallback (parity with the reference's generic FT,
        // src/forrest_tomlin.h:14-26); ftran_dense writes all of x
        std::vector<double> bd(m, 0.0);
        for (ipxint t = 0; t < nb; t++) bd[bi[t]] = bx[t];
        ftran_dense(lu, bd.data(), x);
        return -1;
    }
    if (nb > m / 8) {
        std::vector<double> bd(m, 0.0);
        for (ipxint t = 0; t < nb; t++) bd[bi[t]] = bx[t];
        ftran_dense(lu, bd.data(), x);
        return -1;
    }
    double* w = lu.work.data();
    // scatter rhs into position space
    ipxint npat = 0;
    ipxint* pat = lu.pattern.data();
    for (ipxint t = 0; t < nb; t++) {
        ipxint k = lu.rowperm_inv[bi[t]];
        w[k] = bx[t];
        pat[npat++] = k;
    }
    // L solve (pattern workspaces live in lu: a fresh zero-initialized
    // vector per hypersparse solve dominated the per-call cost)
    ipxint* pat2 = lu.spat2.data();
    ipxint n2 = sparse_solve(lu.L, nullptr, lu, npat, pat, w, pat2);
    // U solve from pattern of y
    ipxint* pat3 = lu.spat3.data();
    ipxint n3 = sparse_solve(lu.U, lu.Udiag.data(), lu, n2, pat2, w,
                             pat3);
    // gather into basis-position space
    if (!assume_zero)
        std::fill(x, x + m, 0.0);
    ipxint nz = 0;
    for (ipxint t = 0; t < n3; t++) {
        ipxint k = pat3[t];
        double v = w[k];
        w[k] = 0.0;
        if (v != 0.0) {
            ipxint j = lu.colperm[k];
            x[j] = v;
            out_pat[nz++] = j;
        }
    }
    // clear scattered w leftovers (positions solved but zero handled above;
    // also clear the L-phase pattern in case U-phase pattern differs)
    for (ipxint t = 0; t < n2; t++) w[pat2[t]] = 0.0;
    // apply PFI etas sparsely, growing the pattern with fill
    if (!lu.etas.empty())
        nz = apply_etas_ftran_sparse(lu, x, out_pat, nz);
    return nz;
}

// Sparse BTRAN of a unit vector e_pos (basis position). Returns nz or -1.
// Hypersparse BTRAN of a unit vector under Forrest-Tomlin (beyond the
// reference, whose generic FT is dense-only, src/forrest_tomlin.h:14-26):
// reach over the dynamic U row files -> gather U' solve in logical order
// -> reverse row etas with pattern growth -> sparse L' solve. Returns nz,
// or -2 when the pattern exceeds m/8 (caller falls back to the dense
// path). x is only written at returned pattern positions (assume_zero
// semantics of the caller apply).
static ipxint ft_btran_sparse_unit(IpxLu& lu, ipxint pos, double* x,
                                   ipxint* out_pat, bool assume_zero) {
    const ipxint m = lu.m;
    const ipxint CAP = m / 8;
    const ipxint k0 = lu.colperm_inv[pos];
    lu.flagstamp++;
    const ipxint st = lu.flagstamp;
    ipxint* stck = lu.stack.data();
    ipxint* pat = lu.spat2.data();
    double* w = lu.work.data();      // all-zero scratch (restored below)
    ipxint ns = 0;
    ipxint top = 0;
    stck[top++] = k0;
    lu.flag[k0] = st;
    bool bail = false;
    while (top) {
        ipxint r = stck[--top];
        pat[ns++] = r;
        if (ns > CAP) { bail = true; break; }
        const auto& ci = lu.ftR_ci[r];
        const auto& pp = lu.ftR_pp[r];
        const auto& cg = lu.ftR_cg[r];
        for (size_t t = 0; t < ci.size(); t++) {
            int32_t j = ci[t];
            if (lu.ft_colgen[j] != cg[t]) continue;
            if (lu.ftU_ri[j][pp[t]] != (int32_t)r) continue;
            if (lu.flag[j] != st) {
                lu.flag[j] = st;
                stck[top++] = j;
            }
        }
    }
    if (!bail) {
        std::sort(pat, pat + ns, [&](ipxint a, ipxint b) {
            return lu.ft_opos[a] < lu.ft_opos[b];
        });
        w[k0] = 1.0;
        for (ipxint t = 0; t < ns; t++) {
            ipxint k = pat[t];
            double acc = w[k];
            const auto& ri = lu.ftU_ri[k];
            const auto& rv = lu.ftU_rv[k];
            for (size_t q = 0; q < ri.size(); q++) {
                int32_t r = ri[q];
                if (r >= 0) acc -= rv[q] * w[r];
            }
            w[k] = acc / lu.ftU_diag[k];
        }
        // reverse row etas; each can grow the pattern by its pos list
        const double t_eta0 = now_monotonic_s();
        for (auto it = lu.ft_etas.rbegin(); it != lu.ft_etas.rend();
             ++it) {
            const FtEta& e = *it;
            if (lu.flag[e.target] != st) continue;
            const double wt = w[e.target];
            if (wt == 0.0) continue;
            for (size_t j = 0; j < e.pos.size(); j++) {
                ipxint pj = e.pos[j];
                if (lu.flag[pj] != st) {
                    lu.flag[pj] = st;
                    pat[ns++] = pj;
                }
                w[pj] -= e.alpha[j] * wt;
            }
            if (ns > CAP) { bail = true; break; }
        }
        if (!lu.ft_etas.empty())
            lu.t_eta += now_monotonic_s() - t_eta0;
    }
    if (bail) {
        for (ipxint t = 0; t < ns; t++) w[pat[t]] = 0.0;
        return -2;
    }
    // sparse L' solve (bumps flagstamp internally; our flags are done)
    ipxint* pat3 = lu.spat3.data();
    ipxint n3 = sparse_solve(lu.Lt, nullptr, lu, ns, pat, w, pat3);
    if (!assume_zero)
        std::fill(x, x + m, 0.0);
    ipxint nz = 0;
    for (ipxint t = 0; t < n3; t++) {
        ipxint k = pat3[t];
        double v = w[k];
        w[k] = 0.0;
        if (v != 0.0) {
            ipxint i = lu.rowperm[k];
            x[i] = v;
            out_pat[nz++] = i;
        }
    }
    return nz;
}

static ipxint btran_sparse_unit(IpxLu& lu, ipxint pos, double* x,
                                ipxint* out_pat, bool assume_zero = false) {
    const ipxint m = lu.m;
    if (lu.update_mode == 1 && lu.ft_valid) {
        ipxint nz = ft_btran_sparse_unit(lu, pos, x, out_pat, assume_zero);
        if (nz >= 0)
            return nz;
        // pattern too dense: dense path (parity with the reference's
        // generic FT)
        std::vector<double> bd(m, 0.0);
        bd[pos] = 1.0;
        ft_btran_dense(lu, bd.data(), x);
        return -1;
    }
    // Apply eta inverse transposes sparsely first (most recent first):
    // u_p = (b_p - w_off . b_off) / w_p touches only position e.pos, so the
    // rhs pattern grows by at most one entry per eta.
    double* s = lu.works.data();
    ipxint ns = 0;
    ipxint* spat = lu.pattern.data();
    lu.flagstamp++;
    const ipxint bst = lu.flagstamp;
    s[pos] = 1.0;
    lu.flag[pos] = bst;
    spat[ns++] = pos;
    const double t_eta0 = now_monotonic_s();
    if (lu.etas.size() >= 48) {
        // Indexed eta application: only etas whose transposed application
        // reads a pattern position can act (an untouched eta computes
        // acc = 0 and is an exact no-op). Candidates are processed in
        // reverse creation order via a max-heap; positions that become
        // nonzero when an eta fires discover further candidates, but only
        // OLDER ones (a newer eta reading such a position saw zero at its
        // own application time, so skipping it is exact).
        lu.eta_stampval++;
        const ipxint est = lu.eta_stampval;
        std::priority_queue<int32_t> heap;
        auto push_readers = [&](ipxint p, int32_t below) {
            for (int32_t en : lu.eta_rd[p]) {
                if (en < below && lu.eta_stamp[en] != est) {
                    lu.eta_stamp[en] = est;
                    heap.push(en);
                }
            }
        };
        push_readers(pos, (int32_t)lu.etas.size());
        while (!heap.empty()) {
            int32_t en = heap.top();
            heap.pop();
            const Eta& e = lu.etas[en];
            double acc = s[e.pos];
            for (size_t t = 0; t < e.idx.size(); t++)
                acc -= e.val[t] * s[e.idx[t]];
            acc /= e.diag;
            s[e.pos] = acc;
            if (acc != 0.0 && lu.flag[e.pos] != bst) {
                lu.flag[e.pos] = bst;
                spat[ns++] = e.pos;
                push_readers(e.pos, en);
            }
        }
    } else {
        for (auto it = lu.etas.rbegin(); it != lu.etas.rend(); ++it) {
            const Eta& e = *it;
            double acc = s[e.pos];
            for (size_t t = 0; t < e.idx.size(); t++)
                acc -= e.val[t] * s[e.idx[t]];
            s[e.pos] = acc / e.diag;
            if (lu.flag[e.pos] != bst) {
                lu.flag[e.pos] = bst;
                spat[ns++] = e.pos;
            }
        }
    }
    if (!lu.etas.empty()) lu.t_eta += now_monotonic_s() - t_eta0;
    if (ns > m / 8) {
        // dense fallback; s already holds the eta-transformed rhs
        double* w = lu.workd.data();
        for (ipxint k = 0; k < m; k++) w[k] = s[lu.colperm[k]];
        for (ipxint t = 0; t < ns; t++) s[spat[t]] = 0.0;
        dense_utsolve(lu.Ut, lu.Udiag.data(), w, m);
        dense_ltsolve(lu.Lt, w, m);
        for (ipxint k = 0; k < m; k++) x[lu.rowperm[k]] = w[k];
        return -1;
    }
    double* w = lu.work.data();
    ipxint pat0_arr[64];
    std::vector<ipxint> pat0big;
    ipxint* pat0;
    if (ns <= 64) pat0 = pat0_arr; else {
        pat0big.resize(ns);
        pat0 = pat0big.data();
    }
    ipxint np0 = 0;
    for (ipxint t = 0; t < ns; t++) {
        ipxint j = spat[t];
        double v = s[j];
        s[j] = 0.0;
        if (v != 0.0) {
            ipxint k = lu.colperm_inv[j];
            w[k] = v;
            pat0[np0++] = k;
        }
    }
    ipxint* pat2 = lu.spat2.data();
    ipxint* pat3 = lu.spat3.data();
    ipxint n2 = sparse_solve(lu.Ut, lu.Udiag.data(), lu, np0, pat0, w,
                             pat2);
    ipxint n3 = sparse_solve(lu.Lt, nullptr, lu, n2, pat2, w,
                             pat3);
    if (!assume_zero)
        std::fill(x, x + m, 0.0);
    ipxint nz = 0;
    for (ipxint t = 0; t < n3; t++) {
        ipxint k = pat3[t];
        double v = w[k];
        w[k] = 0.0;
        if (v != 0.0) {
            ipxint i = lu.rowperm[k];
            x[i] = v;
            out_pat[nz++] = i;
        }
    }
    for (ipxint t = 0; t < n2; t++) w[pat2[t]] = 0.0;
    return nz;
}

static double now_monotonic_s() {
    return std::chrono::duration<double>(
        std::chrono::steady_clock::now().time_since_epoch()).count();
}

// Applies the pending exchange as a PFI eta (body of ipxlu_update; also
// called by the native push loops). Returns -1 singular, 1 unstable, 0 ok,
// -2 staging missing.
static ipxint update_impl(IpxLu& lu, double pivot) {
    const ipxint m = lu.m;
    if (lu.update_mode == 1 && lu.ft_valid)
        return ft_update(lu, pivot);
    if (!lu.have_ftran || lu.btran_pos < 0)
        return -2;
    ipxint p = lu.btran_pos;
    double wp = lu.ftran_sol[p];
    if (wp == 0.0 || !std::isfinite(1.0 / wp))
        return -1;
    // stability: compare spike pivot with independently computed pivot
    double err = std::fabs(wp - pivot) /
        std::max(std::fabs(pivot), std::fabs(wp));
    Eta e;
    e.pos = p;
    e.diag = wp;
    if (lu.ftran_pat_valid) {
        for (ipxint j : lu.ftran_pat)
            if (j != p && lu.ftran_sol[j] != 0.0) {
                e.idx.push_back(j);
                e.val.push_back(lu.ftran_sol[j]);
            }
    } else {
        for (ipxint j = 0; j < m; j++)
            if (j != p && lu.ftran_sol[j] != 0.0) {
                e.idx.push_back(j);
                e.val.push_back(lu.ftran_sol[j]);
            }
    }
    lu.eta_nnz += (ipxint)e.idx.size() + 1;
    {
        // register the reader index of the new eta (BTRAN reads idx + pos)
        const int32_t eno = (int32_t)lu.etas.size();
        for (ipxint j : e.idx) lu.eta_rd[j].push_back(eno);
        lu.eta_rd[e.pos].push_back(eno);
        lu.eta_stamp.push_back(0);
    }
    lu.etas.push_back(std::move(e));
    lu.have_ftran = false;
    lu.btran_pos = -1;
    if (err > 1e-8)          // kFtDiagErrorTol
        return 1;
    return 0;
}

static ipxint need_fresh_impl(IpxLu& lu) {
    if (lu.update_mode == 1) {
        // Forrest-Tomlin refresh rules (reference:
        // src/forrest_tomlin.cc:214-238): bounded update count, then —
        // only after a 100-update floor — row-eta file larger than L
        // (incl. diagonal), U grown past 1.7x its fresh size, plus the
        // measured eta-time competitiveness rule shared with PFI. The
        // floor is load-bearing: network bases have a near-empty L, so
        // without it the Rnz>Lnz rule fires after a handful of updates
        // and refactorization storms (measured 17x blowup on grid,
        // docs/LU_UPDATE.tbl r3).
        if (!lu.ft_valid) return 1;
        const ipxint nup = (ipxint)lu.ft_etas.size();
        if (nup >= std::min<ipxint>(5000, lu.m)) return 1;
        if (nup < 100) return 0;
        if (lu.ftR_nnz > (ipxint)lu.L.idx.size() + lu.m) return 1;
        if ((double)lu.ftU_nnz > 1.7 * (double)lu.ftU_nnz0) return 1;
        if (lu.t_eta > std::max(lu.t_last_factorize, 1e-6)) return 1;
        return 0;
    }
    if ((ipxint)lu.etas.size() >= lu.m)
        return 1;
    if (lu.eta_nnz > 2 * lu.factor_nnz)     // memory / per-solve bound
        return 1;
    // Amortized (2-competitive) refresh: refactorize once the measured
    // wall clock spent applying the eta chain since the last factorization
    // matches the measured cost of that factorization. Both sides of the
    // trade are measured, so the policy self-calibrates across basis
    // families — dense-fill bases (expensive refactorize, dense etas) keep
    // long chains, hypersparse network bases (cheap refactorize) refresh
    // often.
    if (lu.t_eta > std::max(lu.t_last_factorize, 1e-6))
        return 1;
    return 0;
}

// One application of the basis-preconditioned normal matrix
//   C = I + inv(B~) N~ N~' inv(B~')
// in BASIS-SLOT space with BASIC_FREE slots zeroed (counterpart of
// reference: src/splitted_normal_matrix.cc:90-117, re-architected: the
// solves go through the eta-aware FTRAN/BTRAN so the operator is exact for
// the CURRENT basis even on a stale factorization + PFI updates; this makes
// the per-IPM-iteration refactorization the reference needs for its
// position-space operator purely cost-driven).
// The N~ N~' product runs as ONE pass over the columns of N (gather-dot then
// scatter-add per column). Returns rhs . lhs fused with the product.
static double splitted_apply(IpxLu& lu, const double* rhs, double* lhs) {
    const ipxint m = lu.m;
    const double* s = lu.uscale.data();
    double* w = lu.s_wr.data();      // row-space result of the BTRAN

    // w(rows) = inv(B') (rhs / s): BTRAN with etas
    double t0 = now_monotonic_s();
    {
        double* v = lu.s_w.data();
        for (ipxint i = 0; i < m; i++) v[i] = rhs[i] / s[i];
        btran_dense(lu, v, w);
    }
    lu.t_Bt += now_monotonic_s() - t0;

    // lhs = N N' w, one pass over N's columns (parallel over nnz-balanced
    // column blocks with per-thread accumulators, like the phase-1 apply)
    t0 = now_monotonic_s();
    const ipxint* Np = lu.Nptr.data();
    const int32_t* Ni = lu.Nidx.data();
    const double* Nx = lu.Nval.data();
    const ipxint ncols = (ipxint)lu.Nptr.size() - 1;
#ifdef _OPENMP
    if (ncols >= 0 && Np[ncols] >= (ipxint)1 << 17
        && omp_get_max_threads() > 1) {
        static std::vector<std::vector<double>> accs;
        int NT = omp_get_max_threads();
        if ((int)accs.size() < NT) accs.resize(NT);
#pragma omp parallel num_threads(NT)
        {
            int nt = omp_get_num_threads();
            int tid = omp_get_thread_num();
            auto& mine = accs[tid];
            if ((ipxint)mine.size() < m) mine.resize(m);
            std::fill(mine.begin(), mine.begin() + m, 0.0);
            double* a = mine.data();
            const ipxint nnz = Np[ncols];
            ipxint lo = (ipxint)(std::lower_bound(
                Np, Np + ncols + 1, nnz * tid / nt) - Np);
            ipxint hi = (ipxint)(std::lower_bound(
                Np, Np + ncols + 1, nnz * (tid + 1) / nt) - Np);
            if (tid == 0) lo = 0;
            if (tid == nt - 1) hi = ncols;
            for (ipxint j = lo; j < hi; j++) {
                const ipxint begin = Np[j], end = Np[j + 1];
                double d = 0.0;
                for (ipxint p = begin; p < end; p++)
                    d += w[Ni[p]] * Nx[p];
                if (d != 0.0)
                    for (ipxint p = begin; p < end; p++)
                        a[Ni[p]] += d * Nx[p];
            }
#pragma omp barrier
            ipxint rlo = m * (ipxint)tid / nt;
            ipxint rhi = m * ((ipxint)tid + 1) / nt;
            for (ipxint i = rlo; i < rhi; i++) {
                double v = 0.0;
                for (int t = 0; t < nt; t++)
                    v += accs[t][i];
                lhs[i] = v;
            }
        }
    } else
#endif
    {
        std::fill(lhs, lhs + m, 0.0);
        for (ipxint j = 0; j < ncols; j++) {
            const ipxint begin = Np[j], end = Np[j + 1];
            double d = 0.0;
            for (ipxint p = begin; p < end; p++)
                d += w[Ni[p]] * Nx[p];
            if (d != 0.0)
                for (ipxint p = begin; p < end; p++)
                    lhs[Ni[p]] += d * Nx[p];
        }
    }
    lu.t_NNt += now_monotonic_s() - t0;

    // lhs(slots) := inv(B) lhs(rows) / s + rhs (FTRAN with etas); zero
    // BASIC_FREE slots; fused dot
    t0 = now_monotonic_s();
    {
        double* v = lu.s_w.data();
        std::memcpy(v, lhs, m * sizeof(double));
        ftran_dense(lu, v, lhs);
    }
    for (ipxint i = 0; i < m; i++) lhs[i] = lhs[i] / s[i] + rhs[i];
    for (ipxint k : lu.freepos) lhs[k] = 0.0;
    double dot = 0.0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) reduction(+ : dot) \
    if (m >= (ipxint)1 << 15)
#endif
    for (ipxint i = 0; i < m; i++) dot += rhs[i] * lhs[i];
    lu.t_B += now_monotonic_s() - t0;
    return dot;
}

// ---------------------------------------------------------------------
// Native push loops (crossover): sequential per-push driver with FTRAN /
// tableau-row, two-pass ratio tests, exchanges with refactorize-on-
// instability, all without Python crossings (counterpart of reference:
// src/crossover.cc push loops + src/basis.cc:116-156,286-322).
// ---------------------------------------------------------------------

const double kXoverPivotZeroTol = 1e-5;   // reference: src/crossover.h:137

struct XoverCounts {
    ipxint pushes = 0, pivots = 0;
    ipxint nftran = 0, nftran_sparse = 0, nbtran = 0, nbtran_sparse = 0;
    ipxint nupdates = 0, nfactor = 0;
    double t_ftran = 0, t_btran = 0, t_update = 0, t_factorize = 0;
    double* fills;
    ipxint fills_cap;
    ipxint nfills = 0;

    void flush(ipxint* ic, double* dc, ipxint* nfills_out) const {
        ic[0] += pushes; ic[1] += pivots;
        ic[2] += nftran; ic[3] += nftran_sparse;
        ic[4] += nbtran; ic[5] += nbtran_sparse;
        ic[6] += nupdates; ic[7] += nfactor;
        dc[0] += t_ftran; dc[1] += t_btran;
        dc[2] += t_update; dc[3] += t_factorize;
        *nfills_out = nfills;
    }
};

// deterministic +/-1 rhs (xorshift) for the stability estimate
static void pm1_rhs(std::vector<double>& b) {
    uint64_t s = 0x9E3779B97F4A7C15ull;
    for (size_t i = 0; i < b.size(); i++) {
        s ^= s << 13; s ^= s >> 7; s ^= s << 17;
        b[i] = (s & 1) ? 1.0 : -1.0;
    }
}

// rebuild the basis-column ranges into mb_begin/mb_end for the bound model
static void build_basis_cols(IpxLu& lu, const ipxint* basis) {
    const ipxint m = lu.m, n = lu.mb_n;
    const ipxint nnzA = lu.mb_Ap[n];
    lu.mb_begin.resize(m);
    lu.mb_end.resize(m);
    for (ipxint p = 0; p < m; p++) {
        ipxint j = basis[p];
        if (j < n) {
            lu.mb_begin[p] = lu.mb_Ap[j];
            lu.mb_end[p] = lu.mb_Ap[j + 1];
        } else {
            lu.mb_begin[p] = nnzA + (j - n);
            lu.mb_end[p] = lu.mb_begin[p] + 1;
        }
    }
}

// Stability estimate of the fresh factors: scaled 1-norm residual of a
// +/-1-rhs solve vs kLuStabilityThreshold=1e-12 (method of Duff/Erisman/
// Reid; counterpart of reference: src/lu_factorization.cc:71-127).
// Requires mb_begin/mb_end current.
static bool factors_stable(IpxLu& lu) {
    const ipxint m = lu.m;
    if (m == 0) return true;
    std::vector<double> b(m), x(m);
    pm1_rhs(b);
    ftran_dense(lu, b.data(), x.data());
    std::vector<double> r(b);
    double normB = 0.0;
    for (ipxint j = 0; j < m; j++) {
        double cn = 0.0;
        double xj = x[j];
        for (ipxint p = lu.mb_begin[j]; p < lu.mb_end[j]; p++) {
            r[lu.mb_Bi[p]] -= lu.mb_Bx[p] * xj;
            cn += std::fabs(lu.mb_Bx[p]);
        }
        normB = std::max(normB, cn);
    }
    double sb = 0.0, sx = 0.0, sr = 0.0;
    for (ipxint i = 0; i < m; i++) {
        sb += std::fabs(b[i]);
        sx += std::fabs(x[i]);
        sr += std::fabs(r[i]);
    }
    double denom = sb + normB * sx;
    if (denom == 0.0) return true;
    return sr / denom <= 1e-12;     // kLuStabilityThreshold
}

// pivot tolerance ladder (reference: src/basis.cc:490-503)
static bool tighten_pivottol(IpxLu& lu) {
    if (lu.pivottol <= 0.05) lu.pivottol = 0.1;
    else if (lu.pivottol <= 0.25) lu.pivottol = 0.3;
    else if (lu.pivottol <= 0.5) lu.pivottol = 0.9;
    else return false;
    return true;
}

// Refactorize the current basis with the stability ladder (counterpart of
// reference: src/basis.cc:116-156). Returns 0 ok or 301 (BASIS_SINGULAR).
static ipxint xover_refactorize(IpxLu& lu, const ipxint* basis,
                                XoverCounts& c) {
    double t0 = now_monotonic_s();
    build_basis_cols(lu, basis);
    ipxint err = 0;
    while (true) {
        int flag = factorize(lu, lu.mb_begin.data(), lu.mb_end.data(),
                             lu.mb_Bi.data(), lu.mb_Bx.data(), 0);
        c.nfactor++;
        if (c.nfills < c.fills_cap)
            c.fills[c.nfills++] = (double)lu.factor_nnz / (double)lu.bnnz;
        if (flag & 2) { err = 301; break; }
        if (!factors_stable(lu) && tighten_pivottol(lu))
            continue;
        break;
    }
    c.t_factorize += now_monotonic_s() - t0;
    return err;
}

// FTRAN of AI column jn with the spike recorded for a subsequent update
// (counterpart of NativeLu.ftran_for_update). Result dense in lu.xw_ft with
// pattern lu.xw_ftpat; returns nz or -1 dense.
static ipxint ftran_col_for_update(IpxLu& lu, ipxint jn, XoverCounts& c,
                                   bool count) {
    const ipxint m = lu.m, n = lu.mb_n;
    double t0 = now_monotonic_s();
    ipxint bi1;
    const ipxint* bi;
    const double* bx;
    double one = 1.0;
    ipxint nb;
    if (jn < n) {
        bi = lu.mb_Ai + lu.mb_Ap[jn];
        bx = lu.mb_Ax + lu.mb_Ap[jn];
        nb = lu.mb_Ap[jn + 1] - lu.mb_Ap[jn];
    } else {
        bi1 = jn - n;
        bi = &bi1;
        bx = &one;
        nb = 1;
    }
    // pattern-based staging: clear only last call's content of the
    // workspaces instead of full m-passes (a staged sparse FTRAN paid a
    // dense zero-fill plus TWO 8m-byte copies; at m=300k those three
    // passes dominated maxvolume's candidate evaluation)
    if (lu.xw_ft_dense) {
        std::fill(lu.xw_ft.begin(), lu.xw_ft.end(), 0.0);
        lu.xw_ft_dense = false;
    } else if (lu.xw_ft_nz > 0) {
        for (ipxint t = 0; t < lu.xw_ft_nz; t++)
            lu.xw_ft[lu.xw_ftpat[t]] = 0.0;
    }
    ipxint nz = ftran_sparse(lu, nb, bi, bx, lu.xw_ft.data(),
                             lu.xw_ftpat.data(), /*assume_zero=*/true);
    lu.xw_ft_nz = nz;
    lu.xw_ft_dense = nz < 0;
    if (lu.ftran_sol_dense) {
        std::fill(lu.ftran_sol.begin(), lu.ftran_sol.end(), 0.0);
        lu.ftran_sol_dense = false;
    } else {
        for (ipxint k : lu.ftran_sol_pat) lu.ftran_sol[k] = 0.0;
    }
    if (nz >= 0) {
        lu.ftran_sol_pat.assign(lu.xw_ftpat.data(),
                                lu.xw_ftpat.data() + nz);
        for (ipxint t = 0; t < nz; t++) {
            ipxint k = lu.xw_ftpat[t];
            lu.ftran_sol[k] = lu.xw_ft[k];
        }
        lu.ftran_pat.assign(lu.xw_ftpat.data(), lu.xw_ftpat.data() + nz);
        lu.ftran_pat_valid = true;
    } else {
        std::memcpy(lu.ftran_sol.data(), lu.xw_ft.data(),
                    m * sizeof(double));
        lu.ftran_sol_dense = true;
        lu.ftran_pat_valid = false;
    }
    lu.have_ftran = true;
    if (count) {
        c.nftran++;
        if (nz >= 0 && nz <= m / 10) c.nftran_sparse++;
    }
    c.t_ftran += now_monotonic_s() - t0;
    return nz;
}

// Gate for the blocked candidate FTRAN: pays off when solves run dense
// (fill makes the factor traversal the dominant, rhs-independent cost).
static inline bool ftran_block_worthwhile(const IpxLu& lu, int ncand) {
    return ncand >= 4 && lu.have_factors && lu.update_mode != 1
        && lu.factor_nnz >= 3 * lu.bnnz;
}

// Solves B X = [a_j1 .. a_jW] for up to W=16 candidate columns in ONE
// blocked dense pass over the factors (+ the current eta chain), storing X
// in basis-slot space. Each consumption (ftran_from_block) then applies
// only the etas appended since.
static void ftran_block_build(IpxLu& lu, const ipxint* cols, int W,
                              XoverCounts& c) {
    const ipxint m = lu.m, n = lu.mb_n;
    double t0 = now_monotonic_s();
    lu.bb_X.assign((size_t)m * W, 0.0);
    lu.bb_cols.assign(cols, cols + W);
    lu.bb_W = W;
    double* X = lu.bb_X.data();
    // scatter rhs columns into row-permuted position space
    for (int t = 0; t < W; t++) {
        ipxint j = cols[t];
        if (j < n) {
            for (ipxint p = lu.mb_Ap[j]; p < lu.mb_Ap[j + 1]; p++)
                X[(size_t)lu.rowperm_inv[lu.mb_Ai[p]] * W + t] =
                    lu.mb_Ax[p];
        } else {
            X[(size_t)lu.rowperm_inv[j - n] * W + t] = 1.0;
        }
    }
    // blocked L solve (unit diagonal, ascending positions)
    for (ipxint k = 0; k < m; k++) {
        const double* xk = X + (size_t)k * W;
        bool any = false;
        for (int t = 0; t < W; t++) any = any || (xk[t] != 0.0);
        if (!any) continue;
        for (ipxint p = lu.L.ptr[k]; p < lu.L.ptr[k + 1]; p++) {
            double* xi = X + (size_t)lu.L.idx[p] * W;
            const double lv = lu.L.val[p];
            for (int t = 0; t < W; t++) xi[t] -= lv * xk[t];
        }
    }
    // blocked U solve (explicit diagonal, descending positions)
    for (ipxint k = m - 1; k >= 0; k--) {
        double* xk = X + (size_t)k * W;
        const double d = lu.Udiag[k];
        bool any = false;
        for (int t = 0; t < W; t++) {
            xk[t] /= d;
            any = any || (xk[t] != 0.0);
        }
        if (!any) continue;
        for (ipxint p = lu.U.ptr[k]; p < lu.U.ptr[k + 1]; p++) {
            double* xi = X + (size_t)lu.U.idx[p] * W;
            const double uv = lu.U.val[p];
            for (int t = 0; t < W; t++) xi[t] -= uv * xk[t];
        }
    }
    // permute rows into basis-slot space (slot of position k is colperm[k])
    {
        std::vector<double>& tmp = lu.workd;    // reuse; m >= W rows copied
        static thread_local std::vector<double> X2v;
        (void)tmp;
        X2v.assign((size_t)m * W, 0.0);
        double* X2 = X2v.data();
        for (ipxint k = 0; k < m; k++)
            std::memcpy(X2 + (size_t)lu.colperm[k] * W,
                        X + (size_t)k * W, W * sizeof(double));
        lu.bb_X.swap(X2v);
        X = lu.bb_X.data();
    }
    // apply the existing eta chain, blocked
    for (const Eta& e : lu.etas) {
        double* xp = X + (size_t)e.pos * W;
        bool any = false;
        for (int t = 0; t < W; t++) {
            xp[t] /= e.diag;
            any = any || (xp[t] != 0.0);
        }
        if (!any) continue;
        for (size_t q = 0; q < e.idx.size(); q++) {
            double* xi = X + (size_t)e.idx[q] * W;
            const double ev = e.val[q];
            for (int t = 0; t < W; t++) xi[t] -= ev * xp[t];
        }
    }
    // transpose to candidate-major (W x m): every per-candidate pass
    // downstream (consume/score) then streams ONE contiguous column
    // instead of a stride-W gather that touches the whole block
    {
        static thread_local std::vector<double> Xtv;
        Xtv.assign((size_t)m * W, 0.0);
        double* Xt = Xtv.data();
        for (ipxint k = 0; k < m; k++) {
            const double* xk = X + (size_t)k * W;
            for (int t = 0; t < W; t++)
                Xt[(size_t)t * m + k] = xk[t];
        }
        lu.bb_X.swap(Xtv);
    }
    lu.bb_eta_base = lu.etas.size();
    lu.bb_gen = lu.factor_gen;
    c.t_ftran += now_monotonic_s() - t0;
}

// Consumes candidate jn from the block: copies its column into the staged
// FTRAN solution (lu.xw_ft + lu.ftran_sol) and applies the etas appended
// after the block was built. Returns nz (-1 dense) like
// ftran_col_for_update, or -2 when the block cannot serve jn.
static ipxint ftran_from_block(IpxLu& lu, ipxint jn, XoverCounts& c,
                               bool count) {
    if (lu.bb_gen != lu.factor_gen || lu.bb_W == 0)
        return -2;
    int slot = -1;
    for (int t = 0; t < lu.bb_W; t++)
        if (lu.bb_cols[t] == jn) { slot = t; break; }
    if (slot < 0)
        return -2;
    const ipxint m = lu.m;
    double t0 = now_monotonic_s();
    double* x = lu.xw_ft.data();
    const double* X = lu.bb_X.data();
    std::memcpy(x, X + (size_t)slot * m, m * sizeof(double));
    lu.xw_ft_dense = true;
    // etas appended since the block was built
    for (size_t q = lu.bb_eta_base; q < lu.etas.size(); q++) {
        const Eta& e = lu.etas[q];
        double xp = x[e.pos] / e.diag;
        if (x[e.pos] != 0.0 || xp != 0.0) {
            x[e.pos] = xp;
            if (xp != 0.0)
                for (size_t t = 0; t < e.idx.size(); t++)
                    x[e.idx[t]] -= e.val[t] * xp;
        }
    }
    std::memcpy(lu.ftran_sol.data(), x, m * sizeof(double));
    lu.ftran_sol_dense = true;
    lu.ftran_pat_valid = false;
    lu.have_ftran = true;
    lu.bb_cols[slot] = -1;
    if (count) c.nftran++;
    c.t_ftran += now_monotonic_s() - t0;
    return -1;
}

// ExchangeIfStable (counterpart of reference: src/basis.cc:286-322).
// sys > 0: entering column jn needs FTRAN staging; sys < 0: leaving
// position needs BTRAN staging. Returns 0 exchanged, 1 not exchanged (old
// basis refactorized, retry the push), 301/306 fatal.
static ipxint xover_exchange(IpxLu& lu, ipxint* basis, ipxint* map2basis,
                             ipxint jb, ipxint jn, double pivot, int sys,
                             ipxint* fresh, XoverCounts& c) {
    const ipxint m = lu.m;
    if (sys > 0)
        ftran_col_for_update(lu, jn, c, false);
    if (sys < 0) {
        ipxint mp = map2basis[jb];
        lu.btran_pos = mp >= m ? mp - m : mp;
    }
    double t0 = now_monotonic_s();
    ipxint err = update_impl(lu, pivot);
    c.t_update += now_monotonic_s() - t0;
    if (err != 0) {
        if (*fresh && !tighten_pivottol(lu))
            return 306;                 // BASIS_TOO_ILL_CONDITIONED
        ipxint ferr = xover_refactorize(lu, basis, c);
        if (ferr) return ferr;
        *fresh = 1;
        return 1;
    }
    ipxint mp = map2basis[jb];
    ipxint ib = mp >= m ? mp - m : mp;
    basis[ib] = jn;
    map2basis[jn] = ib;
    map2basis[jb] = -1;
    c.nupdates++;
    *fresh = 0;
    if (need_fresh_impl(lu)) {
        ipxint ferr = xover_refactorize(lu, basis, c);
        if (ferr) return ferr;
        *fresh = 1;
    }
    return 0;
}

// Tableau row of the basic variable at position pos: BTRAN of e_pos, then
// sparse-vector*CSR or dense*CSC chosen by a fill estimate (counterpart of
// reference: src/basis.cc:216-284). Stages the BTRAN for a later update.
// Keeps only nonbasic columns (map2basis -1, and -2 unless ignore_fixed).
// Returns nz (pattern in rowpat, values dense in row) or -1 dense.
// bt buffer convention: lu.xw_bt is kept ALL-ZERO between calls (the
// dense zero-fill per hypersparse BTRAN dominated the push/maxvol/drop
// loops). tableau_row_native restores the invariant before returning
// unless keep_bt (then the caller clears after consuming bt).
static void clear_bt(IpxLu& lu, double* bt, const ipxint* btpat,
                     ipxint bnz) {
    if (bnz >= 0) {
        for (ipxint t = 0; t < bnz; t++) bt[btpat[t]] = 0.0;
    } else {
        std::fill(bt, bt + lu.m, 0.0);
    }
}

// RAII helper: restores the all-zero bt invariant on every scope exit
// (continue/break/fallthrough) of loop bodies that consume bt.
struct clear_bt_guard {
    IpxLu& lu;
    double* bt;
    const ipxint* btpat;
    ipxint bnz;
    ~clear_bt_guard() { clear_bt(lu, bt, btpat, bnz); }
};

static ipxint tableau_row_native(IpxLu& lu, const ipxint* map2basis,
                                 ipxint pos, int ignore_fixed, double* bt,
                                 ipxint* btpat, ipxint* bt_nz_out,
                                 double* row, ipxint* rowpat,
                                 XoverCounts& c, bool keep_bt = false) {
    const ipxint m = lu.m, n = lu.mb_n;
    double t0 = now_monotonic_s();
    ipxint bnz = btran_sparse_unit(lu, pos, bt, btpat,
                                   /*assume_zero=*/bt == lu.xw_bt.data());
    lu.btran_pos = pos;
    c.nbtran++;
    if (bnz >= 0 && bnz <= m / 10) c.nbtran_sparse++;
    c.t_btran += now_monotonic_s() - t0;
    *bt_nz_out = bnz;

    bool use_sparse = bnz >= 0;
    if (use_sparse) {
        ipxint est = bnz;
        for (ipxint t = 0; t < bnz; t++) {
            ipxint i = btpat[t];
            est += lu.mb_ARp[i + 1] - lu.mb_ARp[i];
        }
        if (est / 2 > (n + m) / 10) use_sparse = false;
    }
    auto keep = [&](ipxint j) {
        ipxint mp = map2basis[j];
        return mp == -1 || (mp == -2 && !ignore_fixed);
    };
    if (use_sparse) {
        const ipxint sv = ++lu.xw_rowstampval;
        ipxint nz = 0;
        for (ipxint t = 0; t < bnz; t++) {
            ipxint i = btpat[t];
            double v = bt[i];
            if (v == 0.0) continue;
            for (ipxint p = lu.mb_ARp[i]; p < lu.mb_ARp[i + 1]; p++) {
                ipxint j = lu.mb_ARi[p];
                if (lu.xw_rowstamp[j] != sv) {
                    lu.xw_rowstamp[j] = sv;
                    row[j] = 0.0;
                    rowpat[nz++] = j;
                }
                row[j] += v * lu.mb_ARx[p];
            }
        }
        // filter structural entries by status, drop exact zeros
        ipxint keepnz = 0;
        for (ipxint t = 0; t < nz; t++) {
            ipxint j = rowpat[t];
            if (row[j] != 0.0 && keep(j))
                rowpat[keepnz++] = j;
        }
        nz = keepnz;
        // slack entries: row[n+i] = btran[i]
        for (ipxint t = 0; t < bnz; t++) {
            ipxint i = btpat[t];
            ipxint j = n + i;
            if (bt[i] != 0.0 && keep(j)) {
                row[j] = bt[i];
                rowpat[nz++] = j;
            }
        }
        if (!keep_bt) clear_bt(lu, bt, btpat, bnz);
        return nz;
    }
    // dense: dot each kept CSC column; slack entries from btran
    for (ipxint j = 0; j < n; j++) {
        double d = 0.0;
        if (keep(j)) {
            for (ipxint p = lu.mb_Ap[j]; p < lu.mb_Ap[j + 1]; p++)
                d += lu.mb_Ax[p] * bt[lu.mb_Ai[p]];
        }
        row[j] = d;
    }
    for (ipxint i = 0; i < m; i++)
        row[n + i] = keep(n + i) ? bt[i] : 0.0;
    if (!keep_bt) clear_bt(lu, bt, btpat, bnz);
    return -1;
}

// ---------------------------------------------------------------------
// Explicit normal matrix S = A diag(W_struct) A' + diag(W_slack), stored
// row-wise (CSR, full symmetric storage, diagonal entry first in each row).
// Within one KKT factorize the weights W are constant for the whole CR
// solve (typically 100+ iterations, reference: src/kkt_solver_diag.cc), so
// when the fill of S is small it pays to form S once per factorize and run
// CR with a sequential row-parallel CSR SpMV instead of the one-pass
// gather/scatter product over the columns of A. Gated by a fill cap: on
// problems with denser columns nnz(S) grows quadratically and the caller
// falls back to the one-pass kernel (ipxlu_normal_apply).
struct NrmExplicit {
    ipxint m = 0, n = 0;
    // borrowed views of A (CSC); the caller keeps them alive
    const ipxint* Ap = nullptr;
    const int32_t* Ai = nullptr;
    const double* Ax = nullptr;
    // A row-wise (values included: numeric refresh walks rows of A)
    std::vector<ipxint> ATp;
    std::vector<int32_t> ATi;
    std::vector<double> ATx;
    // S row-wise
    std::vector<ipxint> Sp;
    std::vector<int32_t> Si;
    std::vector<double> Sx;
    // compressed 16-bit copy of the column indices when m < 65536: the CR
    // SpMV is memory-bandwidth-bound and the index stream is a third of
    // the f32 traffic, so halving it is a direct throughput win
    std::vector<uint16_t> Si16;
    // f32 copy of the values for the mixed-precision CR (refreshed lazily
    // from Sx by nrm_values32)
    std::vector<float> Sx32;
    bool sx32_fresh = false;
    // IC(0) preconditioner on the pattern of S (strict lower triangle rows
    // sorted by column + separate diagonal), plus the transpose layout for
    // the backward solve. Symbolic part built once; numeric refresh per
    // KKT factorize with a diagonal-shift ladder on breakdown.
    std::vector<ipxint> Icp;        // strict-lower rows of L (CSR)
    std::vector<int32_t> Ici;
    std::vector<double> Icv;
    std::vector<double> Icd;        // diag(L)
    std::vector<ipxint> Itp;        // strict-upper rows of L' (CSR)
    std::vector<int32_t> Iti;
    std::vector<double> Itv;
    std::vector<ipxint> Itmap;      // Icv position -> Itv position
    std::vector<ipxint> Sdiagpos;   // position of S[i,i] in row i
    std::vector<ipxint> Slowmap;    // Icv position -> Sx position
    bool ic_symbolic_done = false;
    bool ic_ok = false;
};

// Builds the pattern of S; returns nullptr if nnz(S) would exceed the cap.
static NrmExplicit* nrm_symbolic(ipxint m, ipxint n, const ipxint* Ap,
                                 const int32_t* Ai, const double* Ax,
                                 ipxint cap) {
    NrmExplicit* h = new NrmExplicit();
    h->m = m; h->n = n; h->Ap = Ap; h->Ai = Ai; h->Ax = Ax;
    const ipxint nnz = Ap[n];
    // transpose pattern+values of A
    h->ATp.assign(m + 1, 0);
    h->ATi.resize(nnz);
    h->ATx.resize(nnz);
    for (ipxint p = 0; p < nnz; p++)
        h->ATp[Ai[p] + 1]++;
    for (ipxint i = 0; i < m; i++)
        h->ATp[i + 1] += h->ATp[i];
    {
        std::vector<ipxint> next(h->ATp.begin(), h->ATp.end() - 1);
        for (ipxint j = 0; j < n; j++)
            for (ipxint p = Ap[j]; p < Ap[j + 1]; p++) {
                ipxint q = next[Ai[p]]++;
                h->ATi[q] = (int32_t)j;
                h->ATx[q] = Ax[p];
            }
    }
    // row-by-row union of the patterns of the columns hitting the row;
    // diagonal first so the slack weight lands at Sp[i]
    h->Sp.assign(m + 1, 0);
    std::vector<ipxint> mark(m, -1);
    for (ipxint i = 0; i < m; i++) {
        mark[i] = i;
        h->Si.push_back((int32_t)i);
        for (ipxint t = h->ATp[i]; t < h->ATp[i + 1]; t++) {
            ipxint j = h->ATi[t];
            for (ipxint p = Ap[j]; p < Ap[j + 1]; p++) {
                ipxint r = Ai[p];
                if (mark[r] != i) {
                    mark[r] = i;
                    h->Si.push_back((int32_t)r);
                }
            }
        }
        h->Sp[i + 1] = (ipxint)h->Si.size();
        if ((ipxint)h->Si.size() > cap) {
            delete h;
            return nullptr;
        }
    }
    h->Sx.assign(h->Si.size(), 0.0);
    if (m < 65536)
        h->Si16.assign(h->Si.begin(), h->Si.end());
    return h;
}

// Numeric refresh: Sx for the given weights (O(sum_j c_j^2 + nnz(S))).
static void nrm_values(NrmExplicit& h, const double* W) {
    const ipxint m = h.m, n = h.n;
    h.sx32_fresh = false;
#ifdef _OPENMP
    if (h.Sp[m] >= (ipxint)1 << 17 && omp_get_max_threads() > 1) {
#pragma omp parallel
        {
            int nt = omp_get_num_threads();
            int tid = omp_get_thread_num();
            std::vector<double> w(m, 0.0);
            // contiguous row blocks balanced by nnz(S)
            ipxint lo = (ipxint)(std::lower_bound(
                h.Sp.data(), h.Sp.data() + m + 1,
                h.Sp[m] * tid / nt) - h.Sp.data());
            ipxint hi = (ipxint)(std::lower_bound(
                h.Sp.data(), h.Sp.data() + m + 1,
                h.Sp[m] * (tid + 1) / nt) - h.Sp.data());
            if (tid == 0) lo = 0;
            if (tid == nt - 1) hi = m;
            for (ipxint i = lo; i < hi; i++) {
                for (ipxint t = h.ATp[i]; t < h.ATp[i + 1]; t++) {
                    ipxint j = h.ATi[t];
                    double d = W[j] * h.ATx[t];
                    for (ipxint p = h.Ap[j]; p < h.Ap[j + 1]; p++)
                        w[h.Ai[p]] += d * h.Ax[p];
                }
                for (ipxint q = h.Sp[i]; q < h.Sp[i + 1]; q++) {
                    h.Sx[q] = w[h.Si[q]];
                    w[h.Si[q]] = 0.0;
                }
                h.Sx[h.Sp[i]] += W[n + i];   // diagonal is first
            }
        }
        return;
    }
#endif
    std::vector<double> w(m, 0.0);
    for (ipxint i = 0; i < m; i++) {
        for (ipxint t = h.ATp[i]; t < h.ATp[i + 1]; t++) {
            ipxint j = h.ATi[t];
            double d = W[j] * h.ATx[t];
            for (ipxint p = h.Ap[j]; p < h.Ap[j + 1]; p++)
                w[h.Ai[p]] += d * h.Ax[p];
        }
        for (ipxint q = h.Sp[i]; q < h.Sp[i + 1]; q++) {
            h.Sx[q] = w[h.Si[q]];
            w[h.Si[q]] = 0.0;
        }
        h.Sx[h.Sp[i]] += W[n + i];
    }
}

// lhs = S rhs with the curvature dot product fused; row-parallel.
// Templated over the value type (f64 / mixed-precision f32) and the index
// type (u16 when m < 65536 to halve the index stream).
template <class TV, class TI>
static double nrm_spmv_core(ipxint m, const ipxint* Sp, const TI* Si,
                            const TV* Sx, const TV* rhs, TV* lhs) {
    double dot = 0.0;
#ifdef _OPENMP
    if (Sp[m] >= (ipxint)1 << 17 && omp_get_max_threads() > 1) {
#pragma omp parallel reduction(+ : dot)
        {
            int nt = omp_get_num_threads();
            int tid = omp_get_thread_num();
            ipxint lo = (ipxint)(std::lower_bound(
                Sp, Sp + m + 1, Sp[m] * tid / nt) - Sp);
            ipxint hi = (ipxint)(std::lower_bound(
                Sp, Sp + m + 1, Sp[m] * (tid + 1) / nt) - Sp);
            if (tid == 0) lo = 0;
            if (tid == nt - 1) hi = m;
            for (ipxint i = lo; i < hi; i++) {
                TV v = 0;
                for (ipxint q = Sp[i]; q < Sp[i + 1]; q++)
                    v += Sx[q] * rhs[Si[q]];
                lhs[i] = v;
                dot += (double)rhs[i] * v;
            }
        }
        return dot;
    }
#endif
    for (ipxint i = 0; i < m; i++) {
        TV v = 0;
        for (ipxint q = Sp[i]; q < Sp[i + 1]; q++)
            v += Sx[q] * rhs[Si[q]];
        lhs[i] = v;
        dot += (double)rhs[i] * v;
    }
    return dot;
}

static double nrm_spmv_dot(const NrmExplicit& h, const double* rhs,
                           double* lhs) {
    if (!h.Si16.empty())
        return nrm_spmv_core(h.m, h.Sp.data(), h.Si16.data(), h.Sx.data(),
                             rhs, lhs);
    return nrm_spmv_core(h.m, h.Sp.data(), h.Si.data(), h.Sx.data(),
                         rhs, lhs);
}

static void nrm_values32(NrmExplicit& h) {
    if (h.sx32_fresh) return;
    h.Sx32.resize(h.Sx.size());
    const size_t nnz = h.Sx.size();
    for (size_t q = 0; q < nnz; q++) h.Sx32[q] = (float)h.Sx[q];
    h.sx32_fresh = true;
}

// f32 variant of the fused SpMV (half the value bandwidth; the dot
// accumulates in double for stability).
static double nrm_spmv_dot32(const NrmExplicit& h, const float* rhs,
                             float* lhs) {
    if (!h.Si16.empty())
        return nrm_spmv_core(h.m, h.Sp.data(), h.Si16.data(),
                             h.Sx32.data(), rhs, lhs);
    return nrm_spmv_core(h.m, h.Sp.data(), h.Si.data(), h.Sx32.data(),
                         rhs, lhs);
}

// ---------------------------------------------------------------------
// IC(0) preconditioner on the explicit normal matrix: incomplete Cholesky
// on the pattern of S, with a diagonal-shift ladder on breakdown
// (Manteuffel). Far stronger than the diagonal preconditioner on the
// network/Laplacian-like normal matrices of phase 1, at ~2 gather sweeps
// per application. This has no counterpart in the reference (which uses
// diag + dense-column SMW only, reference: src/diagonal_precond.cc); it is
// a beyond-reference substitution allowed by the KKT-solver contract
// (inf-norm(D.res) <= tol, reference: src/kkt_solver.h:11-27).
// ---------------------------------------------------------------------

static void ic_symbolic(NrmExplicit& h) {
    if (h.ic_symbolic_done) return;
    h.ic_symbolic_done = true;
    const ipxint m = h.m;
    // guard: the up-looking merge cost is bounded by sum of squared row
    // counts; bail out when the pattern is too dense for IC(0) to be a
    // cheap preconditioner
    double work = 0.0;
    for (ipxint i = 0; i < m; i++) {
        double c = (double)(h.Sp[i + 1] - h.Sp[i]);
        work += c * c;
    }
    if (work > 256.0 * (double)h.Sp[m]) return;
    h.Icp.assign(m + 1, 0);
    h.Sdiagpos.assign(m, -1);
    h.Ici.clear();
    h.Slowmap.clear();
    h.Ici.reserve((h.Sp[m] - m) / 2);
    h.Slowmap.reserve((h.Sp[m] - m) / 2);
    std::vector<std::pair<int32_t, ipxint>> row;
    for (ipxint i = 0; i < m; i++) {
        row.clear();
        for (ipxint q = h.Sp[i]; q < h.Sp[i + 1]; q++) {
            int32_t j = h.Si[q];
            if (j == (int32_t)i)
                h.Sdiagpos[i] = q;
            else if (j < (int32_t)i)
                row.emplace_back(j, q);
        }
        if (h.Sdiagpos[i] < 0) { h.Icp.clear(); return; }
        std::sort(row.begin(), row.end());
        for (auto& e : row) {
            h.Ici.push_back(e.first);
            h.Slowmap.push_back(e.second);
        }
        h.Icp[i + 1] = (ipxint)h.Ici.size();
    }
    h.Icv.assign(h.Ici.size(), 0.0);
    h.Icd.assign(m, 0.0);
    // transpose layout: for each i, the entries (j > i, L[j,i]) of column i
    // — the backward-solve sweep
    h.Itp.assign(m + 1, 0);
    for (size_t q = 0; q < h.Ici.size(); q++) h.Itp[h.Ici[q] + 1]++;
    for (ipxint i = 0; i < m; i++) h.Itp[i + 1] += h.Itp[i];
    h.Iti.assign(h.Ici.size(), 0);
    h.Itmap.assign(h.Ici.size(), 0);
    std::vector<ipxint> w(h.Itp.begin(), h.Itp.end() - 1);
    for (ipxint i = 0; i < m; i++)
        for (ipxint q = h.Icp[i]; q < h.Icp[i + 1]; q++) {
            ipxint j = h.Ici[q];
            ipxint t = w[j]++;
            h.Iti[t] = (int32_t)i;
            h.Itmap[q] = t;
        }
    h.Itv.assign(h.Ici.size(), 0.0);
}

// Up-looking IC(0) with diagonal scaled by (1 + shift); false on breakdown.
static bool ic_numeric(NrmExplicit& h, double shift) {
    const ipxint m = h.m;
    const ipxint* Lp = h.Icp.data();
    const int32_t* Li = h.Ici.data();
    double* Lv = h.Icv.data();
    double* D = h.Icd.data();
    for (ipxint i = 0; i < m; i++) {
        for (ipxint q = Lp[i]; q < Lp[i + 1]; q++) {
            ipxint j = Li[q];
            double s = h.Sx[h.Slowmap[q]];
            ipxint a = Lp[i], b = Lp[j], bend = Lp[j + 1];
            while (a < q && b < bend) {
                int32_t ca = Li[a], cb = Li[b];
                if (ca == cb) {
                    s -= Lv[a] * Lv[b];
                    a++; b++;
                } else if (ca < cb) {
                    a++;
                } else {
                    b++;
                }
            }
            Lv[q] = s / D[j];
        }
        double d = h.Sx[h.Sdiagpos[i]] * (1.0 + shift);
        for (ipxint q = Lp[i]; q < Lp[i + 1]; q++) d -= Lv[q] * Lv[q];
        if (!(d > 0.0) || !std::isfinite(d)) return false;
        D[i] = std::sqrt(d);
    }
    for (size_t q = 0; q < h.Icv.size(); q++) h.Itv[h.Itmap[q]] = h.Icv[q];
    return true;
}

// x = (L L')^{-1} r; returns r . x fused (the preconditioned dot CR needs).
static double ic_solve(const NrmExplicit& h, const double* r, double* x) {
    const ipxint m = h.m;
    const ipxint* Lp = h.Icp.data();
    const int32_t* Li = h.Ici.data();
    const double* Lv = h.Icv.data();
    const double* D = h.Icd.data();
    for (ipxint i = 0; i < m; i++) {
        double v = r[i];
        for (ipxint q = Lp[i]; q < Lp[i + 1]; q++) v -= Lv[q] * x[Li[q]];
        x[i] = v / D[i];
    }
    const ipxint* Tp = h.Itp.data();
    const int32_t* Ti = h.Iti.data();
    const double* Tv = h.Itv.data();
    double dot = 0.0;
    for (ipxint i = m - 1; i >= 0; i--) {
        double v = x[i];
        for (ipxint q = Tp[i]; q < Tp[i + 1]; q++) v -= Tv[q] * x[Ti[q]];
        v /= D[i];
        x[i] = v;
        dot += r[i] * v;
    }
    return dot;
}

// CR with a general SPD preconditioner supplied as a solve functor
// (reference structure, src/conjugate_residuals.cc:90-213: recurrence-
// updated preconditioned residual with 5-iteration drift recheck).
template <class Apply, class Psolve>
static ipxint cr_psolve_core(ipxint m, Apply&& apply, Psolve&& psolve,
                             const double* resscale, const double* rhs,
                             double tol, ipxint maxiter, double deadline_s,
                             double* lhs, ipxint* out_iters, bool warm,
                             double* mvtime) {
    if (maxiter < 0) maxiter = m + 100;
    std::vector<double> residual(rhs, rhs + m);
    std::vector<double> sres(m), Csres(m), step(m), Cstep(m), pcd(m);

    auto now_s = []() {
        return std::chrono::duration<double>(
            std::chrono::steady_clock::now().time_since_epoch()).count();
    };
    auto timed_apply = [&](const double* in, double* out) {
        if (!mvtime) return apply(in, out);
        const double t0 = now_s();
        const double d = apply(in, out);
        *mvtime += now_s() - t0;
        return d;
    };

    if (warm) {
        timed_apply(lhs, Csres.data());
        for (ipxint i = 0; i < m; i++) residual[i] -= Csres[i];
    } else {
        std::fill(lhs, lhs + m, 0.0);
    }

    double rpn = psolve(residual.data(), sres.data());
    double cdot = timed_apply(sres.data(), Csres.data());
    std::copy(sres.begin(), sres.end(), step.begin());
    std::copy(Csres.begin(), Csres.end(), Cstep.begin());
    double resnorm = 0.0;
    for (ipxint i = 0; i < m; i++)
        resnorm = std::max(resnorm, std::fabs(resscale[i] * residual[i]));

    ipxint it = 0, err = 0;
    while (true) {
        if (resnorm <= tol) break;
        if (it >= maxiter) { err = 201; break; }
        if (cdot <= 0.0) { err = 202; break; }
        double pdot = psolve(Cstep.data(), pcd.data());
        if (pdot <= 0.0) { err = 203; break; }
        double alpha = cdot / pdot;
        if (!std::isfinite(alpha)) { err = 205; break; }
        double rn = 0.0;
        for (ipxint i = 0; i < m; i++) {
            lhs[i] += alpha * step[i];
            double r = residual[i] - alpha * Cstep[i];
            residual[i] = r;
            sres[i] -= alpha * pcd[i];
            rn = std::max(rn, std::fabs(resscale[i] * r));
        }
        resnorm = rn;
        double cdot_new = timed_apply(sres.data(), Csres.data());
        double beta = cdot_new / cdot;
        for (ipxint i = 0; i < m; i++) {
            step[i] = sres[i] + beta * step[i];
            Cstep[i] = Csres[i] + beta * Cstep[i];
        }
        cdot = cdot_new;
        it++;
        if (it % 5 == 0) {
            double rsdot = psolve(residual.data(), sres.data());
            if (rsdot >= rpn) { err = 204; break; }
            rpn = rsdot;
            if (deadline_s > 0.0 && now_s() > deadline_s) {
                err = 999;
                break;
            }
        }
    }
    *out_iters = it;
    return err;
}

// Preconditioned CR on the normal equations with a diagonal preconditioner;
// the matvec is supplied as a functor so the same recurrence drives both
// the one-pass product and the explicit-S product (counterpart of
// reference: src/conjugate_residuals.cc:90-213).
// Returns 0 ok, 201 iter limit, 202 matrix not posdef, 203 precond not
// posdef, 204 no progress, 205 inf/nan, 999 deadline exceeded.
template <class T, class Apply>
static ipxint cr_diag_core(ipxint m, Apply&& apply, const T* diag,
                           const T* resscale, const T* rhs,
                           double tol, ipxint maxiter, double deadline_s,
                           T* lhs, ipxint* out_iters,
                           bool warm = false, double* mvtime = nullptr) {
    // Fused formulation: the preconditioned residual z = M^{-1} r is
    // recomputed from its definition every iteration inside the axpy pass
    // (free: r is in registers there), which removes the reference's
    // separate precond pass and drift-correction pass entirely, and the
    // search-direction curvature norm p'C M^{-1} C p is accumulated inside
    // the direction-update pass. Three memory sweeps per iteration (one is
    // the SpMV) instead of five; identical recurrences otherwise
    // (reference: src/conjugate_residuals.cc:90-213).
    if (maxiter < 0) maxiter = m + 100;
    std::vector<T> residual(rhs, rhs + m);
    std::vector<T> z(m), Cz(m), step(m), Cstep(m);
    std::vector<T> inv_diag(m);
    for (ipxint i = 0; i < m; i++) inv_diag[i] = T(1.0) / diag[i];

    auto now_s = []() {
        return std::chrono::duration<double>(
            std::chrono::steady_clock::now().time_since_epoch()).count();
    };
    auto timed_apply = [&](const T* in, T* out) {
        if (!mvtime) return apply(in, out);
        const double t0 = now_s();
        const double d = apply(in, out);
        *mvtime += now_s() - t0;
        return d;
    };

    if (warm) {
        // lhs holds an initial guess: residual = rhs - C lhs (costs one
        // extra matvec; pays off when the guess is close, e.g. the
        // corrector solve starting from the predictor direction).
        timed_apply(lhs, Cz.data());
        for (ipxint i = 0; i < m; i++) residual[i] -= Cz[i];
    } else {
        std::fill(lhs, lhs + m, 0.0);
    }
#ifdef _OPENMP
    const bool par = m >= (ipxint)1 << 14 && omp_get_max_threads() > 1;
#endif

    const T* id = inv_diag.data();
    T* re = residual.data();

    // init: z = M^{-1} r fused with r'M^{-1}r (the monotonicity quantity)
    // and the scaled inf-norm of the residual
    double rpn = 0.0, resnorm = 0.0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) \
    reduction(+ : rpn) reduction(max : resnorm) if (par)
#endif
    for (ipxint i = 0; i < m; i++) {
        T zi = re[i] * id[i];
        z[i] = zi;
        rpn += (double)re[i] * zi;
        resnorm = std::max(resnorm,
                           (double)std::fabs(resscale[i] * re[i]));
    }
    double cdot = timed_apply(z.data(), Cz.data());
    double pdot = 0.0;
    {
        T* st = step.data();
        T* Cst = Cstep.data();
        const T* Cs = Cz.data();
        const T* zz = z.data();
#ifdef _OPENMP
#pragma omp parallel for schedule(static) reduction(+ : pdot) if (par)
#endif
        for (ipxint i = 0; i < m; i++) {
            st[i] = zz[i];
            T c = Cs[i];
            Cst[i] = c;
            pdot += (double)c * c * id[i];
        }
    }

    ipxint it = 0;
    ipxint err = 0;
    double rznew = rpn;
    while (true) {
        if (resnorm <= tol) break;
        if (it >= maxiter) { err = 201; break; }
        if (cdot <= 0.0) { err = 202; break; }
        if (pdot <= 0.0) { err = 203; break; }
        double alpha = cdot / pdot;
        if (!std::isfinite(alpha)) { err = 205; break; }
        {
            T* lh = lhs;
            T* zz = z.data();
            const T* st = step.data();
            const T* Cst = Cstep.data();
            const T alphaT = (T)alpha;
            double rn = 0.0, rz = 0.0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) \
    reduction(max : rn) reduction(+ : rz) if (par)
#endif
            for (ipxint i = 0; i < m; i++) {
                lh[i] += alphaT * st[i];
                T r = re[i] - alphaT * Cst[i];
                re[i] = r;
                T zi = r * id[i];
                zz[i] = zi;
                rz += (double)r * zi;
                rn = std::max(rn, (double)std::fabs(resscale[i] * r));
            }
            resnorm = rn;
            rznew = rz;
        }
        double cdot_new = timed_apply(z.data(), Cz.data());
        double beta = cdot_new / cdot;
        {
            T* st = step.data();
            T* Cst = Cstep.data();
            const T* zz = z.data();
            const T* Cs = Cz.data();
            const T betaT = (T)beta;
            double pd = 0.0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) reduction(+ : pd) if (par)
#endif
            for (ipxint i = 0; i < m; i++) {
                st[i] = zz[i] + betaT * st[i];
                T c = Cs[i] + betaT * Cst[i];
                Cst[i] = c;
                pd += (double)c * c * id[i];
            }
            pdot = pd;
        }
        cdot = cdot_new;
        it++;
        if (it % 5 == 0) {
            // z is definitional every iteration here, so the reference's
            // periodic drift correction reduces to the monotone-decrease
            // check on r'M^{-1}r (reference:
            // src/conjugate_residuals.cc:183-207).
            if (rznew >= rpn) { err = 204; break; }
            rpn = rznew;
            if (deadline_s > 0.0 && now_s() > deadline_s) {
                err = 999;
                break;
            }
        }
    }
    *out_iters = it;
    return err;
}

}  // namespace

// ---------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------
extern "C" {

void* ipxlu_new(ipxint m) {
    IpxLu* lu = new IpxLu();
    lu->m = m;
    return lu;
}

void ipxlu_free(void* h) { delete static_cast<IpxLu*>(h); }

void ipxlu_set_pivottol(void* h, double tol) {
    static_cast<IpxLu*>(h)->pivottol = tol;
}

// 0 = product-form (PFI) updates, 1 = Forrest-Tomlin (lu_kernel=1). Takes
// effect at the next factorization.
void ipxlu_set_update_mode(void* h, ipxint mode) {
    static_cast<IpxLu*>(h)->update_mode = (int)mode;
}

double ipxlu_get_pivottol(void* h) {
    return static_cast<IpxLu*>(h)->pivottol;
}

// returns status bits: 2 = singular (dependent cols replaced)
ipxint ipxlu_factorize(void* h, const ipxint* Bbegin, const ipxint* Bend,
                       const ipxint* Bi, const double* Bx,
                       ipxint strict_abs) {
    IpxLu& lu = *static_cast<IpxLu*>(h);
    return factorize(lu, Bbegin, Bend, Bi, Bx, (int)strict_abs);
}

ipxint ipxlu_factor_nnz(void* h) {
    return static_cast<IpxLu*>(h)->factor_nnz;
}

ipxint ipxlu_num_dependent(void* h) {
    return (ipxint)static_cast<IpxLu*>(h)->dependent.size();
}

void ipxlu_get_dependent(void* h, ipxint* out) {
    IpxLu& lu = *static_cast<IpxLu*>(h);
    std::copy(lu.dependent.begin(), lu.dependent.end(), out);
}

void ipxlu_get_perms(void* h, ipxint* rowperm, ipxint* colperm) {
    IpxLu& lu = *static_cast<IpxLu*>(h);
    std::copy(lu.rowperm.begin(), lu.rowperm.end(), rowperm);
    std::copy(lu.colperm.begin(), lu.colperm.end(), colperm);
}

// Exports factor sizes then data. L unit-lower (strict part), U upper with
// diagonal merged in, both CSC in position space with sorted indices.
void ipxlu_factor_sizes(void* h, ipxint* lnnz, ipxint* unnz) {
    IpxLu& lu = *static_cast<IpxLu*>(h);
    *lnnz = (ipxint)lu.L.idx.size();
    *unnz = (ipxint)(lu.U.idx.size() + lu.m);
}

void ipxlu_get_factors(void* h, ipxint* Lp, ipxint* Li, double* Lx,
                       ipxint* Up, ipxint* Ui, double* Ux) {
    IpxLu& lu = *static_cast<IpxLu*>(h);
    const ipxint m = lu.m;
    std::copy(lu.L.ptr.begin(), lu.L.ptr.end(), Lp);
    std::copy(lu.L.idx.begin(), lu.L.idx.end(), Li);
    std::copy(lu.L.val.begin(), lu.L.val.end(), Lx);
    // U with diagonal: column k = strict entries + diag at end (sorted)
    ipxint p = 0;
    for (ipxint k = 0; k < m; k++) {
        Up[k] = p;
        for (ipxint t = lu.U.ptr[k]; t < lu.U.ptr[k + 1]; t++) {
            Ui[p] = lu.U.idx[t];
            Ux[p] = lu.U.val[t];
            p++;
        }
        Ui[p] = k;
        Ux[p] = lu.Udiag[k];
        p++;
    }
    Up[m] = p;
}

void ipxlu_solve_dense(void* h, const double* rhs, double* lhs, ipxint trans) {
    IpxLu& lu = *static_cast<IpxLu*>(h);
    if (trans)
        btran_dense(lu, rhs, lhs);
    else
        ftran_dense(lu, rhs, lhs);
}

// FTRAN with sparse rhs; also records the result as the pending spike for a
// subsequent update. Returns nz >= 0 with pattern in pat, or -1 (dense).
ipxint ipxlu_ftran_for_update(void* h, ipxint nb, const ipxint* bi,
                              const double* bx, double* lhs, ipxint* pat) {
    IpxLu& lu = *static_cast<IpxLu*>(h);
    ipxint nz = ftran_sparse(lu, nb, bi, bx, lhs, pat);
    // record spike
    std::memcpy(lu.ftran_sol.data(), lhs, lu.m * sizeof(double));
    lu.ftran_sol_dense = true;
    if (nz >= 0) {
        lu.ftran_pat.assign(pat, pat + nz);
        lu.ftran_pat_valid = true;
    } else {
        lu.ftran_pat_valid = false;
    }
    lu.have_ftran = true;
    return nz;
}

// Stages position pos as leaving without computing the BTRAN solution.
void ipxlu_stage_btran(void* h, ipxint pos) {
    static_cast<IpxLu*>(h)->btran_pos = pos;
}

// BTRAN of unit vector at basis position pos; records pos for update.
ipxint ipxlu_btran_for_update(void* h, ipxint pos, double* lhs, ipxint* pat) {
    IpxLu& lu = *static_cast<IpxLu*>(h);
    lu.btran_pos = pos;
    if (lhs == nullptr)
        return 0;
    return btran_sparse_unit(lu, pos, lhs, pat);
}

// Applies the pending exchange as a PFI eta. Returns
//  -1 singular (new pivot ~ 0), 1 unstable (pivot mismatch), 0 ok.
ipxint ipxlu_update(void* h, double pivot) {
    return update_impl(*static_cast<IpxLu*>(h), pivot);
}

// In-place dense triangular solves in position space with the FRESH factors
// (ignores etas and the row/column permutations). which: 0 = (L+I)x=b,
// 1 = Ux=b, 2 = (L+I)'x=b, 3 = U'x=b. Used by the basis-preconditioned
// normal operator, which works in the factorization's pivot order.
void ipxlu_tri_solve(void* h, double* x, ipxint which) {
    IpxLu& lu = *static_cast<IpxLu*>(h);
    const ipxint m = lu.m;
    switch (which) {
    case 0: dense_lsolve(lu.L, x, m); break;
    case 1: dense_usolve(lu.U, lu.Udiag.data(), x, m); break;
    case 2: dense_ltsolve(lu.Lt, x, m); break;
    case 3: dense_utsolve(lu.Ut, lu.Udiag.data(), x, m); break;
    }
}

// Blocked dense solves for general multi-RHS: B X = RHS (trans=0) or
// B' X = RHS (trans=1), X row-major (m, W), eta chain applied. The blocked
// inner axpy vectorizes over the W right-hand sides, amortizing the factor
// traversal — the building block for scenario-batched phase-2 KKT solves
// (shared basis across scenarios; no reference counterpart).
void ipxlu_solve_dense_block(void* h, const double* RHS, double* X,
                             ipxint W, ipxint trans) {
    IpxLu& lu = *static_cast<IpxLu*>(h);
    const ipxint m = lu.m;
    if (lu.update_mode == 1 && lu.ft_valid) {
        // FT mode: per-rhs dense solves (the blocked factor traversal is
        // a PFI-path optimization; FT's dynamic U file is not blocked)
        std::vector<double> b(m), x(m);
        for (ipxint t = 0; t < W; t++) {
            for (ipxint i = 0; i < m; i++) b[i] = RHS[(size_t)i * W + t];
            if (trans)
                btran_dense(lu, b.data(), x.data());
            else
                ftran_dense(lu, b.data(), x.data());
            for (ipxint i = 0; i < m; i++) X[(size_t)i * W + t] = x[i];
        }
        return;
    }
    static thread_local std::vector<double> wbuf;
    wbuf.assign((size_t)m * W, 0.0);
    double* Y = wbuf.data();
    if (!trans) {
        // FTRAN: rows -> slots. permute rhs into position space
        for (ipxint k = 0; k < m; k++)
            std::memcpy(Y + (size_t)k * W,
                        RHS + (size_t)lu.rowperm[k] * W,
                        W * sizeof(double));
        for (ipxint k = 0; k < m; k++) {           // blocked L solve
            const double* xk = Y + (size_t)k * W;
            bool any = false;
            for (ipxint t = 0; t < W; t++) any = any || (xk[t] != 0.0);
            if (!any) continue;
            for (ipxint p = lu.L.ptr[k]; p < lu.L.ptr[k + 1]; p++) {
                double* xi = Y + (size_t)lu.L.idx[p] * W;
                const double lv = lu.L.val[p];
                for (ipxint t = 0; t < W; t++) xi[t] -= lv * xk[t];
            }
        }
        for (ipxint k = m - 1; k >= 0; k--) {      // blocked U solve
            double* xk = Y + (size_t)k * W;
            const double d = lu.Udiag[k];
            bool any = false;
            for (ipxint t = 0; t < W; t++) {
                xk[t] /= d;
                any = any || (xk[t] != 0.0);
            }
            if (!any) continue;
            for (ipxint p = lu.U.ptr[k]; p < lu.U.ptr[k + 1]; p++) {
                double* xi = Y + (size_t)lu.U.idx[p] * W;
                const double uv = lu.U.val[p];
                for (ipxint t = 0; t < W; t++) xi[t] -= uv * xk[t];
            }
        }
        // positions -> slots, then etas (slot space), blocked
        for (ipxint k = 0; k < m; k++)
            std::memcpy(X + (size_t)lu.colperm[k] * W,
                        Y + (size_t)k * W, W * sizeof(double));
        for (const Eta& e : lu.etas) {
            double* xp = X + (size_t)e.pos * W;
            bool any = false;
            for (ipxint t = 0; t < W; t++) {
                xp[t] /= e.diag;
                any = any || (xp[t] != 0.0);
            }
            if (!any) continue;
            for (size_t q = 0; q < e.idx.size(); q++) {
                double* xi = X + (size_t)e.idx[q] * W;
                const double ev = e.val[q];
                for (ipxint t = 0; t < W; t++) xi[t] -= ev * xp[t];
            }
        }
    } else {
        // BTRAN: slots -> rows. eta transposes first (reverse order)
        std::memcpy(Y, RHS, (size_t)m * W * sizeof(double));
        for (auto it = lu.etas.rbegin(); it != lu.etas.rend(); ++it) {
            const Eta& e = *it;
            double* xp = Y + (size_t)e.pos * W;
            for (size_t q = 0; q < e.idx.size(); q++) {
                const double* xi = Y + (size_t)e.idx[q] * W;
                const double ev = e.val[q];
                for (ipxint t = 0; t < W; t++) xp[t] -= ev * xi[t];
            }
            for (ipxint t = 0; t < W; t++) xp[t] /= e.diag;
        }
        // slots -> positions
        static thread_local std::vector<double> wbuf2;
        wbuf2.assign((size_t)m * W, 0.0);
        double* Z = wbuf2.data();
        for (ipxint k = 0; k < m; k++)
            std::memcpy(Z + (size_t)k * W,
                        Y + (size_t)lu.colperm[k] * W,
                        W * sizeof(double));
        for (ipxint k = 0; k < m; k++) {           // blocked U' solve
            double* xk = Z + (size_t)k * W;
            const double d = lu.Udiag[k];
            bool any = false;
            for (ipxint t = 0; t < W; t++) {
                xk[t] /= d;
                any = any || (xk[t] != 0.0);
            }
            if (!any) continue;
            for (ipxint p = lu.Ut.ptr[k]; p < lu.Ut.ptr[k + 1]; p++) {
                double* xi = Z + (size_t)lu.Ut.idx[p] * W;
                const double uv = lu.Ut.val[p];
                for (ipxint t = 0; t < W; t++) xi[t] -= uv * xk[t];
            }
        }
        for (ipxint k = m - 1; k >= 0; k--) {      // blocked L' solve
            const double* xk = Z + (size_t)k * W;
            bool any = false;
            for (ipxint t = 0; t < W; t++) any = any || (xk[t] != 0.0);
            if (!any) continue;
            for (ipxint p = lu.Lt.ptr[k]; p < lu.Lt.ptr[k + 1]; p++) {
                double* xi = Z + (size_t)lu.Lt.idx[p] * W;
                const double lv = lu.Lt.val[p];
                for (ipxint t = 0; t < W; t++) xi[t] -= lv * xk[t];
            }
        }
        // positions -> rows
        for (ipxint k = 0; k < m; k++)
            std::memcpy(X + (size_t)lu.rowperm[k] * W,
                        Z + (size_t)k * W, W * sizeof(double));
    }
}

// Debug/test export: solve a candidate block with ftran_block_build and
// extract every column through ftran_from_block (out column-major m x W).
// Returns 0, or -1 when a column could not be served from the block.
ipxint ipxlu_ftran_block_debug(void* h, const ipxint* cols, ipxint W,
                               double* out) {
    IpxLu& lu = *static_cast<IpxLu*>(h);
    const ipxint m = lu.m;
    XoverCounts c;
    c.fills = nullptr;
    c.fills_cap = 0;
    ftran_block_build(lu, cols, (int)W, c);
    for (ipxint t = 0; t < W; t++) {
        if (ftran_from_block(lu, cols[t], c, false) == -2)
            return -1;
        std::memcpy(out + (size_t)t * m, lu.ftran_sol.data(),
                    m * sizeof(double));
    }
    return 0;
}

void ipxlu_get_phase_times(void* h, double* out3) {
    IpxLu& lu = *static_cast<IpxLu*>(h);
    out3[0] = lu.t_search;
    out3[1] = lu.t_elim;
    out3[2] = lu.t_build;
}

void ipxlu_get_search_times(void* h, double* out4) {
    IpxLu& lu = *static_cast<IpxLu*>(h);
    out4[0] = lu.t_s_scan;
    out4[1] = lu.t_s_col;
    out4[2] = lu.t_s_row;
    out4[3] = (double)lu.n_steps;
    out4[4] = (double)lu.n_cloop;
    out4[5] = (double)lu.n_cvisit;
    out4[6] = (double)lu.n_centry;
    out4[7] = lu.t_mv_scan;
    out4[8] = (double)lu.n_mv_scans;
}

ipxint ipxlu_need_fresh(void* h) {
    return need_fresh_impl(*static_cast<IpxLu*>(h));
}

ipxint ipxlu_num_updates(void* h) {
    IpxLu& lu = *static_cast<IpxLu*>(h);
    if (lu.update_mode == 1)
        return (ipxint)lu.ft_etas.size();
    return (ipxint)lu.etas.size();
}

double ipxlu_fill_factor(void* h) {
    IpxLu& lu = *static_cast<IpxLu*>(h);
    return (double)lu.factor_nnz / (double)lu.bnnz;
}

// ---------------------------------------------------------------------
// Fused normal-matrix apply: lhs = A diag(W_struct) A' rhs + W_slack . rhs
// in ONE pass over the columns of A (the strategy the reference chose after
// profiling three variants, reference: src/normal_matrix.cc:10-22,64-75).
// Parallelized over column blocks with per-thread accumulators (the scatter
// target is private per thread, then reduced) when OpenMP is available.
// Returns rhs . lhs fused with the product.
double ipxlu_normal_apply(ipxint m, ipxint n, const ipxint* Ap,
                          const int32_t* Ai, const double* Ax,
                          const double* W, const double* rhs, double* lhs) {
#ifdef _OPENMP
    if ((Ap[n] >= (ipxint)1 << 17) && omp_get_max_threads() > 1) {
        static std::vector<std::vector<double>> accs;   // per-thread scatter
        int NT = omp_get_max_threads();
        if ((int)accs.size() < NT) accs.resize(NT);
        double dot = 0.0;
#pragma omp parallel num_threads(NT) reduction(+ : dot)
        {
            int nt = omp_get_num_threads();
            int tid = omp_get_thread_num();
            auto& mine = accs[tid];
            if ((ipxint)mine.size() < m) mine.resize(m);
            std::fill(mine.begin(), mine.begin() + m, 0.0);
            double* a = mine.data();
            // contiguous nnz-balanced column blocks
            const ipxint nnz = Ap[n];
            ipxint lo = (ipxint)(std::lower_bound(
                Ap, Ap + n + 1, nnz * tid / nt) - Ap);
            ipxint hi = (ipxint)(std::lower_bound(
                Ap, Ap + n + 1, nnz * (tid + 1) / nt) - Ap);
            if (tid == 0) lo = 0;
            if (tid == nt - 1) hi = n;
            for (ipxint j = lo; j < hi; j++) {
                const ipxint begin = Ap[j], end = Ap[j + 1];
                double d = 0.0;
                for (ipxint p = begin; p < end; p++)
                    d += rhs[Ai[p]] * Ax[p];
                d *= W[j];
                if (d != 0.0)
                    for (ipxint p = begin; p < end; p++)
                        a[Ai[p]] += d * Ax[p];
            }
#pragma omp barrier
            // reduce all accumulators into lhs by row blocks; fused dot
            ipxint rlo = m * (ipxint)tid / nt, rhi = m * ((ipxint)tid + 1) / nt;
            double d2 = 0.0;
            for (ipxint i = rlo; i < rhi; i++) {
                double v = rhs[i] * W[n + i];
                for (int t = 0; t < nt; t++)
                    v += accs[t][i];
                lhs[i] = v;
                d2 += rhs[i] * v;
            }
            dot += d2;
        }
        return dot;
    }
#endif
    for (ipxint i = 0; i < m; i++)
        lhs[i] = rhs[i] * W[n + i];
    for (ipxint j = 0; j < n; j++) {
        const ipxint begin = Ap[j], end = Ap[j + 1];
        double d = 0.0;
        for (ipxint p = begin; p < end; p++)
            d += rhs[Ai[p]] * Ax[p];
        d *= W[j];
        if (d != 0.0)
            for (ipxint p = begin; p < end; p++)
                lhs[Ai[p]] += d * Ax[p];
    }
    double dot = 0.0;
    for (ipxint i = 0; i < m; i++)
        dot += rhs[i] * lhs[i];
    return dot;
}

// ---------------------------------------------------------------------
// Products with AI = [A I] (slack identity implicit), the counterparts of
// Model::AI_mul / AIt_mul (reference: src/model.h:60-74 column access;
// SpMV strategy as in src/sparse_matrix.cc:194-311). Parallelized like the
// fused normal apply.

// out[m] = A x[0:n] + x[n:n+m]
void ipxlu_ai_mul(ipxint m, ipxint n, const ipxint* Ap, const int32_t* Ai,
                  const double* Ax, const double* x, double* out) {
#ifdef _OPENMP
    if ((Ap[n] >= (ipxint)1 << 17) && omp_get_max_threads() > 1) {
        static std::vector<std::vector<double>> accs;
        int NT = omp_get_max_threads();
        if ((int)accs.size() < NT) accs.resize(NT);
#pragma omp parallel num_threads(NT)
        {
            int nt = omp_get_num_threads();
            int tid = omp_get_thread_num();
            auto& mine = accs[tid];
            if ((ipxint)mine.size() < m) mine.resize(m);
            std::fill(mine.begin(), mine.begin() + m, 0.0);
            double* a = mine.data();
            const ipxint nnz = Ap[n];
            ipxint lo = (ipxint)(std::lower_bound(
                Ap, Ap + n + 1, nnz * tid / nt) - Ap);
            ipxint hi = (ipxint)(std::lower_bound(
                Ap, Ap + n + 1, nnz * (tid + 1) / nt) - Ap);
            if (tid == 0) lo = 0;
            if (tid == nt - 1) hi = n;
            for (ipxint j = lo; j < hi; j++) {
                double v = x[j];
                if (v != 0.0)
                    for (ipxint p = Ap[j]; p < Ap[j + 1]; p++)
                        a[Ai[p]] += v * Ax[p];
            }
#pragma omp barrier
            ipxint rlo = m * (ipxint)tid / nt;
            ipxint rhi = m * ((ipxint)tid + 1) / nt;
            for (ipxint i = rlo; i < rhi; i++) {
                double v = x[n + i];
                for (int t = 0; t < nt; t++)
                    v += accs[t][i];
                out[i] = v;
            }
        }
        return;
    }
#endif
    for (ipxint i = 0; i < m; i++)
        out[i] = x[n + i];
    for (ipxint j = 0; j < n; j++) {
        double v = x[j];
        if (v != 0.0)
            for (ipxint p = Ap[j]; p < Ap[j + 1]; p++)
                out[Ai[p]] += v * Ax[p];
    }
}

// Per-slice maxvolume column weights, fused: given the slice BTRAN solution
// w, colweights[j] = (A[:,j]' w) * cs[j] for structural j with cs != 0,
// w[i] * cs[n+i] for slacks, 0 where cs == 0 (one pass instead of
// AIt_mul + masked multiply; reference: src/maxvolume.cc:155-199).
void ipxlu_maxvol_weights(ipxint m, ipxint n, const ipxint* Ap,
                          const int32_t* Ai, const double* Ax,
                          const double* w, const double* cs,
                          double* colweights) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (Ap[n] >= (ipxint)1 << 17)
#endif
    for (ipxint j = 0; j < n; j++) {
        double s = cs[j];
        if (s == 0.0) {
            colweights[j] = 0.0;
            continue;
        }
        double d = 0.0;
        for (ipxint p = Ap[j]; p < Ap[j + 1]; p++)
            d += w[Ai[p]] * Ax[p];
        colweights[j] = d * s;
    }
    for (ipxint i = 0; i < m; i++) {
        double s = cs[n + i];
        colweights[n + i] = (s == 0.0) ? 0.0 : w[i] * s;
    }
}

// out[m] = A x[0:n] + x[n:n+m], row-major (CSR of A): pure gather, no
// scatter accumulators — the preferred form when AT is available.
void ipxlu_ai_mul_csr(ipxint m, ipxint n, const ipxint* ATp,
                      const int32_t* ATi, const double* ATx,
                      const double* x, double* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (ATp[m] >= (ipxint)1 << 17)
#endif
    for (ipxint i = 0; i < m; i++) {
        double v = x[n + i];
        for (ipxint p = ATp[i]; p < ATp[i + 1]; p++)
            v += ATx[p] * x[ATi[p]];
        out[i] = v;
    }
}

// Fused phase-1 KKT rhs: rhs = AI (W . a) - b in one gather pass over the
// rows of A (counterpart of the rhs assembly in reference:
// src/kkt_solver_diag.cc:82-99, fused).
void ipxlu_diag_rhs(ipxint m, ipxint n, const ipxint* ATp,
                    const int32_t* ATi, const double* ATx, const double* W,
                    const double* a, const double* b, double* rhs) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (ATp[m] >= (ipxint)1 << 17)
#endif
    for (ipxint i = 0; i < m; i++) {
        double v = W[n + i] * a[n + i] - b[i];
        for (ipxint p = ATp[i]; p < ATp[i + 1]; p++) {
            ipxint j = ATi[p];
            v += ATx[p] * (W[j] * a[j]);
        }
        rhs[i] = v;
    }
}

// Fused phase-1 KKT solution recovery: x[0:n] = W . (a - A'y) (gather over
// CSC columns), then x[n:] = b - A x[0:n] (gather over CSR rows), leaving
// the residual in the slack rows (reference: src/kkt_solver_diag.cc:
// 100-118, fused).
void ipxlu_diag_recover(ipxint m, ipxint n, const ipxint* Ap,
                        const int32_t* Ai, const double* Ax,
                        const ipxint* ATp, const int32_t* ATi,
                        const double* ATx, const double* W, const double* a,
                        const double* y, const double* b, double* x) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (Ap[n] >= (ipxint)1 << 17)
#endif
    for (ipxint j = 0; j < n; j++) {
        double d = 0.0;
        for (ipxint p = Ap[j]; p < Ap[j + 1]; p++)
            d += y[Ai[p]] * Ax[p];
        x[j] = W[j] * (a[j] - d);
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (ATp[m] >= (ipxint)1 << 17)
#endif
    for (ipxint i = 0; i < m; i++) {
        double v = b[i];
        for (ipxint p = ATp[i]; p < ATp[i + 1]; p++)
            v -= ATx[p] * x[ATi[p]];
        x[n + i] = v;
    }
}

// out[n+m] = [A' y; y]
void ipxlu_ait_mul(ipxint m, ipxint n, const ipxint* Ap, const int32_t* Ai,
                   const double* Ax, const double* y, double* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (Ap[n] >= (ipxint)1 << 17)
#endif
    for (ipxint j = 0; j < n; j++) {
        double d = 0.0;
        for (ipxint p = Ap[j]; p < Ap[j + 1]; p++)
            d += y[Ai[p]] * Ax[p];
        out[j] = d;
    }
    std::memcpy(out + n, y, m * sizeof(double));
}

// ---------------------------------------------------------------------
// Native preconditioned Conjugate Residuals on the normal equations with
// diagonal preconditioning: the phase-1 hot loop fully in native code
// (counterpart of reference: src/conjugate_residuals.cc:90-213 +
// src/kkt_solver_diag.cc, fused with the one-pass matvec above).
// Returns 0 ok, 201 iter limit, 202 matrix not posdef, 203 precond not
// posdef, 204 no progress, 205 inf/nan, 999 deadline exceeded.
ipxint ipxlu_cr_diag(ipxint m, ipxint n, const ipxint* Ap, const int32_t* Ai,
                     const double* Ax, const double* W, const double* diag,
                     const double* resscale, const double* rhs, double tol,
                     ipxint maxiter, double deadline_s, double* lhs,
                     ipxint* out_iters) {
    auto apply = [&](const double* in, double* out) {
        return ipxlu_normal_apply(m, n, Ap, Ai, Ax, W, in, out);
    };
    return cr_diag_core(m, apply, diag, resscale, rhs, tol, maxiter,
                        deadline_s, lhs, out_iters);
}

// Same, but lhs carries an initial guess on entry (warm != 0).
// out_mvtime (nullable) accumulates the measured matvec seconds so the
// Info time_cr1_AAt split is measured, not estimated (reference:
// src/normal_matrix.cc:37-43).
ipxint ipxlu_cr_diag_warm(ipxint m, ipxint n, const ipxint* Ap,
                          const int32_t* Ai, const double* Ax,
                          const double* W, const double* diag,
                          const double* resscale, const double* rhs,
                          double tol, ipxint maxiter, double deadline_s,
                          double* lhs, ipxint* out_iters, ipxint warm,
                          double* out_mvtime) {
    auto apply = [&](const double* in, double* out) {
        return ipxlu_normal_apply(m, n, Ap, Ai, Ax, W, in, out);
    };
    return cr_diag_core(m, apply, diag, resscale, rhs, tol, maxiter,
                        deadline_s, lhs, out_iters, warm != 0, out_mvtime);
}

// ---------------------------------------------------------------------
// Explicit normal matrix handle (see NrmExplicit above). ipxlu_nrm_new
// performs the symbolic build once per model; returns NULL when nnz(S)
// would exceed cap (caller falls back to the one-pass matvec). The Ap/Ai/Ax
// buffers are borrowed for the lifetime of the handle.
void* ipxlu_nrm_new(ipxint m, ipxint n, const ipxint* Ap, const int32_t* Ai,
                    const double* Ax, ipxint cap) {
    try {
        return nrm_symbolic(m, n, Ap, Ai, Ax, cap);
    } catch (...) {
        return nullptr;
    }
}

ipxint ipxlu_nrm_nnz(void* h) {
    NrmExplicit& nh = *static_cast<NrmExplicit*>(h);
    return nh.Sp[nh.m];
}

// Numeric refresh for the weights of the current KKT factorize.
void ipxlu_nrm_values(void* h, const double* W) {
    nrm_values(*static_cast<NrmExplicit*>(h), W);
}

void ipxlu_nrm_free(void* h) {
    delete static_cast<NrmExplicit*>(h);
}

// CR on the normal equations with the explicit S as the operator; same
// contract as ipxlu_cr_diag. Requires a prior ipxlu_nrm_values call with
// the weights of the current factorize.
ipxint ipxlu_cr_diag_explicit(void* h, const double* diag,
                              const double* resscale, const double* rhs,
                              double tol, ipxint maxiter, double deadline_s,
                              double* lhs, ipxint* out_iters) {
    NrmExplicit& nh = *static_cast<NrmExplicit*>(h);
    auto apply = [&](const double* in, double* out) {
        return nrm_spmv_dot(nh, in, out);
    };
    return cr_diag_core(nh.m, apply, diag, resscale, rhs, tol, maxiter,
                        deadline_s, lhs, out_iters);
}

// Same, but lhs carries an initial guess on entry (warm != 0) and
// out_mvtime (nullable) accumulates measured matvec seconds.
ipxint ipxlu_cr_diag_explicit_warm(void* h, const double* diag,
                                   const double* resscale, const double* rhs,
                                   double tol, ipxint maxiter,
                                   double deadline_s, double* lhs,
                                   ipxint* out_iters, ipxint warm,
                                   double* out_mvtime) {
    NrmExplicit& nh = *static_cast<NrmExplicit*>(h);
    auto apply = [&](const double* in, double* out) {
        return nrm_spmv_dot(nh, in, out);
    };
    return cr_diag_core(nh.m, apply, diag, resscale, rhs, tol, maxiter,
                        deadline_s, lhs, out_iters, warm != 0, out_mvtime);
}

// Mixed-precision explicit-S CR: inner CR passes run entirely in float32
// (half the value bandwidth on the SpMV and all recurrence vectors), with
// float64 defect correction between passes — the true residual is
// recomputed with one f64 SpMV and the f32 solve restarts on it. When an
// f32 pass stops making progress above the tolerance (the normal matrix
// gets too ill-conditioned for f32 late in phase 1), the solve FINISHES in
// the f64 core, warm-started from the accumulated solution, so robustness
// equals the f64 path. Same contract as ipxlu_cr_diag_explicit_warm.
ipxint ipxlu_cr_diag_explicit_mixed(void* h, const double* diag,
                                    const double* resscale,
                                    const double* rhs, double tol,
                                    ipxint maxiter, double deadline_s,
                                    double* lhs, ipxint* out_iters,
                                    ipxint warm, double* out_mvtime) {
    NrmExplicit& nh = *static_cast<NrmExplicit*>(h);
    const ipxint m = nh.m;
    if (maxiter < 0) maxiter = m + 100;
    nrm_values32(nh);

    auto apply64 = [&](const double* in, double* out) {
        if (!out_mvtime) return nrm_spmv_dot(nh, in, out);
        const double t0 = now_monotonic_s();
        const double d = nrm_spmv_dot(nh, in, out);
        *out_mvtime += now_monotonic_s() - t0;
        return d;
    };
    auto apply32 = [&](const float* in, float* out) {
        return nrm_spmv_dot32(nh, in, out);
    };

    std::vector<double> r(m), Cy(m);
#ifdef _OPENMP
    const bool par = m >= (ipxint)1 << 15 && omp_get_max_threads() > 1;
#endif
    if (warm) {
        apply64(lhs, Cy.data());
        for (ipxint i = 0; i < m; i++) r[i] = rhs[i] - Cy[i];
    } else {
        std::fill(lhs, lhs + m, 0.0);
        std::copy(rhs, rhs + m, r.begin());
    }
    auto snorm_of = [&]() {
        double sn = 0.0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) reduction(max : sn) if (par)
#endif
        for (ipxint i = 0; i < m; i++)
            sn = std::max(sn, std::fabs(resscale[i] * r[i]));
        return sn;
    };

    std::vector<float> diag32(m), resscale32(m), r32(m), dy32(m);
    for (ipxint i = 0; i < m; i++) {
        diag32[i] = (float)diag[i];
        resscale32[i] = (float)resscale[i];
    }

    ipxint iters = 0;
    ipxint err = 0;
    double snorm = snorm_of();
    const int kMaxRefine = 30;
    // one f32 pass cannot reduce the scaled residual much below ~1e-5
    // relative; ask for that and let the refinement loop do the rest
    const double kF32Floor = 1e-5;
    for (int ref = 0; ref < kMaxRefine; ref++) {
        if (snorm <= tol) { *out_iters = iters; return 0; }
        if (iters >= maxiter) { *out_iters = iters; return 201; }
        double inner_tol = std::max(tol, kF32Floor * snorm);
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (par)
#endif
        for (ipxint i = 0; i < m; i++) r32[i] = (float)r[i];
        ipxint it32 = 0;
        ipxint e32 = cr_diag_core(m, apply32, diag32.data(),
                                  resscale32.data(), r32.data(), inner_tol,
                                  maxiter - iters, deadline_s, dy32.data(),
                                  &it32, false, out_mvtime);
        iters += it32;
        if (e32 == 999) { *out_iters = iters; return 999; }
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (par)
#endif
        for (ipxint i = 0; i < m; i++) lhs[i] += (double)dy32[i];
        apply64(lhs, Cy.data());
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (par)
#endif
        for (ipxint i = 0; i < m; i++) r[i] = rhs[i] - Cy[i];
        double new_snorm = snorm_of();
        if (!std::isfinite(new_snorm)) { err = 205; break; }
        if (new_snorm > tol && new_snorm >= 0.5 * snorm) {
            err = e32;      // f32 stalled; finish in f64 below
            break;
        }
        snorm = new_snorm;
    }
    if (snorm_of() <= tol) { *out_iters = iters; return 0; }
    // f64 finish, warm-started from the accumulated solution
    ipxint it64 = 0;
    ipxint e64 = cr_diag_core(m, apply64, diag, resscale, rhs, tol,
                              maxiter - iters, deadline_s, lhs, &it64,
                              true);
    *out_iters = iters + it64;
    (void)err;
    return e64;
}

// ---------------------------------------------------------------------
// Numeric IC(0) refresh for the current weights (after ipxlu_nrm_values).
// Returns 0 on success (possibly with a diagonal shift), 1 when IC is
// unavailable for this pattern or breaks down at every shift.
ipxint ipxlu_nrm_ic_factorize(void* h) {
    NrmExplicit& nh = *static_cast<NrmExplicit*>(h);
    nh.ic_ok = false;
    ic_symbolic(nh);
    if (nh.Icp.empty()) return 1;
    for (double shift : {0.0, 1e-3, 1e-2, 1e-1, 1.0}) {
        if (ic_numeric(nh, shift)) {
            nh.ic_ok = true;
            return 0;
        }
    }
    return 1;
}

// CR with the IC(0) preconditioner; same contract as
// ipxlu_cr_diag_explicit_warm (requires a successful
// ipxlu_nrm_ic_factorize for the current weights).
ipxint ipxlu_cr_diag_explicit_ic(void* h, const double* resscale,
                                 const double* rhs, double tol,
                                 ipxint maxiter, double deadline_s,
                                 double* lhs, ipxint* out_iters,
                                 ipxint warm, double* out_mvtime) {
    NrmExplicit& nh = *static_cast<NrmExplicit*>(h);
    if (!nh.ic_ok) return -2;
    auto apply = [&](const double* in, double* out) {
        return nrm_spmv_dot(nh, in, out);
    };
    auto psolve = [&](const double* in, double* out) {
        return ic_solve(nh, in, out);
    };
    return cr_psolve_core(nh.m, apply, psolve, resscale, rhs, tol, maxiter,
                          deadline_s, lhs, out_iters, warm != 0,
                          out_mvtime);
}

// ---------------------------------------------------------------------
// Crash stage 1: incomplete left-looking LU over free columns (counterpart
// of the free-column stage of the reference crash,
// reference: src/guess_basis.cc:11-108). For each free column in order,
// computes L \ A[:,j] with topological-DFS pattern; if the largest
// not-yet-pivotal entry exceeds the dependency tolerance the column joins
// the basis and contributes an L column (off-diagonals restricted to the
// column's original pattern). rownumber[i] = basis position if row i
// pivotal. chosen[t] = 1 if order[t] entered. Returns count chosen.
ipxint ipxlu_guess_free(ipxint m, const ipxint* Ap, const ipxint* Ai,
                        const double* Ax, ipxint norder,
                        const ipxint* order, ipxint* rownumber,
                        ipxint basis_size0, int8_t* chosen) {
    const double kDepTol = 1e-3;
    std::vector<ipxint> Lp(1, 0), Li;
    std::vector<double> Lx;
    std::vector<double> lhs(m, 0.0);
    std::vector<ipxint> marked(m, -1), pattern(m), nodestack(m), estack(m);
    std::vector<ipxint> lcol(m, -1);   // row -> L column of THIS stage
    ipxint nchosen = 0;
    ipxint basis_size = basis_size0;

    for (ipxint t = 0; t < norder; t++) {
        ipxint j = order[t];
        chosen[t] = 0;
        // --- pattern DFS: reach of pattern(A[:,j]) through L's columns
        // (node i has neighbours = column rownumber[i] of L when pivotal)
        ipxint top = m;
        for (ipxint p = Ap[j]; p < Ap[j + 1]; p++) {
            ipxint istart = Ai[p];
            if (marked[istart] == t) continue;
            // iterative DFS
            ipxint head = 0;
            nodestack[0] = istart;
            while (head >= 0) {
                ipxint i = nodestack[head];
                ipxint k = lcol[i];
                if (marked[i] != t) {
                    marked[i] = t;
                    estack[head] = (k >= 0) ? Lp[k] : 0;
                }
                ipxint pend = (k >= 0) ? Lp[k + 1] : 0;
                bool descended = false;
                ipxint e = estack[head];
                while (e < pend) {
                    ipxint inew = Li[e];
                    e++;
                    if (marked[inew] != t) {
                        estack[head] = e;
                        head++;
                        nodestack[head] = inew;
                        descended = true;
                        break;
                    }
                }
                if (!descended) {
                    estack[head] = e;
                    head--;
                    top--;
                    pattern[top] = i;
                }
            }
        }
        // --- numeric phase in topological order
        for (ipxint q = top; q < m; q++)
            lhs[pattern[q]] = 0.0;
        for (ipxint p = Ap[j]; p < Ap[j + 1]; p++)
            lhs[Ai[p]] = Ax[p];
        double lhsmax = 0.0;
        ipxint imax = -1;
        for (ipxint q = top; q < m; q++) {
            ipxint i = pattern[q];
            double temp = lhs[i];
            ipxint k = lcol[i];
            if (temp != 0.0) {
                if (k >= 0) {
                    for (ipxint p = Lp[k]; p < Lp[k + 1]; p++)
                        lhs[Li[p]] -= Lx[p] * temp;
                } else if (std::fabs(temp) > lhsmax) {
                    lhsmax = std::fabs(temp);
                    imax = i;
                }
            }
        }
        double pivot = imax >= 0 ? lhs[imax] : 0.0;
        if (std::fabs(pivot) > kDepTol) {
            rownumber[imax] = basis_size;
            lcol[imax] = nchosen;
            basis_size++;
            // new L column restricted to pattern of A[:,j]
            for (ipxint p = Ap[j]; p < Ap[j + 1]; p++) {
                ipxint i = Ai[p];
                if (rownumber[i] < 0 && lhs[i] != 0.0) {
                    Li.push_back(i);
                    Lx.push_back(lhs[i] / pivot);
                }
            }
            Lp.push_back((ipxint)Li.size());
            chosen[t] = 1;
            nchosen++;
        }
    }
    return nchosen;
}

// ---------------------------------------------------------------------
// Standalone maximum-matching kernel (crash basis construction).
// Alternating augmenting-path matching processed in a caller-given column
// order (counterpart of the matching stage of the reference crash,
// reference: src/sparse_utils.h:32-57 adapting CSparse cs_augment).
//
// jmatch[i]: -1 unmatched eligible row, < -1 excluded, >= 0 matched column.
// order: columns to try, in priority order. matched_out[k] = 1 if order[k]
// was matched. Stops early when failures >= failcap (caller recomputes the
// 10x-deficit rule). Returns number matched.
ipxint ipxlu_matching(ipxint nrows, ipxint ncols, const ipxint* Ap,
                      const ipxint* Ai, ipxint norder, const ipxint* order,
                      ipxint* jmatch, ipxint failcap_mult,
                      ipxint target_size, ipxint already,
                      int8_t* matched_out) {
    std::vector<ipxint> cheap(Ap, Ap + ncols);
    std::vector<ipxint> marked(ncols, -1);
    std::vector<ipxint> js(nrows + 1), is(nrows + 1), ps(nrows + 1);
    ipxint num_matched = 0, num_failed = 0;
    ipxint basis_size = already;

    for (ipxint t = 0; t < norder; t++) {
        ipxint jstart = order[t];
        matched_out[t] = 0;
        bool found = false;
        ipxint head = 0;
        js[0] = jstart;
        while (head >= 0) {
            ipxint j = js[head];
            if (marked[j] != jstart) {
                marked[j] = jstart;
                ipxint p = cheap[j];
                ipxint foundrow = -1;
                for (; p < Ap[j + 1]; p++) {
                    ipxint i = Ai[p];
                    if (jmatch[i] == -1) { foundrow = i; p++; break; }
                }
                cheap[j] = p;
                if (foundrow >= 0) {
                    is[head] = foundrow;
                    found = true;
                    break;
                }
                ps[head] = Ap[j];
            }
            ipxint p = ps[head];
            bool advanced = false;
            for (; p < Ap[j + 1]; p++) {
                ipxint i = Ai[p];
                ipxint jm = jmatch[i];
                if (jm < 0) continue;
                if (marked[jm] == jstart) continue;
                ps[head] = p + 1;
                is[head] = i;
                head++;
                js[head] = jm;
                advanced = true;
                break;
            }
            if (!advanced) {
                if (p >= Ap[j + 1]) ps[head] = p;
                head--;
            }
        }
        if (found) {
            for (ipxint h = head; h >= 0; h--)
                jmatch[is[h]] = js[h];
            matched_out[t] = 1;
            num_matched++;
            basis_size++;
        } else {
            num_failed++;
        }
        if (num_failed >= failcap_mult * (target_size - basis_size))
            break;
    }
    return num_matched;
}

// ---------------------------------------------------------------------
// Model binding + native crossover push loops
// ---------------------------------------------------------------------

// Binds the model's structural matrix A (CSC + CSR) to the handle. The
// arrays are NOT copied (except the basis-column concatenation [A | I] used
// for refactorization); the caller keeps them alive while bound.
void ipxlu_model_bind(void* h, ipxint n, const ipxint* Ap, const ipxint* Ai,
                      const double* Ax, const ipxint* ARp, const ipxint* ARi,
                      const double* ARx) {
    IpxLu& lu = *static_cast<IpxLu*>(h);
    const ipxint m = lu.m;
    lu.mb_n = n;
    lu.mb_Ap = Ap; lu.mb_Ai = Ai; lu.mb_Ax = Ax;
    lu.mb_ARp = ARp; lu.mb_ARi = ARi; lu.mb_ARx = ARx;
    const ipxint nnzA = Ap[n];
    lu.mb_Bi.resize(nnzA + m);
    lu.mb_Bx.resize(nnzA + m);
    std::copy(Ai, Ai + nnzA, lu.mb_Bi.begin());
    std::copy(Ax, Ax + nnzA, lu.mb_Bx.begin());
    for (ipxint i = 0; i < m; i++) {
        lu.mb_Bi[nnzA + i] = i;
        lu.mb_Bx[nnzA + i] = 1.0;
    }
    lu.xw_row.assign(n + m, 0.0);
    lu.xw_rowpat.assign(n + m, 0);
    lu.xw_rowstamp.assign(n + m, -1);
    lu.xw_rowstampval = 0;
    lu.xw_bt.assign(m, 0.0);
    lu.xw_ft.assign(m, 0.0);
    lu.xw_ft_dense = false;
    lu.xw_ft_nz = 0;
    lu.xw_btpat.assign(m, 0);
    lu.xw_ftpat.assign(m, 0);
}

// Dual push loop (counterpart of reference: src/crossover.cc:229-340).
// Processes variables[*next_i..nvars) until done or pause_abs_s passes.
// basis/map2basis/y/z mutated in place; *fresh tracks whether the current
// factorization is fresh. Returns 0 done, 3 paused (call again), 301/306
// fatal errflag. Counters are ACCUMULATED into icounts[8] = {pushes, pivots,
// nftran, nftran_sparse, nbtran, nbtran_sparse, nupdates, nfactor} and
// dcounts[4] = {t_ftran, t_btran, t_update, t_factorize}; fill factors of
// refactorizations go to fills[0..*nfills).
ipxint ipxlu_xover_dual(void* h, ipxint* basis, ipxint* map2basis,
                        double* y, double* z, const ipxint* sign_restrict,
                        const ipxint* variables, ipxint nvars,
                        ipxint* next_i, double feastol, double pause_abs_s,
                        ipxint* fresh, ipxint* icounts, double* dcounts,
                        double* fills, ipxint fills_cap, ipxint* nfills) {
    IpxLu& lu = *static_cast<IpxLu*>(h);
    const ipxint m = lu.m, n = lu.mb_n;
    XoverCounts c;
    c.fills = fills;
    c.fills_cap = fills_cap;
    double* bt = lu.xw_bt.data();
    ipxint* btpat = lu.xw_btpat.data();
    double* row = lu.xw_row.data();
    ipxint* rowpat = lu.xw_rowpat.data();
    ipxint ret = 0;

    while (*next_i < nvars) {
        if (now_monotonic_s() > pause_abs_s) { ret = 3; break; }
        ipxint jb = variables[*next_i];
        if (z[jb] == 0.0) { (*next_i)++; continue; }

        ipxint mp = map2basis[jb];
        ipxint pos = mp >= m ? mp - m : mp;
        ipxint bnz;
        ipxint rnz = tableau_row_native(lu, map2basis, pos, 0, bt, btpat,
                                        &bnz, row, rowpat, c,
                                        /*keep_bt=*/true);

        // two-pass ratio test (reference: src/crossover.cc:418-465)
        double step = z[jb];
        ipxint jblock = -1;
        const ipxint total = n + m;
        auto pass1 = [&](ipxint j, double piv) {
            if (std::fabs(piv) <= kXoverPivotZeroTol) return;
            ipxint sr = sign_restrict[j];
            double znew = z[j] - step * piv;
            if ((sr & 1) && znew < -feastol) {
                step = (z[j] + feastol) / piv;
                jblock = j;
            } else if ((sr & 2) && znew > feastol) {
                step = (z[j] - feastol) / piv;
                jblock = j;
            }
        };
        if (rnz >= 0)
            for (ipxint t = 0; t < rnz; t++) pass1(rowpat[t], row[rowpat[t]]);
        else
            for (ipxint j = 0; j < total; j++)
                if (row[j] != 0.0) pass1(j, row[j]);

        ipxint jn = -1;
        if (jblock >= 0) {
            double bestpiv = 0.0;
            auto pass2 = [&](ipxint j, double piv) {
                double apiv = std::fabs(piv);
                if (apiv <= kXoverPivotZeroTol) return;
                ipxint sr = sign_restrict[j];
                double sp = step * piv;
                if (!(((sr & 1) && sp > 0.0) || ((sr & 2) && sp < 0.0)))
                    return;
                if (std::fabs(z[j] / piv) > std::fabs(step)) return;
                if (apiv > bestpiv) { bestpiv = apiv; jn = j; }
            };
            if (rnz >= 0)
                for (ipxint t = 0; t < rnz; t++)
                    pass2(rowpat[t], row[rowpat[t]]);
            else
                for (ipxint j = 0; j < total; j++)
                    if (row[j] != 0.0) pass2(j, row[j]);
            if (jn < 0) jn = jblock;
        }

        if (jn >= 0) {
            double pivot = row[jn];
            ipxint xret = xover_exchange(lu, basis, map2basis, jb, jn,
                                         pivot, +1, fresh, c);
            if (xret == 1) { clear_bt(lu, bt, btpat, bnz); continue; }
            if (xret > 1) {
                clear_bt(lu, bt, btpat, bnz);
                ret = xret;
                break;
            }
            c.pivots++;
            step = z[jn] / pivot;
        }
        if (step != 0.0) {
            if (bnz >= 0)
                for (ipxint t = 0; t < bnz; t++)
                    y[btpat[t]] += step * bt[btpat[t]];
            else
                for (ipxint i = 0; i < m; i++) y[i] += step * bt[i];
            auto zupd = [&](ipxint j, double piv) {
                double v = z[j] - step * piv;
                ipxint sr = sign_restrict[j];
                if ((sr & 1) && v < 0.0) v = 0.0;
                if ((sr & 2) && v > 0.0) v = 0.0;
                z[j] = v;
            };
            if (rnz >= 0)
                for (ipxint t = 0; t < rnz; t++)
                    zupd(rowpat[t], row[rowpat[t]]);
            else
                for (ipxint j = 0; j < total; j++)
                    if (row[j] != 0.0) zupd(j, row[j]);
            z[jb] -= step;
        }
        if (jn >= 0)
            z[jn] = 0.0;
        clear_bt(lu, bt, btpat, bnz);
        c.pushes++;
        (*next_i)++;
    }
    c.flush(icounts, dcounts, nfills);
    return ret;
}

// Primal push loop (counterpart of reference: src/crossover.cc:73-221).
// xbasic/lbbasic/ubbasic are the caller-prepared by-position arrays (the
// caller writes x[basis] = xbasic back after the loop completes).
ipxint ipxlu_xover_primal(void* h, ipxint* basis, ipxint* map2basis,
                          double* x, double* xbasic, double* lbbasic,
                          double* ubbasic, const double* lb,
                          const double* ub, const ipxint* variables,
                          ipxint nvars, ipxint* next_i, double feastol,
                          double pause_abs_s, ipxint* fresh,
                          ipxint* icounts, double* dcounts, double* fills,
                          ipxint fills_cap, ipxint* nfills) {
    IpxLu& lu = *static_cast<IpxLu*>(h);
    const ipxint m = lu.m;
    XoverCounts c;
    c.fills = fills;
    c.fills_cap = fills_cap;
    double* ft = lu.xw_ft.data();
    ipxint* ftpat = lu.xw_ftpat.data();
    ipxint ret = 0;

    while (*next_i < nvars) {
        if (now_monotonic_s() > pause_abs_s) { ret = 3; break; }
        ipxint jn = variables[*next_i];
        if (x[jn] == lb[jn] || x[jn] == ub[jn]
            || (x[jn] == 0.0 && std::isinf(lb[jn]) && std::isinf(ub[jn]))) {
            (*next_i)++;
            continue;
        }
        double move_to = 0.0;
        if (std::isfinite(lb[jn]) && std::isfinite(ub[jn]))
            move_to = (x[jn] - lb[jn] <= ub[jn] - x[jn]) ? lb[jn] : ub[jn];
        else if (std::isfinite(lb[jn]))
            move_to = lb[jn];
        else if (std::isfinite(ub[jn]))
            move_to = ub[jn];
        double step = x[jn] - move_to;

        ipxint fnz = ftran_from_block(lu, jn, c, true);
        if (fnz == -2) {
            // block the next candidates from the push list (skipping those
            // already at a bound under the current x)
            if (ftran_block_worthwhile(lu, 4)) {
                ipxint blk[16];
                int W = 0;
                for (ipxint q = *next_i; q < nvars && W < 16; q++) {
                    ipxint j2 = variables[q];
                    if (x[j2] == lb[j2] || x[j2] == ub[j2]
                        || (x[j2] == 0.0 && std::isinf(lb[j2])
                            && std::isinf(ub[j2])))
                        continue;
                    blk[W++] = j2;
                }
                if (W >= 4) {
                    ftran_block_build(lu, blk, W, c);
                    fnz = ftran_from_block(lu, jn, c, true);
                }
            }
            if (fnz == -2)
                fnz = ftran_col_for_update(lu, jn, c, true);
        }

        // two-pass ratio test (reference: src/crossover.cc:359-416)
        ipxint pblock = -1;
        bool at_lb = true;
        auto pass1 = [&](ipxint k, double piv) {
            if (std::fabs(piv) <= kXoverPivotZeroTol) return;
            double xnew = xbasic[k] + step * piv;
            if (xnew < lbbasic[k] - feastol) {
                step = (lbbasic[k] - xbasic[k] - feastol) / piv;
                pblock = k;
                at_lb = true;
            } else if (xnew > ubbasic[k] + feastol) {
                step = (ubbasic[k] - xbasic[k] + feastol) / piv;
                pblock = k;
                at_lb = false;
            }
        };
        if (fnz >= 0)
            for (ipxint t = 0; t < fnz; t++) pass1(ftpat[t], ft[ftpat[t]]);
        else
            for (ipxint k = 0; k < m; k++)
                if (ft[k] != 0.0) pass1(k, ft[k]);

        if (pblock >= 0) {
            double bestpiv = 0.0;
            ipxint best = -1;
            bool bestlb = true;
            auto pass2 = [&](ipxint k, double piv) {
                double apiv = std::fabs(piv);
                if (apiv <= kXoverPivotZeroTol) return;
                double sp = step * piv;
                bool cand_lb, ok;
                if (sp < 0.0) {
                    ok = std::fabs((lbbasic[k] - xbasic[k]) / piv)
                        <= std::fabs(step);
                    cand_lb = true;
                } else if (sp > 0.0) {
                    ok = std::fabs((ubbasic[k] - xbasic[k]) / piv)
                        <= std::fabs(step);
                    cand_lb = false;
                } else {
                    return;
                }
                if (ok && apiv > bestpiv) {
                    bestpiv = apiv;
                    best = k;
                    bestlb = cand_lb;
                }
            };
            if (fnz >= 0)
                for (ipxint t = 0; t < fnz; t++)
                    pass2(ftpat[t], ft[ftpat[t]]);
            else
                for (ipxint k = 0; k < m; k++)
                    if (ft[k] != 0.0) pass2(k, ft[k]);
            if (best >= 0) { pblock = best; at_lb = bestlb; }
        }

        ipxint jb = -1;
        if (pblock >= 0) {
            jb = basis[pblock];
            double pivot = ft[pblock];
            ipxint xret = xover_exchange(lu, basis, map2basis, jb, jn,
                                         pivot, -1, fresh, c);
            if (xret == 1) continue;
            if (xret > 1) { ret = xret; break; }
            c.pivots++;
            step = at_lb ? (lbbasic[pblock] - xbasic[pblock]) / pivot
                         : (ubbasic[pblock] - xbasic[pblock]) / pivot;
        }
        if (step != 0.0) {
            auto xupd = [&](ipxint k, double piv) {
                double xb = xbasic[k] + step * piv;
                if (xb < lbbasic[k]) xb = lbbasic[k];
                if (xb > ubbasic[k]) xb = ubbasic[k];
                xbasic[k] = xb;
            };
            if (fnz >= 0)
                for (ipxint t = 0; t < fnz; t++)
                    xupd(ftpat[t], ft[ftpat[t]]);
            else
                for (ipxint k = 0; k < m; k++)
                    if (ft[k] != 0.0) xupd(k, ft[k]);
            x[jn] -= step;
        }
        if (pblock >= 0) {
            x[jb] = at_lb ? lbbasic[pblock] : ubbasic[pblock];
            xbasic[pblock] = x[jn];
            lbbasic[pblock] = lb[jn];
            ubbasic[pblock] = ub[jn];
        } else {
            x[jn] = move_to;
        }
        c.pushes++;
        (*next_i)++;
    }
    c.flush(icounts, dcounts, nfills);
    return ret;
}

// ---------------------------------------------------------------------
// Native drop loops of the basis-preconditioned KKT factorization
// (counterpart of reference: src/kkt_solver_basis.cc:196-387): DropPrimal
// pivots near-bound basic variables out (or marks them implied), DropDual
// pivots near-zero-dual nonbasic variables in (or fixes them). The iterate
// state-machine changes are applied by the Python caller from the returned
// dropped list; colscale is mutated in place.
// ---------------------------------------------------------------------

// Processes candidates LIFO. dropped_out[k] = 2*jb + lb_side. Returns 0
// done, 3 paused, 301/306 fatal. icounts[0] += exchanges, icounts[1] +=
// drops; icounts[2..7] and dcounts as in the crossover driver.
ipxint ipxlu_drop_primal(void* h, ipxint* basis, ipxint* map2basis,
                         double* colscale, const double* xl, const double* xu,
                         const double* zl, const double* zu,
                         const ipxint* candidates, ipxint ncand,
                         ipxint* next_i, double volume_tol,
                         double pause_abs_s, ipxint* fresh,
                         ipxint* dropped_out, ipxint* ndropped,
                         ipxint* icounts, double* dcounts, double* fills,
                         ipxint fills_cap, ipxint* nfills) {
    IpxLu& lu = *static_cast<IpxLu*>(h);
    const ipxint m = lu.m, n = lu.mb_n;
    const double pivot_zero_tol = 1e-7;   // reference: src/kkt_solver_basis.h
    XoverCounts c;
    c.fills = fills;
    c.fills_cap = fills_cap;
    double* bt = lu.xw_bt.data();
    ipxint* btpat = lu.xw_btpat.data();
    double* row = lu.xw_row.data();
    ipxint* rowpat = lu.xw_rowpat.data();
    // invscale by basis position: 1/colscale (0 where infinite/zero-div)
    std::vector<double> invscale(m);
    for (ipxint p = 0; p < m; p++) {
        double v = 1.0 / colscale[basis[p]];
        invscale[p] = std::isfinite(v) ? v : 0.0;
    }
    ipxint ret = 0;
    while (*next_i < ncand) {
        if (now_monotonic_s() > pause_abs_s) { ret = 3; break; }
        // LIFO like the reference (candidates.back(), pop on completion)
        ipxint jb = candidates[ncand - 1 - *next_i];
        ipxint mp = map2basis[jb];
        ipxint pos = mp >= m ? mp - m : mp;
        double s = invscale[pos];
        ipxint bnz;
        ipxint rnz = tableau_row_native(lu, map2basis, pos, 1, bt, btpat,
                                        &bnz, row, rowpat, c);
        ipxint jmax = -1;
        double vmax = 0.0;
        auto score = [&](ipxint j, double piv) {
            double a = std::fabs(piv);
            if (a <= pivot_zero_tol) return;
            double v = a * colscale[j] * s;
            if (v > vmax) { vmax = v; jmax = j; }
        };
        if (rnz >= 0)
            for (ipxint t = 0; t < rnz; t++) score(rowpat[t], row[rowpat[t]]);
        else
            for (ipxint j = 0; j < n + m; j++)
                if (row[j] != 0.0) score(j, row[j]);
        if (jmax >= 0 && vmax > volume_tol) {
            double pivot = row[jmax];
            ipxint xret = xover_exchange(lu, basis, map2basis, jb, jmax,
                                         pivot, +1, fresh, c);
            if (xret == 1) continue;
            if (xret > 1) { ret = xret; break; }
            double iv = 1.0 / colscale[jmax];
            invscale[pos] = std::isfinite(iv) ? iv : 0.0;
            c.pivots++;
        } else {
            // make implied: side with larger z/x ratio (NaNs compare false)
            bool lb_side = (zl[jb] / xl[jb]) > (zu[jb] / xu[jb]);
            if (mp >= 0 && mp < m) map2basis[jb] = mp + m;  // BASIC_FREE
            invscale[pos] = 0.0;
            colscale[jb] = std::numeric_limits<double>::infinity();
            dropped_out[(*ndropped)++] = 2 * jb + (lb_side ? 1 : 0);
        }
        (*next_i)++;
    }
    c.flush(icounts, dcounts, nfills);
    icounts[0] += 0;            // pushes unused here
    icounts[1] += 0;            // pivots flushed via c.pivots above
    return ret;
}

// DropDual: candidates are nonbasic; dropped_out[k] = jn (fixed).
ipxint ipxlu_drop_dual(void* h, ipxint* basis, ipxint* map2basis,
                       double* colscale, const ipxint* candidates,
                       ipxint ncand, ipxint* next_i, double volume_tol,
                       double pause_abs_s, ipxint* fresh,
                       ipxint* dropped_out, ipxint* ndropped,
                       ipxint* icounts, double* dcounts, double* fills,
                       ipxint fills_cap, ipxint* nfills) {
    IpxLu& lu = *static_cast<IpxLu*>(h);
    const ipxint m = lu.m;
    const double pivot_zero_tol = 1e-7;
    XoverCounts c;
    c.fills = fills;
    c.fills_cap = fills_cap;
    double* ft = lu.xw_ft.data();
    ipxint* ftpat = lu.xw_ftpat.data();
    std::vector<double> invscale(m);
    for (ipxint p = 0; p < m; p++) {
        double v = 1.0 / colscale[basis[p]];
        invscale[p] = std::isfinite(v) ? v : 0.0;
    }
    ipxint ret = 0;
    while (*next_i < ncand) {
        if (now_monotonic_s() > pause_abs_s) { ret = 3; break; }
        ipxint jn = candidates[ncand - 1 - *next_i];
        double s = colscale[jn];
        ipxint fnz = ftran_from_block(lu, jn, c, true);
        if (fnz == -2) {
            ipxint remaining = ncand - *next_i;
            if (ftran_block_worthwhile(lu, (int)std::min<ipxint>(remaining,
                                                                 16))) {
                ipxint blk[16];
                int W = (int)std::min<ipxint>(remaining, 16);
                for (int t = 0; t < W; t++)
                    blk[t] = candidates[ncand - 1 - *next_i - t];
                ftran_block_build(lu, blk, W, c);
                fnz = ftran_from_block(lu, jn, c, true);
            }
            if (fnz == -2)
                fnz = ftran_col_for_update(lu, jn, c, true);
        }
        ipxint pmax = -1;
        double vmax = 0.0;
        auto score = [&](ipxint p, double piv) {
            double a = std::fabs(piv);
            if (a <= pivot_zero_tol) return;
            double v = a * invscale[p] * s;
            if (v > vmax) { vmax = v; pmax = p; }
        };
        if (fnz >= 0)
            for (ipxint t = 0; t < fnz; t++) score(ftpat[t], ft[ftpat[t]]);
        else
            for (ipxint p = 0; p < m; p++)
                if (ft[p] != 0.0) score(p, ft[p]);
        if (pmax >= 0 && vmax > volume_tol) {
            double pivot = ft[pmax];
            ipxint jb = basis[pmax];
            ipxint xret = xover_exchange(lu, basis, map2basis, jb, jn,
                                         pivot, -1, fresh, c);
            if (xret == 1) continue;
            if (xret > 1) { ret = xret; break; }
            double iv = 1.0 / colscale[jn];
            invscale[pmax] = std::isfinite(iv) ? iv : 0.0;
            c.pivots++;
        } else {
            if (map2basis[jn] == -1) map2basis[jn] = -2;   // NONBASIC_FIXED
            colscale[jn] = 0.0;
            dropped_out[(*ndropped)++] = jn;
        }
        (*next_i)++;
    }
    c.flush(icounts, dcounts, nfills);
    return ret;
}

// ---------------------------------------------------------------------
// Native starting-basis pivot loops (counterpart of reference:
// src/basis.cc:676-781 PivotFreeVariablesIntoBasis and :783-914
// PivotFixedVariablesOutOfBasis): LIFO candidate stacks with stability
// swaps, dependency detection and infeasibility-certificate (ray) tests.
// The caller owns the stack array (capacity n+m) so pauses can resume.
// flags_out: [0] += dependent count, [1] |= inconsistent, [2] += updates,
// [3] += stability pivots.
// ---------------------------------------------------------------------

ipxint ipxlu_pivot_free_in(void* h, ipxint* basis, ipxint* map2basis,
                           const double* colweights, const double* c,
                           double dependency_tol, ipxint* stack,
                           ipxint* nstack, double pause_abs_s,
                           ipxint* fresh, ipxint* flags_out,
                           ipxint* icounts, double* dcounts, double* fills,
                           ipxint fills_cap, ipxint* nfills) {
    IpxLu& lu = *static_cast<IpxLu*>(h);
    const ipxint m = lu.m;
    XoverCounts cc;
    cc.fills = fills;
    cc.fills_cap = fills_cap;
    double* ft = lu.xw_ft.data();
    ipxint* ftpat = lu.xw_ftpat.data();
    const double inf = std::numeric_limits<double>::infinity();
    ipxint ret = 0;
    while (*nstack > 0) {
        if (now_monotonic_s() > pause_abs_s) { ret = 3; break; }
        ipxint jn = stack[*nstack - 1];
        ipxint fnz = ftran_col_for_update(lu, jn, cc, true);
        double fmax = 0.0, fmax_nonfree = 0.0;
        ipxint pmax = -1, pmax_nonfree = -1;
        auto score = [&](ipxint p, double piv) {
            double a = std::fabs(piv);
            if (a == 0.0) return;
            if (a > fmax) { fmax = a; pmax = p; }
            if (colweights[basis[p]] != inf && a > fmax_nonfree) {
                fmax_nonfree = a;
                pmax_nonfree = p;
            }
        };
        if (fnz >= 0)
            for (ipxint t = 0; t < fnz; t++) score(ftpat[t], ft[ftpat[t]]);
        else
            for (ipxint p = 0; p < m; p++)
                if (ft[p] != 0.0) score(p, ft[p]);

        if (fmax > 4.0 && fmax_nonfree < 1.0) {
            ipxint jb = basis[pmax];
            ipxint xret = xover_exchange(lu, basis, map2basis, jb, jn,
                                         ft[pmax], -1, fresh, cc);
            if (xret == 1) continue;
            if (xret > 1) { ret = xret; break; }
            stack[*nstack - 1] = jb;       // pop jn, push jb
            flags_out[2]++;
            flags_out[3]++;
        } else if (fmax_nonfree <= dependency_tol) {
            // dependent column: unbounded-primal-ray objective test
            if (!flags_out[1]) {
                double delta = c[jn];
                auto add = [&](ipxint p, double piv) {
                    ipxint bv = basis[p];
                    if (colweights[bv] == inf)
                        delta -= c[bv] * piv;
                };
                if (fnz >= 0)
                    for (ipxint t = 0; t < fnz; t++)
                        add(ftpat[t], ft[ftpat[t]]);
                else
                    for (ipxint p = 0; p < m; p++)
                        if (ft[p] != 0.0) add(p, ft[p]);
                if (std::fabs(delta) > dependency_tol)
                    flags_out[1] = 1;
            }
            flags_out[0]++;
            (*nstack)--;
        } else {
            ipxint jb = basis[pmax_nonfree];
            ipxint xret = xover_exchange(lu, basis, map2basis, jb, jn,
                                         ft[pmax_nonfree], -1, fresh, cc);
            if (xret == 1) continue;
            if (xret > 1) { ret = xret; break; }
            flags_out[2]++;
            (*nstack)--;
        }
    }
    cc.flush(icounts, dcounts, nfills);
    return ret;
}

ipxint ipxlu_pivot_fixed_out(void* h, ipxint* basis, ipxint* map2basis,
                             const double* colweights,
                             const double* b_minus_fixed,
                             double dependency_tol, ipxint* stack,
                             ipxint* nstack, double pause_abs_s,
                             ipxint* fresh, ipxint* flags_out,
                             ipxint* icounts, double* dcounts,
                             double* fills, ipxint fills_cap,
                             ipxint* nfills) {
    IpxLu& lu = *static_cast<IpxLu*>(h);
    const ipxint m = lu.m, n = lu.mb_n;
    XoverCounts cc;
    cc.fills = fills;
    cc.fills_cap = fills_cap;
    double* bt = lu.xw_bt.data();
    ipxint* btpat = lu.xw_btpat.data();
    double* row = lu.xw_row.data();
    ipxint* rowpat = lu.xw_rowpat.data();
    ipxint ret = 0;
    while (*nstack > 0) {
        if (now_monotonic_s() > pause_abs_s) { ret = 3; break; }
        ipxint jb = stack[*nstack - 1];
        ipxint mp = map2basis[jb];
        ipxint pos = mp >= m ? mp - m : mp;
        ipxint bnz;
        ipxint rnz = tableau_row_native(lu, map2basis, pos, 0, bt, btpat,
                                        &bnz, row, rowpat, cc,
                                        /*keep_bt=*/true);
        double rmax = 0.0, rmax_nonfixed = 0.0;
        ipxint jmax = -1, jmax_nonfixed = -1;
        auto score = [&](ipxint j, double piv) {
            double a = std::fabs(piv);
            if (a == 0.0) return;
            bool nonfixed = colweights[j] != 0.0;
            if ((j >= n || nonfixed) && a > rmax) { rmax = a; jmax = j; }
            if (nonfixed && a > rmax_nonfixed) {
                rmax_nonfixed = a;
                jmax_nonfixed = j;
            }
        };
        if (rnz >= 0)
            for (ipxint t = 0; t < rnz; t++) score(rowpat[t], row[rowpat[t]]);
        else
            for (ipxint j = 0; j < n + m; j++)
                if (row[j] != 0.0) score(j, row[j]);

        clear_bt_guard guard{lu, bt, btpat, bnz};
        if (rmax > 4.0 && rmax_nonfixed < 1.0) {
            ipxint xret = xover_exchange(lu, basis, map2basis, jb, jmax,
                                         row[jmax], +1, fresh, cc);
            if (xret == 1) continue;
            if (xret > 1) { ret = xret; break; }
            stack[*nstack - 1] = jmax;     // pop jb, push jmax
            flags_out[2]++;
            flags_out[3]++;
        } else if (rmax_nonfixed <= dependency_tol) {
            // dependent row: unbounded-dual-ray objective test
            if (!flags_out[1]) {
                double delta = 0.0;
                if (bnz >= 0)
                    for (ipxint t = 0; t < bnz; t++)
                        delta += bt[btpat[t]] * b_minus_fixed[btpat[t]];
                else
                    for (ipxint i = 0; i < m; i++)
                        delta += bt[i] * b_minus_fixed[i];
                if (std::fabs(delta) > dependency_tol)
                    flags_out[1] = 1;
            }
            flags_out[0]++;
            (*nstack)--;
        } else {
            // stable pivot maximizing basis volume
            double best = -1.0;
            ipxint jpick = -1;
            auto pick = [&](ipxint j, double piv) {
                double a = std::fabs(piv);
                if (a < 0.1 * rmax_nonfixed) return;
                double sc = a * colweights[j];
                if (sc > best) { best = sc; jpick = j; }
            };
            if (rnz >= 0)
                for (ipxint t = 0; t < rnz; t++)
                    pick(rowpat[t], row[rowpat[t]]);
            else
                for (ipxint j = 0; j < n + m; j++)
                    if (row[j] != 0.0) pick(j, row[j]);
            if (jpick < 0) {               // defensive; cannot happen since
                flags_out[0]++;            // jmax_nonfixed qualifies
                (*nstack)--;
                continue;
            }
            ipxint xret = xover_exchange(lu, basis, map2basis, jb, jpick,
                                         row[jpick], +1, fresh, cc);
            if (xret == 1) continue;
            if (xret > 1) { ret = xret; break; }
            flags_out[2]++;
            (*nstack)--;
        }
    }
    cc.flush(icounts, dcounts, nfills);
    return ret;
}

// ---------------------------------------------------------------------
// Native maxvolume heuristic slice driver (counterpart of reference:
// src/maxvolume.cc:202-320): given per-slice column weights (one dense
// BTRAN + SpMV, computed by the caller), repeatedly exchange the nonbasic
// column with the largest |weight| when its scaled FTRAN max beats
// volume_tol, rank-1-updating the weights after each exchange; stop the
// slice after maxskip skips. cs (nonbasic scales), invscale (by position),
// colweights mutated in place. skipstate[0] persists the skip count across
// pause re-entries. Returns 0 slice done, 3 paused, 301/306 fatal.
// icounts[0] += skips, icounts[1] += exchanges (via the shared counter).
ipxint ipxlu_maxvol_slice(void* h, ipxint* basis, ipxint* map2basis,
                          double* cs, double* invscale,
                          const int8_t* tblrow_used, double* colweights,
                          double volumetol, ipxint maxskip,
                          double pause_abs_s, ipxint* fresh,
                          ipxint* skipstate, double* volinc,
                          ipxint* icounts, double* dcounts, double* fills,
                          ipxint fills_cap, ipxint* nfills) {
    IpxLu& lu = *static_cast<IpxLu*>(h);
    const ipxint m = lu.m, n = lu.mb_n;
    const ipxint total = n + m;
    const double pivot_zero_tol = 1e-7;
    XoverCounts c;
    c.fills = fills;
    c.fills_cap = fills_cap;
    double* ft = lu.xw_ft.data();
    ipxint* ftpat = lu.xw_ftpat.data();
    double* bt = lu.xw_bt.data();
    ipxint* btpat = lu.xw_btpat.data();
    double* row = lu.xw_row.data();
    ipxint* rowpat = lu.xw_rowpat.data();
    ipxint ret = 0;
    // Top-K candidate batch: one O(n+m) scan yields the K largest
    // |weight| columns, consumed largest-first; stale (zeroed) candidates
    // trigger a rescan. Mirrors the Python heuristic (a batched variant of
    // the reference's FindLargest rescans, reference: src/maxvolume.cc).
    const int K = 32;
    ipxint cand[K];
    double cw[K];
    int ncand = 0;
    bool fresh_scan = false;
    while (true) {
        if (now_monotonic_s() > pause_abs_s) { ret = 3; break; }
        if (ncand == 0) {
            fresh_scan = true;
            const double t_sc0 = now_monotonic_s();
            lu.n_mv_scans++;
            for (ipxint j = 0; j < total; j++) {
                double a = std::fabs(colweights[j]);
                if (ncand == K && a <= cw[0]) continue;
                // insert keeping cw ascending
                int t;
                if (ncand < K) {
                    t = ncand++;
                    while (t > 0 && cw[t - 1] > a) {
                        cw[t] = cw[t - 1];
                        cand[t] = cand[t - 1];
                        t--;
                    }
                } else {
                    // evict the smallest, shift entries below a down
                    t = 0;
                    while (t + 1 < K && cw[t + 1] < a) {
                        cw[t] = cw[t + 1];
                        cand[t] = cand[t + 1];
                        t++;
                    }
                }
                cw[t] = a;
                cand[t] = j;
            }
            lu.t_mv_scan += now_monotonic_s() - t_sc0;
            if (ncand == 0) break;
        }
        ipxint jn = cand[ncand - 1];
        if (colweights[jn] == 0.0) {
            if (fresh_scan) break;  // a fresh scan's maximum is zero: done
            ncand = 0;              // stale candidate: rescan
            continue;
        }

        ipxint fnz = ftran_from_block(lu, jn, c, true);
        if (fnz == -2) {
            if (ftran_block_worthwhile(lu, std::min(ncand, 16))) {
                ipxint blk[16];
                int W = std::min(ncand, 16);
                for (int t = 0; t < W; t++)
                    blk[t] = cand[ncand - 1 - t];
                ftran_block_build(lu, blk, W, c);
                fnz = ftran_from_block(lu, jn, c, true);
            }
            if (fnz == -2)
                fnz = ftran_col_for_update(lu, jn, c, true);
        }
        // On dense-fill bases every tableau row costs a full factor
        // traversal; there the row is skipped: the pivot value comes from
        // the FTRAN (identical entry of the tableau), the update stages
        // the leaving position directly, and the rank-1 weight refresh is
        // dropped (weights are only the candidate ordering; the next
        // slice's fresh BTRAN rebuilds them exactly). Hypersparse bases
        // (network: fill ~1.0) keep the reference-exact path (reference:
        // src/maxvolume.cc:202-320).
        const bool cheap_rows = 2 * lu.factor_nnz >= 3 * lu.bnnz;

        double dn = cs[jn];
        ipxint pmax = -1;
        double vmax = 0.0;
        double weight_recomp = 0.0;
        auto score = [&](ipxint p, double piv) {
            if (std::fabs(piv) <= pivot_zero_tol) return;
            double v = std::fabs(piv * dn * invscale[p]);
            if (v > vmax) { vmax = v; pmax = p; }
        };
        if (fnz >= 0) {
            for (ipxint t = 0; t < fnz; t++) score(ftpat[t], ft[ftpat[t]]);
            for (ipxint t = 0; t < fnz; t++) {
                ipxint p = ftpat[t];
                if (tblrow_used[p])
                    weight_recomp += ft[p] * dn * invscale[p];
            }
        } else {
            // dense FTRAN result: ONE fused pass computes the pivot argmax
            // AND the slice-weight recomputation (was two full m-passes,
            // the dominant maxvolume cost on dense-fill bases)
            double vb = 0.0, wr = 0.0;
            ipxint pb = -1;
#ifdef _OPENMP
            if (m >= (ipxint)1 << 16 && omp_get_max_threads() > 1) {
#pragma omp parallel
                {
                    double tvb = 0.0, twr = 0.0;
                    ipxint tpb = -1;
#pragma omp for schedule(static) nowait
                    for (ipxint p = 0; p < m; p++) {
                        double f = ft[p];
                        if (f == 0.0) continue;
                        double sc = dn * invscale[p];
                        if (std::fabs(f) > pivot_zero_tol) {
                            double v = std::fabs(f * sc);
                            if (v > tvb) { tvb = v; tpb = p; }
                        }
                        if (tblrow_used[p]) twr += f * sc;
                    }
#pragma omp critical
                    {
                        if (tvb > vb || (tvb == vb && tpb >= 0
                                         && (pb < 0 || tpb < pb))) {
                            vb = tvb;
                            pb = tpb;
                        }
                        wr += twr;
                    }
                }
            } else
#endif
            for (ipxint p = 0; p < m; p++) {
                double f = ft[p];
                if (f == 0.0) continue;
                double sc = dn * invscale[p];
                if (std::fabs(f) > pivot_zero_tol) {
                    double v = std::fabs(f * sc);
                    if (v > vb) { vb = v; pb = p; }
                }
                if (tblrow_used[p]) wr += f * sc;
            }
            vmax = vb;
            pmax = pb;
            weight_recomp = wr;
        }

        if (pmax < 0 || vmax <= volumetol) {
            colweights[jn] = 0.0;
            cs[jn] = 0.0;
            ncand--;
            c.pushes++;                    // skip counter
            skipstate[0]++;
            if (maxskip >= 0 && skipstate[0] > maxskip) break;
            continue;
        }

        ipxint jb = basis[pmax];
        if (cheap_rows) {
            ipxint xret = xover_exchange(lu, basis, map2basis, jb, jn,
                                         ft[pmax], -1, fresh, c);
            if (xret == 1) continue;
            if (xret > 1) { ret = xret; break; }
            c.pivots++;
            *volinc += std::log2(vmax);
            cs[jb] = 1.0 / invscale[pmax];
            invscale[pmax] = 1.0 / dn;
            cs[jn] = 0.0;
            colweights[jb] = 0.0;
            colweights[jn] = 0.0;
            ncand--;
            fresh_scan = false;
            continue;
        }
        ipxint bnz;
        ipxint rnz = tableau_row_native(lu, map2basis, pmax, 1, bt, btpat,
                                        &bnz, row, rowpat, c);
        double pivot = row[jn];
        ipxint xret = xover_exchange(lu, basis, map2basis, jb, jn, pivot,
                                     0, fresh, c);
        if (xret == 1) continue;
        if (xret > 1) { ret = xret; break; }
        c.pivots++;
        *volinc += std::log2(vmax);

        double dbinv = invscale[pmax];
        cs[jb] = 1.0 / dbinv;
        invscale[pmax] = 1.0 / dn;
        cs[jn] = 0.0;

        // rank-1 update of the column weights
        double used = tblrow_used[pmax] ? 1.0 : 0.0;
        double alpha = (used - weight_recomp) / (dn * pivot);
        if (rnz >= 0) {
            for (ipxint t = 0; t < rnz; t++) {
                ipxint j = rowpat[t];
                colweights[j] += alpha * row[j] * cs[j];
            }
        } else {
            for (ipxint j = 0; j < total; j++)
                if (row[j] != 0.0)
                    colweights[j] += alpha * row[j] * cs[j];
        }
        colweights[jb] = used + alpha / dbinv;
        colweights[jn] = 0.0;
        ncand--;
        fresh_scan = false;
    }
    c.flush(icounts, dcounts, nfills);
    return ret;
}

// ---------------------------------------------------------------------
// Splitted-normal operator + whole phase-2 CR loop in native code
// (counterpart of reference: src/splitted_normal_matrix.cc +
// src/conjugate_residuals.cc:14-88 + src/kkt_solver_basis.cc:145-156,
// eliminating Python crossings per CR iteration).
// ---------------------------------------------------------------------

// Loads the nonbasic partition N (CSC; rows already permuted into position
// space, columns already scaled by the caller), the basic column scales and
// the BASIC_FREE positions. Requires fresh factors (no etas).
void ipxlu_splitted_prepare(void* h, ipxint ncols, const ipxint* Np,
                            const int32_t* Ni, const double* Nx,
                            const double* uscale, ipxint nfree,
                            const ipxint* freepos) {
    IpxLu& lu = *static_cast<IpxLu*>(h);
    const ipxint m = lu.m;
    const ipxint nnz = Np[ncols];
    lu.Nptr.assign(Np, Np + ncols + 1);
    lu.Nidx.assign(Ni, Ni + nnz);
    lu.Nval.assign(Nx, Nx + nnz);
    lu.uscale.assign(uscale, uscale + m);
    lu.freepos.assign(freepos, freepos + nfree);
    lu.s_w.assign(m, 0.0);
    lu.s_wr.assign(m, 0.0);
    lu.s_res.assign(m, 0.0);
    lu.s_Cres.assign(m, 0.0);
    lu.s_step.assign(m, 0.0);
    lu.s_Cstep.assign(m, 0.0);
    lu.t_B = lu.t_Bt = lu.t_NNt = 0.0;
    lu.have_splitted = true;
}

// Unpreconditioned CR on the splitted normal operator, lhs starting at 0
// (reference: src/conjugate_residuals.cc:14-88; inf-norm termination, no
// residual scaling in phase 2). Returns 0 ok, 201 iter limit, 202 matrix
// not posdef, 205 inf/nan, 999 deadline exceeded. out_times = {B, Bt, NNt}
// operator-time split for Info.
ipxint ipxlu_cr_basis(void* h, const double* rhs, double tol, ipxint maxiter,
                      double deadline_s, double* lhs, ipxint* out_iters,
                      double* out_times, const double* lhs0) {
    IpxLu& lu = *static_cast<IpxLu*>(h);
    const ipxint m = lu.m;
    if (!lu.have_splitted) return -2;
    if (maxiter < 0) maxiter = m + 100;
    lu.t_B = lu.t_Bt = lu.t_NNt = 0.0;

    double* residual = lu.s_res.data();
    double* Cres = lu.s_Cres.data();
    double* step = lu.s_step.data();
    double* Cstep = lu.s_Cstep.data();
    std::memcpy(residual, rhs, m * sizeof(double));
    std::fill(lhs, lhs + m, 0.0);
    if (lhs0 != nullptr) {
        // warm start (one extra operator application): residual of lhs0
        // vs the zero start, keep whichever is smaller in the inf-norm —
        // a bad warm start can never make the solve worse
        double* Cw = lu.s_Cstep.data();     // scratch before CR state init
        splitted_apply(lu, lhs0, Cw);
        double rn_warm = 0.0, rn_zero = 0.0;
        for (ipxint i = 0; i < m; i++) {
            rn_warm = std::max(rn_warm, std::fabs(rhs[i] - Cw[i]));
            rn_zero = std::max(rn_zero, std::fabs(rhs[i]));
        }
        if (std::isfinite(rn_warm) && rn_warm < rn_zero) {
            for (ipxint i = 0; i < m; i++) {
                residual[i] = rhs[i] - Cw[i];
                lhs[i] = lhs0[i];
            }
        }
    }
    double cdot = splitted_apply(lu, residual, Cres);
    // fused init: step/Cstep copies + denom + initial inf-norm in one sweep
    double denom = 0.0, resnorm = 0.0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) \
    reduction(+ : denom) reduction(max : resnorm) \
    if (m >= (ipxint)1 << 15)
#endif
    for (ipxint i = 0; i < m; i++) {
        step[i] = residual[i];
        double c = Cres[i];
        Cstep[i] = c;
        denom += c * c;
        resnorm = std::max(resnorm, std::fabs(residual[i]));
    }

    ipxint it = 0;
    ipxint err = 0;
    while (true) {
        if (resnorm <= tol) break;
        if (it >= maxiter) { err = 201; break; }
        if (cdot <= 0.0) { err = 202; break; }
        double alpha = cdot / denom;
        if (!std::isfinite(alpha)) { err = 205; break; }
        double rn = 0.0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) reduction(max : rn) \
    if (m >= (ipxint)1 << 15)
#endif
        for (ipxint i = 0; i < m; i++) {
            lhs[i] += alpha * step[i];
            double r = residual[i] - alpha * Cstep[i];
            residual[i] = r;
            rn = std::max(rn, std::fabs(r));
        }
        resnorm = rn;
        double cdot_new = splitted_apply(lu, residual, Cres);
        double beta = cdot_new / cdot;
        double dn = 0.0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) reduction(+ : dn) \
    if (m >= (ipxint)1 << 15)
#endif
        for (ipxint i = 0; i < m; i++) {
            step[i] = residual[i] + beta * step[i];
            double c = Cres[i] + beta * Cstep[i];
            Cstep[i] = c;
            dn += c * c;
        }
        denom = dn;
        cdot = cdot_new;
        it++;
        if (it % 5 == 0 && deadline_s > 0.0 &&
            now_monotonic_s() > deadline_s) {
            err = 999;
            break;
        }
    }
    *out_iters = it;
    out_times[0] = lu.t_B;
    out_times[1] = lu.t_Bt;
    out_times[2] = lu.t_NNt;
    return err;
}

// ---------------------------------------------------------------------
// Fused IPM vector kernels: single-pass versions of the per-iteration
// masked-vector chains in the Newton solve / step-size / update path
// (reference: src/ipm.cc:319-339,438-531,551-631 and src/iterate.cc:96-139).
// State codes match ipx_tpu/iterate.py: 0 BARRIER_LB, 1 BARRIER_UB,
// 2 BARRIER_BOXED, 3 FREE, 4 FIXED, 5-7 IMPLIED_*.
// ---------------------------------------------------------------------

static inline bool st_blb(int8_t s) { return s == 0 || s == 2; }
static inline bool st_bub(int8_t s) { return s == 1 || s == 2; }

// rhs1 = -rc + [blb](sl + zl*rl)/xl - [bub](su - zu*ru)/xu; 0 at FIXED
// (reference: src/ipm.cc:551-560)
void ipxlu_newton_rhs1(ipxint nm, const int8_t* state, const double* rc,
                       const double* rl, const double* ru, const double* sl,
                       const double* su, const double* xl, const double* xu,
                       const double* zl, const double* zu, double* rhs1) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (nm >= (ipxint)1 << 15)
#endif
    for (ipxint j = 0; j < nm; j++) {
        int8_t s = state[j];
        double v = -rc[j];
        if (st_blb(s)) v += (sl[j] + zl[j] * rl[j]) / xl[j];
        if (st_bub(s)) v -= (su[j] - zu[j] * ru[j]) / xu[j];
        rhs1[j] = (s == 4) ? 0.0 : v;
    }
}

// Recover dxl/dxu/dzl/dzu from dx and shift the first-block residual into
// dzl/dzu on the finite-bound side (reference: src/ipm.cc:577-631).
void ipxlu_newton_recover(ipxint nm, const int8_t* state, const double* dx,
                          const double* atdy, const double* rc,
                          const double* rl, const double* ru,
                          const double* sl, const double* su,
                          const double* xl, const double* xu,
                          const double* zl, const double* zu, double* dxl,
                          double* dxu, double* dzl, double* dzu) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (nm >= (ipxint)1 << 15)
#endif
    for (ipxint j = 0; j < nm; j++) {
        int8_t s = state[j];
        if (s > 2) {            // not a barrier variable
            dxl[j] = dxu[j] = dzl[j] = dzu[j] = 0.0;
            continue;
        }
        double a = dx[j] - rl[j];
        double zl_ = (sl[j] - zl[j] * a) / xl[j];
        double b = ru[j] - dx[j];
        double zu_ = (su[j] - zu[j] * b) / xu[j];
        bool finl = std::isfinite(xl[j]);
        bool finu = std::isfinite(xu[j]);
        bool lower = zl[j] * xu[j] >= zu[j] * xl[j];   // NaN compares false
        bool use_l = finl && (!finu || lower);
        if (use_l)
            zl_ = rc[j] + zu_ - atdy[j];
        else if (finu)
            zu_ = -rc[j] + zl_ + atdy[j];
        dxl[j] = a;
        dxu[j] = b;
        dzl[j] = zl_;
        dzu[j] = zu_;
    }
}

// Max alpha <= 1 with x + alpha*dx >= 0; entries with x == inf never block
// (reference: src/ipm.cc:319-339). Returns the blocking index or -1.
ipxint ipxlu_step_boundary(ipxint nm, const double* x, const double* dx,
                           double* alpha_out) {
    const double damp = 1.0 - 2.220446049250313e-16;
    double best = std::numeric_limits<double>::infinity();
    ipxint bestj = -1;
#ifdef _OPENMP
    if (nm >= (ipxint)1 << 15 && omp_get_max_threads() > 1) {
#pragma omp parallel
        {
            double tb = std::numeric_limits<double>::infinity();
            ipxint tj = -1;
#pragma omp for schedule(static) nowait
            for (ipxint j = 0; j < nm; j++) {
                if (dx[j] < 0.0 && std::isfinite(x[j])) {
                    double cand = -(x[j] * damp) / dx[j];
                    if (cand < tb) { tb = cand; tj = j; }
                }
            }
#pragma omp critical
            {
                // deterministic merge: smallest index among equal minima
                if (tb < best || (tb == best && tj >= 0
                                  && (bestj < 0 || tj < bestj))) {
                    best = tb;
                    bestj = tj;
                }
            }
        }
    } else
#endif
    for (ipxint j = 0; j < nm; j++) {
        if (dx[j] < 0.0 && std::isfinite(x[j])) {
            double cand = -(x[j] * damp) / dx[j];
            if (cand < best) { best = cand; bestj = j; }
        }
    }
    if (bestj < 0 || best >= 1.0) {
        *alpha_out = 1.0;
        return -1;
    }
    *alpha_out = best;
    return bestj;
}

// sum over barrier sides of (xl+maxp*dxl)(zl+maxd*dzl) etc., with the
// number of terms (for muaff / mufull; reference: src/ipm.cc:394-413,455).
void ipxlu_compl_products(ipxint nm, const int8_t* state, const double* xl,
                          const double* zl, const double* xu,
                          const double* zu, const double* dxl,
                          const double* dzl, const double* dxu,
                          const double* dzu, double maxp, double maxd,
                          double* sum_out, ipxint* count_out) {
    double sum = 0.0;
    ipxint count = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) \
    reduction(+ : sum) reduction(+ : count) if (nm >= (ipxint)1 << 15)
#endif
    for (ipxint j = 0; j < nm; j++) {
        int8_t s = state[j];
        if (st_blb(s)) {
            sum += (xl[j] + maxp * dxl[j]) * (zl[j] + maxd * dzl[j]);
            count++;
        }
        if (st_bub(s)) {
            sum += (xu[j] + maxp * dxu[j]) * (zu[j] + maxd * dzu[j]);
            count++;
        }
    }
    *sum_out = sum;
    *count_out = count;
}

// Fused lazy-evaluation pass of the iterate: bound residuals rl/ru, dual
// residual rc, objective and complementarity aggregates in ONE sweep
// (reference: src/iterate.cc:536-672). Scalars out (length 12):
// [0] max(|rl|,|ru|), [1] max|rc|, [2] sum c*x (pobj part), [3] offset
// (fixed part), [4] sum (zl-zu)*x over implied, [5] sum lb*zl (dual obj),
// [6] sum ub*zu, [7] sum x*aty over fixed, [8] comp sum, [9] comp min,
// [10] comp max, [11] comp count.
void ipxlu_iterate_eval(ipxint nm, const int8_t* state, ipxint postproc,
                        const double* x, const double* xl, const double* xu,
                        const double* zl, const double* zu,
                        const double* lb, const double* ub, const double* c,
                        const double* aty, double* rl, double* ru,
                        double* rc, double* scal) {
    double pres = 0.0, dres = 0.0, pobj = 0.0, offset = 0.0, zximp = 0.0;
    double dlb = 0.0, dub = 0.0, dfix = 0.0;
    double csum = 0.0, cmin = std::numeric_limits<double>::infinity();
    double cmax = 0.0;
    ipxint ccount = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) \
    reduction(max : pres, dres, cmax) reduction(min : cmin) \
    reduction(+ : pobj, offset, zximp, dlb, dub, dfix, csum, ccount) \
    if (nm >= (ipxint)1 << 15)
#endif
    for (ipxint j = 0; j < nm; j++) {
        int8_t s = state[j];
        bool blb = st_blb(s), bub = st_bub(s);
        double rlj = blb ? lb[j] - x[j] + xl[j] : 0.0;
        double ruj = bub ? ub[j] - x[j] - xu[j] : 0.0;
        rl[j] = rlj;
        ru[j] = ruj;
        pres = std::max(pres, std::fabs(rlj));
        pres = std::max(pres, std::fabs(ruj));
        double rcj = c[j] - aty[j] - zl[j] + zu[j];
        if (!postproc && s == 4) rcj = 0.0;
        rc[j] = rcj;
        dres = std::max(dres, std::fabs(rcj));
        double cx = c[j] * x[j];
        if (postproc) {
            pobj += cx;
            if (std::isfinite(lb[j])) dlb += lb[j] * zl[j];
            if (std::isfinite(ub[j])) dub += ub[j] * zu[j];
        } else {
            if (s == 4) {
                offset += cx;
                dfix += x[j] * aty[j];
            } else {
                pobj += cx;
            }
            if (s >= 5) zximp += (zl[j] - zu[j]) * x[j];
            if (blb) dlb += lb[j] * zl[j];
            if (bub) dub += ub[j] * zu[j];
        }
        if (blb) {
            double p = xl[j] * zl[j];
            csum += p;
            if (p < cmin) cmin = p;
            if (p > cmax) cmax = p;
            ccount++;
        }
        if (bub) {
            double p = xu[j] * zu[j];
            csum += p;
            if (p < cmin) cmin = p;
            if (p > cmax) cmax = p;
            ccount++;
        }
    }
    scal[0] = pres;
    scal[1] = dres;
    scal[2] = pobj;
    scal[3] = offset;
    scal[4] = zximp;
    scal[5] = dlb;
    scal[6] = dub;
    scal[7] = dfix;
    scal[8] = csum;
    scal[9] = ccount ? cmin : 0.0;
    scal[10] = ccount ? cmax : 0.0;
    scal[11] = (double)ccount;
}

// Masked iterate step with clamping at kBarrierMin = 1e-30
// (reference: src/iterate.cc:96-139).
void ipxlu_iterate_update(ipxint nm, const int8_t* state, double sp,
                          double sd, double* x, double* xl, double* xu,
                          double* zl, double* zu, const double* dx,
                          const double* dxl, const double* dxu,
                          const double* dzl, const double* dzu) {
    const double bmin = 1e-30;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (nm >= (ipxint)1 << 15)
#endif
    for (ipxint j = 0; j < nm; j++) {
        int8_t s = state[j];
        if (s != 4) x[j] += sp * dx[j];
        if (st_blb(s)) {
            xl[j] = std::max(xl[j] + sp * dxl[j], bmin);
            zl[j] = std::max(zl[j] + sd * dzl[j], bmin);
        }
        if (st_bub(s)) {
            xu[j] = std::max(xu[j] + sp * dxu[j], bmin);
            zu[j] = std::max(zu[j] + sd * dzu[j], bmin);
        }
    }
}

}  // extern "C"
