// Batched affine-gap DP fill, score only, for NVIDIA Hopper (sm_90a).
//
// Replaces hisat2_tpu/ops/dp_pallas.py:dp_score_pallas (body _dp_kernel,
// helpers _cummax_sub and _shift_down). It computes what that kernel
// computes, one int32 score per candidate (read, reference window):
//   * global in the read, with qual-scaled soft clips: a 5' clip of i
//     bases is a floor of -scp_cum[i] on row i, a 3' clip after row i
//     costs scp_cum[L] - scp_cum[i+1];
//   * free leading and trailing gaps in the reference window;
//   * substitution: match bonus, precomputed mismatch penalty, N penalty;
//   * reference gaps by the F recurrence, read gaps closed per row by the
//     running-max identity
//         E[j] = cummax_k(G[k] + ext*k) - open - ext*(j-1);
//   * rows past a read's length frozen (the loop simply stops there).
// The plain PyTorch version is hisat2_tpu_torch/ops/sw.py:dp_fill_plain.
//
// What bounds it on the card: operations, not bytes. The SE path's launch
// fills 8192 candidates x 100 read rows x 137 columns (112 M cells) from
// 14.8 MB of inputs, the paired-end mate rescue's 512 x 100 x 1105 (57 M
// cells) from 2.9 MB; at 8.5 integer instructions a cell (below) the
// arithmetic takes several times longer than the bytes.
//
// The cell update, shared by both kernels (Cols, fill_g, fill_h). All
// values of row i are kept with i * rf_ext added, so a reference gap
// extends for free and F needs no decrement; everything that is fixed
// per column (window base, ext * j, the E cost -open - ext * (j - 1)) or
// per row (read base, mismatch score, clip floor) is computed once,
// outside the cell. Each add-then-max is one fused instruction
// (__viaddmax_s32, __vimax3_s32: VIADDMNMX and VIMNMX3 on sm_90). Per
// cell that leaves:
//     s   = window base == read base ? match : mismatch     2 (compare, select)
//     F'  = max(H + (rf_ext - rf_open), F)                  1
//     G   = max(Hdiag + s, F')                              1
//     run = max(G + ext * j, run)                           1
//     H'  = max(G, max(M[j-1], excl) + e_j, clip floor)     3
//     row maximum, a three-way max over two cells           0.5
// 8.5 instructions; a row's lane scan, hand-off and loop come on top
// (PERF.md has the counts from the SASS). What does not happen in every
// cell is handled where it occurs: column 0 in thread 0's first column; the columns past the
// window only in the row maximum (they lie to the right of every real
// column, so nothing they hold can reach one; they hold ordinary finite
// scores, never kNeg minus a growing term, so nothing wraps); a window
// base of N by a per-thread bit mask whose fix-up runs only in warps
// that hold one; a read base of N by the row's constants.
//
// Windows of up to 256 columns (the SE path): one warp per candidate,
// CPL = ceil((W+1)/32) columns per lane in registers. The diagonal
// neighbour crosses lanes by __shfl_up_sync, the running max is a per-lane
// scan plus a warp-shuffle scan. No barrier; shared memory holds only the
// staged row constants; each thread keeps its own 3'-clip maximum and the
// warp reduces once at the end.
//
// Wider windows, up to 2048 columns in one pass (the mate rescue, W =
// min(maxins, 1000) + L; graph reads of 224 bp and more with the overlay):
// one block of 4 warps per candidate, 128 * CPL columns, CPL = 3..16 (more
// warps with fewer columns each were slower at every window measured:
// the per-row scan and hand-off are paid per warp). The warps are
// skewed: at step t warp w fills row t - w. What a warp needs from its
// left neighbour was then produced a step earlier: the neighbour's last
// column's H of the row above (ring of 4 in shared memory) and the
// running-max prefix of this row through the neighbour (ring of 2), which
// each warp publishes with its own total folded in, so the reader takes one
// value. One block barrier a step, len + 3 steps. As in the one-warp
// kernel, the row's constants (read base, mismatch score, clip floor) are
// staged in shared memory once, so no global load sits in the row loop.
// The wrapper picks CPL by the window (ops/dp_cuda.dispatch_plan) and
// this file refuses a plan that does not cover it. The widest variant uses 128
// registers a thread, so four blocks fit an SM and the rescue's 512
// candidates are resident in one wave on 132 SMs.
//
// Any wider window (reads of about 2 kb and more: W = L + 32 in
// _stage_dp) takes the same block walking the window in column tiles of
// 128 * CPL columns (template flag TILED, CPL = 4, 8, 12 or 16; one launch,
// any number of tiles). A tile's first column needs, for every read row,
// the H of the row above in the previous tile's last column and the
// running-max prefix of the row through all tiles before: the thread that
// holds a tile's last column (warp 3, lane 31) writes both to shared
// memory (2 * L + 1 int32 behind the staged rows) at the step of that
// row, and the thread that holds the next tile's first column (warp 0,
// lane 0) reads them at its step of the row. Warp 0 runs row i at step i
// and warp 3 at step i + 3, so in a tile the reader takes row i's value
// before the writer overwrites it: one slot per row. The 3'-clip best and
// the row maxima are maxima over columns and carry across tiles in
// registers; the window-N and overlay fix-ups are per column and need
// nothing at a tile edge. The untiled instantiations compile to what they
// were before the flag (same registers, same row loop).
//
// The SNV overlay (graph indexes; template flag OV). The JAX package has
// no overlay in its TPU kernel and sends a graph index's DP through the
// plain scan (ops/sw.dp_score_batch with ov); here the kernel takes it.
// Each window base may carry a 4-bit nibble: 0 none, 1..4 a known alt
// allele's code + 1, 15 several alts. A cell whose read base and window
// base are both real and differ scores as a match where the nibble names
// the read base or is 15. A nibble is fixed per column for the whole
// launch, as the window base is, and rare (about one base in 250), so it
// is handled as the window N is: cols_init turns the thread's nibbles
// into four 8-bit column masks in one register (byte b: the columns where
// a read base b is a known allele), and the fix-up in fill_g runs only
// in threads whose mask for the row's read base is not empty. A read N
// has no mask, and the window-N fix-up runs after this one, so an N on
// either side keeps -n_pen. Above 8 columns a lane the four masks are
// 16-bit lanes of a 64-bit pair (OvMask): with one 32-bit word of nibbles
// live the 16-column one-block variant spilled 28 bytes at its 128
// registers (nvcc 12.9.86); with the masks it does not. Both kernels have
// overlay instantiations, tiled or not; the instantiations without OV
// compile to what they were before the flag (same registers, same row
// loop).

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#if defined(__CUDACC_VER_MAJOR__) && __CUDACC_VER_MAJOR__ >= 12
#define DP_FUSED 1
#else
#define DP_FUSED 0
#endif

namespace {

constexpr int kNeg = -(1 << 28);
constexpr int kWarpsPerBlock = 4;       // one-warp kernel: candidates a block
constexpr int kWideWarps = 4;           // one-block kernel: warps a candidate
constexpr int kRowN = 8;                // read base N: equals no window base
constexpr int kColPad = 5;              // column 0 and columns past W
constexpr unsigned kFull = 0xffffffffu;

// Pins a value that is fixed for the whole launch in a register. Without
// it the compiler recomputes the per-column constants, the N mask and the
// shared-memory addresses from the thread index in every row (it counts
// them cheap), which costs more instructions a cell than the recurrence.
#define DP_KEEP(x) asm volatile("" : "+r"(x))

// max(a + b, c) and max(a, b, c): one instruction each on sm_90
__device__ __forceinline__ int addmax(int a, int b, int c)
{
#if DP_FUSED
    return __viaddmax_s32(a, b, c);
#else
    return max(a + b, c);
#endif
}

__device__ __forceinline__ int max3(int a, int b, int c)
{
#if DP_FUSED
    return __vimax3_s32(a, b, c);
#else
    return max(max(a, b), c);
#endif
}

// What is the same in every cell of read row i. Values of row i carry
// (i + 1) * rf_ext after the row's update (see the note above).
struct RowK {
    int rcx;        // read base, kRowN for N
    int sx;         // score of a non-matching cell, + rf_ext
    int clipx;      // 5' clip floor -scp_cum[i + 1], + (i + 1) * rf_ext
};

__device__ __forceinline__ RowK row_consts(int rc, int pc, int scp_next,
                                           int i, int n_pen, int rf_ext)
{
    RowK r;
    const bool n = rc >= 4;
    r.rcx = n ? kRowN : rc;
    r.sx = (n ? -n_pen : -pc) + rf_ext;
    r.clipx = (i + 1) * rf_ext - scp_next;
    DP_KEEP(r.sx);      // or the + rf_ext moves behind every cell's select
    return r;
}

// Stages the RowK of a candidate's read rows in shared memory, once, by
// `nthreads` threads of which this is thread `tid`; the row loop then
// takes one 16-byte shared load a row and no global load.
__device__ __forceinline__ void stage_rows(int4* rows, const int32_t* rdc,
                                           const int32_t* penc,
                                           const int32_t* scpc, int len,
                                           int n_pen, int rf_ext, int tid,
                                           int nthreads)
{
    for (int i = tid; i < len; i += nthreads) {
        const RowK r = row_consts(rdc[i], penc[i], scpc[i + 1], i, n_pen,
                                  rf_ext);
        rows[i] = make_int4(r.rcx, r.sx, r.clipx, 0);
    }
}

__device__ __forceinline__ RowK staged_row(const int4* rows, int i)
{
    const int4 q = rows[i];
    return RowK{q.x, q.y, q.z};
}

// The overlay's column masks: four byte-lanes of 8 bits in one register
// up to 8 columns a thread, four 16-bit lanes in a 64-bit pair above.
template <int CPL>
constexpr int kOvStride = CPL <= 8 ? 8 : 16;
template <int CPL>
using OvMask = std::conditional_t<(CPL <= 8), unsigned, unsigned long long>;

// A thread's CPL adjacent columns j0 .. j0 + CPL - 1.
template <int CPL>
struct Cols {
    int H[CPL], F[CPL];
    int rf[CPL];        // window base; kColPad where there is none
    int ext[CPL];       // rd_ext * j
    int e[CPL];         // -rd_open - rd_ext * (j - 1)
    unsigned nmask;     // bit k: the window base of column k is N
    OvMask<CPL> ovm;    // overlay kernels only: bit kOvStride<CPL> * b + k
                        // set where read base b is free in column k
    int nreal;          // how many of the columns are <= W
};

template <int CPL, bool OV>
__device__ __forceinline__ void cols_init(Cols<CPL>& c, const int32_t* refc,
                                          const int32_t* ovc, int j0, int W,
                                          int rd_open, int rd_ext)
{
    static_assert(!OV || CPL <= 16, "the overlay masks hold 16 columns");
    using M = OvMask<CPL>;
    constexpr int S = kOvStride<CPL>;
    c.nmask = 0;
    if constexpr (OV) c.ovm = 0;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
        const int j = j0 + k;
        c.H[k] = (j <= W) ? 0 : kNeg;   // free leading reference gap
        c.F[k] = kNeg;
        const int b = (j >= 1 && j <= W) ? refc[j - 1] : kColPad;
        c.rf[k] = b;
        if (b == 4) c.nmask |= 1u << k;
        if constexpr (OV) {             // column 0 and the padding: none
            const unsigned nib =
                (j >= 1 && j <= W) ? ((unsigned)ovc[j - 1] & 15u) : 0u;
            const M one = 1;
            const M hit = nib == 15u                    // several alts
                ? (one | one << S | one << 2 * S | one << 3 * S)
                : (nib >= 1u && nib <= 4u) ? one << (S * (nib - 1u)) : M(0);
            c.ovm |= hit << k;
        }
        c.ext[k] = rd_ext * j;
        c.e[k] = -rd_open - rd_ext * (j - 1);
        DP_KEEP(c.ext[k]);
        DP_KEEP(c.e[k]);
    }
    c.nreal = min(max(W + 1 - j0, 0), CPL);
    DP_KEEP(c.nmask);
    DP_KEEP(c.nreal);
    if constexpr (OV) {
        if constexpr (sizeof(c.ovm) == 8)
            asm volatile("" : "+l"(c.ovm));
        else
            DP_KEEP(c.ovm);
    }
}

// First half of a row: F and G of the thread's columns and the running
// max of G + ext * j, seeded with run0. hleft is the row above's H in
// column j0 - 1; `first` marks the thread that holds column 0. Returns the
// thread's inclusive run.
template <int CPL, bool OV>
__device__ __forceinline__ int fill_g(Cols<CPL>& c, int (&G)[CPL],
                                      int (&M)[CPL], int hleft, const RowK& r,
                                      int sm, int sn, int cf, bool first,
                                      int run0)
{
    int s[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) s[k] = (c.rf[k] == r.rcx) ? sm : r.sx;
    if constexpr (OV) {
        // Columns where this row's read base is a known allele: rare. A
        // read N (rcx = kRowN) has no mask and keeps its -n_pen; where the
        // bases match anyway, s[k] is sm already.
        constexpr int S = kOvStride<CPL>;
        const unsigned m = r.rcx < 4
            ? unsigned(c.ovm >> (S * r.rcx)) & ((1u << S) - 1u) : 0u;
        if (m) {
#pragma unroll
            for (int k = 0; k < CPL; ++k)
                if (m & (1u << k)) s[k] = sm;
        }
    }
    if (c.nmask) {                      // a window base of N: rare; it
                                        // wins over the overlay's fix-up
#pragma unroll
        for (int k = 0; k < CPL; ++k)
            if (c.nmask & (1u << k)) s[k] = sn;
    }
    int run = run0;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
        const int hdiag = (k == 0) ? hleft : c.H[k - 1];
        int fn = addmax(c.H[k], cf, c.F[k]);
        int g = addmax(hdiag, s[k], fn);
        if (k == 0 && first) { g = cf; fn = cf; }   // column 0: all gap
        G[k] = g;
        c.F[k] = fn;
        run = addmax(g, c.ext[k], run);
        M[k] = run;
    }
    return run;
}

// Maximum of H over the thread's columns inside the window.
template <int CPL>
__device__ __forceinline__ int col_max(const Cols<CPL>& c)
{
    int m = kNeg;
    if (c.nreal == CPL) {
#pragma unroll
        for (int k = 0; k + 1 < CPL; k += 2) m = max3(m, c.H[k], c.H[k + 1]);
        if (CPL & 1) m = max(m, c.H[CPL - 1]);
    } else {                            // the thread that holds column W
#pragma unroll
        for (int k = 0; k < CPL; ++k)
            if (k < c.nreal) m = max(m, c.H[k]);
    }
    return m;
}

// Second half: close the read gaps with the running max (excl: the max
// over every column left of the thread), apply the 5' clip floor, and
// return the thread's row maximum.
template <int CPL>
__device__ __forceinline__ int fill_h(Cols<CPL>& c, const int (&G)[CPL],
                                      const int (&M)[CPL], int excl,
                                      int clipx)
{
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
        const int u = excl + c.e[k];
        const int t = (k == 0) ? u : addmax(M[k - 1], c.e[k], u);
        c.H[k] = max3(G[k], t, clipx);
    }
    return col_max(c);
}

// Shared-memory words by their 32-bit shared address. The wide kernel
// keeps the addresses of its hand-off slots pinned in registers; through
// plain indexing the compiler rebuilds each address from the thread index
// in every row, about 35 instructions a row.
__device__ __forceinline__ unsigned smem_addr(const void* p)
{
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int lds(unsigned addr)
{
    int v;
    asm volatile("ld.shared.s32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
    return v;
}

__device__ __forceinline__ void sts(unsigned addr, int v)
{
    asm volatile("st.shared.s32 [%0], %1;" : : "r"(addr), "r"(v) : "memory");
}

// Inclusive max scan over the warp's lanes. A lane below d reads its own
// value back from the shuffle, so no lane test is needed.
__device__ __forceinline__ int warp_scan_max(int v)
{
#pragma unroll
    for (int d = 1; d < 32; d <<= 1)
        v = max(v, __shfl_up_sync(kFull, v, d));
    return v;
}

template <int CPL, bool OV>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
dp_score_kernel(const int32_t* __restrict__ rd,
                const int32_t* __restrict__ pen,
                const int32_t* __restrict__ rdlens,
                const int32_t* __restrict__ ref,
                const int32_t* __restrict__ scp_cum,
                const int32_t* __restrict__ ov,     // (C, W), read if OV
                int32_t* __restrict__ out,
                int C, int L, int W, int match_bonus, int n_pen,
                int rd_open, int rd_ext, int rf_open, int rf_ext)
{
    extern __shared__ int4 rows_all[];  // RowK of each warp's read rows
    const int lane = threadIdx.x & 31;
    const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (c >= C) return;                 // uniform per warp
    int4* rows = rows_all + (size_t)(threadIdx.x >> 5) * L;
    const int32_t* rdc = rd + (size_t)c * L;
    const int32_t* penc = pen + (size_t)c * L;
    const int32_t* scpc = scp_cum + (size_t)c * (L + 1);
    const int len = min(max(rdlens[c], 0), L);
    const int scp_tot = scpc[L];
    const int sm = match_bonus + rf_ext;
    const int sn = rf_ext - n_pen;
    const int cf = rf_ext - rf_open;
    const bool first = lane == 0;

    Cols<CPL> col;
    cols_init<CPL, OV>(col, ref + (size_t)c * W,
                       OV ? ov + (size_t)c * W : nullptr, lane * CPL, W,
                       rd_open, rd_ext);
    int best = -scp_tot;                // clip the whole read
    stage_rows(rows, rdc, penc, scpc, len, n_pen, rf_ext, lane, 32);
    __syncwarp();

    for (int i = 0; i < len; ++i) {
        const RowK r = staged_row(rows, i);
        // the row above's H in this lane's first column - 1
        const int hleft = __shfl_up_sync(kFull, col.H[CPL - 1], 1);
        int G[CPL], M[CPL];
        const int run = fill_g<CPL, OV>(col, G, M, hleft, r, sm, sn, cf,
                                        first, kNeg);
        const int tot = warp_scan_max(run);
        int excl = __shfl_up_sync(kFull, tot, 1);
        if (first) excl = kNeg;
        const int rowmax = fill_h(col, G, M, excl, r.clipx);
        // 3' soft clip: end the alignment after read position i + 1
        best = addmax(rowmax, -r.clipx - scp_tot, best);
    }
    best = max(best, col_max(col) - len * rf_ext);
    best = __reduce_max_sync(kFull, best);
    if (first) out[c] = best;
}

// Four blocks an SM: the 512 candidates of a rescue launch are resident
// in one wave on 132 SMs, and a thread may use up to 128 registers.
// OV: the SNV overlay, as in the one-warp kernel. TILED: the window is
// walked in column tiles of 128 * CPL columns, any number of them (see the
// note at the top); without it one pass covers W + 1 <= 128 * CPL.
template <int CPL, bool OV, bool TILED>
__global__ void __launch_bounds__(32 * kWideWarps, 4)
dp_score_wide_kernel(const int32_t* __restrict__ rd,
                     const int32_t* __restrict__ pen,
                     const int32_t* __restrict__ rdlens,
                     const int32_t* __restrict__ ref,
                     const int32_t* __restrict__ scp_cum,
                     const int32_t* __restrict__ ov,    // (C, W), read if OV
                     int32_t* __restrict__ out,
                     int L, int W, int match_bonus, int n_pen,
                     int rd_open, int rd_ext, int rf_open, int rf_ext)
{
    constexpr int NW = kWideWarps;
    constexpr int CAP = 32 * NW * CPL;  // columns of one pass (tile)
    extern __shared__ int4 rows[];      // RowK of each read row; TILED:
                                        // then the tile carries (below)
    __shared__ int pfx[NW][2];          // run prefix through warp w, row r & 1
    __shared__ int hedge[NW][4];        // warp w's last H after row r - 1
    __shared__ int wbest[NW];
    int lane = threadIdx.x & 31;
    int warp = threadIdx.x >> 5;
    DP_KEEP(lane);
    DP_KEEP(warp);
    const int c = blockIdx.x;
    const int32_t* rdc = rd + (size_t)c * L;
    const int32_t* penc = pen + (size_t)c * L;
    const int32_t* scpc = scp_cum + (size_t)c * (L + 1);
    const int len = min(max(rdlens[c], 0), L);
    const int scp_tot = scpc[L];
    const int sm = match_bonus + rf_ext;
    const int sn = rf_ext - n_pen;
    const int cf = rf_ext - rf_open;
    const bool edge = lane == 0 && warp > 0;    // reads the left warp's values
    const bool last = lane == 31;               // publishes this warp's values
    unsigned pfx_in = smem_addr(pfx[warp > 0 ? warp - 1 : 0]);
    unsigned hedge_in = smem_addr(hedge[warp > 0 ? warp - 1 : 0]);
    unsigned pfx_out = smem_addr(pfx[warp]);
    unsigned hedge_out = smem_addr(hedge[warp]);
    DP_KEEP(pfx_in);
    DP_KEEP(hedge_in);
    DP_KEEP(pfx_out);
    DP_KEEP(hedge_out);
    // Tile carries (TILED): carry_h[i] is the H of read row i - 1 in the
    // last column of the tile before (carry_h[0], the row above the read,
    // is 0 in every column), carry_r[i] the running-max prefix of row i
    // through every tile before. The thread that holds a tile's first
    // column (warp 0, lane 0) reads row i's at step i; the one that holds
    // its last column (warp NW - 1, lane 31) writes them for the next tile
    // at step i + NW - 1, after the reader has taken the old value, so one
    // slot per row is enough.
    int* carry_h = reinterpret_cast<int*>(rows + L);
    int* carry_r = carry_h + L + 1;

    stage_rows(rows, rdc, penc, scpc, len, n_pen, rf_ext, threadIdx.x,
               32 * NW);
    if constexpr (TILED) {
        if (threadIdx.x == 0) carry_h[0] = 0;
    }
    // Clipping the whole read is every thread's starting value, in a
    // register of its own: folded as -scp_tot into the last three-way max
    // instead, nvcc 12.9 emitted VIMNMX3 on +scp_tot.
    int best = -scp_tot;
    const int ntiles = TILED ? W / CAP + 1 : 1;     // ceil((W + 1) / CAP)
    for (int tile = 0; tile < ntiles; ++tile) {
        const bool first = lane == 0 && warp == 0 && tile == 0;
        const bool lead = TILED && lane == 0 && warp == 0 && tile > 0;
        const bool tail = TILED && last && warp == NW - 1;
        Cols<CPL> col;
        cols_init<CPL, OV>(col, ref + (size_t)c * W,
                           OV ? ov + (size_t)c * W : nullptr,
                           tile * CAP + threadIdx.x * CPL, W, rd_open, rd_ext);
        if (last) hedge[warp][0] = col.H[CPL - 1];
        __syncthreads();

        const int steps = len > 0 ? len + NW - 1 : 0;
        for (int t = 0; t < steps; ++t) {
            const int i = t - warp;     // this warp's row at this step
            if (i >= 0 && i < len) {    // uniform per warp
                const RowK r = staged_row(rows, i);
                const unsigned o1 = (i & 1) << 2;   // byte offsets of slots
                const unsigned o3 = (i & 3) << 2;
                int hleft = __shfl_up_sync(kFull, col.H[CPL - 1], 1);
                int pin = kNeg;         // run prefix of the columns left
                if (edge) { hleft = lds(hedge_in + o3); pin = lds(pfx_in + o1); }
                if constexpr (TILED) {
                    if (lead) { hleft = carry_h[i]; pin = carry_r[i]; }
                }
                int G[CPL], M[CPL];
                const int run = fill_g<CPL, OV>(col, G, M, hleft, r, sm, sn,
                                                cf, first, pin);
                const int tot = warp_scan_max(run);
                if (last) sts(pfx_out + o1, tot);
                int excl = __shfl_up_sync(kFull, tot, 1);
                if (lane == 0) excl = pin;
                const int rowmax = fill_h(col, G, M, excl, r.clipx);
                // 3' soft clip: end the alignment after read position i + 1
                best = addmax(rowmax, -r.clipx - scp_tot, best);
                if (last) sts(hedge_out + ((o3 + 4) & 12), col.H[CPL - 1]);
                if constexpr (TILED) {
                    if (tail) { carry_h[i + 1] = col.H[CPL - 1]; carry_r[i] = tot; }
                }
            }
            __syncthreads();
        }
        best = max(best, col_max(col) - len * rf_ext);
    }
    best = __reduce_max_sync(kFull, best);
    if (lane == 0) wbest[warp] = best;
    __syncthreads();
    if (threadIdx.x == 0) {
        int b = wbest[0];
#pragma unroll
        for (int w = 1; w < NW; ++w) b = max(b, wbest[w]);
        out[c] = b;
    }
}

struct Args {
    const int32_t *rd, *pen, *rdlens, *ref, *scp_cum, *ov;
    int32_t* out;
    int C, L, W, mb, np, ro, re, fo, fe;
    cudaStream_t stream;
};

// Dynamic shared memory above 48 KB has to be asked for; the card gives
// a block at most 227 KB.
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemMax = 227 * 1024;

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes)
{
    if (bytes <= kSmemDefault) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int CPL, bool OV>
cudaError_t launch(const Args& a)
{
    const dim3 block(32 * kWarpsPerBlock);
    const dim3 grid((a.C + kWarpsPerBlock - 1) / kWarpsPerBlock);
    const size_t smem = (size_t)kWarpsPerBlock * a.L * sizeof(int4);
    const cudaError_t err = allow_smem(dp_score_kernel<CPL, OV>, smem);
    if (err != cudaSuccess) return err;
    dp_score_kernel<CPL, OV><<<grid, block, smem, a.stream>>>(
        a.rd, a.pen, a.rdlens, a.ref, a.scp_cum, a.ov, a.out, a.C, a.L, a.W,
        a.mb, a.np, a.ro, a.re, a.fo, a.fe);
    return cudaGetLastError();
}

template <int CPL, bool OV, bool TILED>
cudaError_t launch_wide(const Args& a)
{
    const size_t smem = (size_t)a.L * sizeof(int4)
        + (TILED ? (2 * (size_t)a.L + 1) * sizeof(int) : 0);
    const auto kernel = dp_score_wide_kernel<CPL, OV, TILED>;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<a.C, 32 * kWideWarps, smem, a.stream>>>(
        a.rd, a.pen, a.rdlens, a.ref, a.scp_cum, a.ov, a.out, a.L, a.W, a.mb,
        a.np, a.ro, a.re, a.fo, a.fe);
    return cudaGetLastError();
}

// Which one-block variants this file compiles, with and without the
// overlay: every CPL of 3..16 in one pass, the column-tiled form at every
// fourth CPL (ops/dp_cuda.TILE_CPLS). None spills (nvcc 12.9.86).
constexpr bool wide_compiled(int cpl, bool tiled)
{
    return cpl >= 3 && cpl <= 16 && (!tiled || cpl % 4 == 0);
}

template <bool OV, bool TILED, int K = 16>
cudaError_t launch_wide_cpl(const Args& a, int cpl)
{
    if constexpr (K < 3) {
        return cudaErrorInvalidValue;
    } else {
        if (cpl == K) {
            if constexpr (wide_compiled(K, TILED))
                return launch_wide<K, OV, TILED>(a);
            else
                return cudaErrorInvalidValue;
        }
        return launch_wide_cpl<OV, TILED, K - 1>(a, cpl);
    }
}

}  // namespace

// 1 if the cell update was built on the fused add-max and three-way-max
// intrinsics, 0 if on their plain two-instruction forms.
extern "C" int dp_score_fused_form() { return DP_FUSED; }

// Plain C entry point. Pointers are device pointers to contiguous int32
// arrays: rd, pen (C, L); rdlens (C,); ref (C, W); scp_cum (C, L+1);
// out (C,); ov (C, W) SNV-overlay nibbles, or null for the
// instantiations without the overlay. The plan names the kernel: warps =
// 1 is the one-warp kernel with cpl columns per lane, warps = 4 the
// one-block kernel, in column tiles where `tiled` is 1. A plan this file
// did not compile, an untiled one that covers fewer than W + 1 columns,
// or a read too long for the staged rows is refused with
// cudaErrorInvalidValue. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int dp_score_launch(const void* rd, const void* pen,
                               const void* rdlens, const void* ref,
                               const void* scp_cum, const void* ov,
                               void* out, int C, int L, int W,
                               int match_bonus, int n_pen,
                               int rd_open, int rd_ext,
                               int rf_open, int rf_ext,
                               int warps, int cpl, int tiled, void* stream)
{
    const Args a{static_cast<const int32_t*>(rd),
                 static_cast<const int32_t*>(pen),
                 static_cast<const int32_t*>(rdlens),
                 static_cast<const int32_t*>(ref),
                 static_cast<const int32_t*>(scp_cum),
                 static_cast<const int32_t*>(ov),
                 static_cast<int32_t*>(out),
                 C, L, W, match_bonus, n_pen, rd_open, rd_ext, rf_open,
                 rf_ext, static_cast<cudaStream_t>(stream)};
    const int invalid = static_cast<int>(cudaErrorInvalidValue);
    if (W < 0 || L < 0 || warps < 1 || cpl < 1 || (tiled && warps == 1) ||
        (!tiled && (long long)32 * warps * cpl < (long long)W + 1))
        return invalid;
    const size_t smem = warps == 1
        ? (size_t)kWarpsPerBlock * L * sizeof(int4)
        : (size_t)L * sizeof(int4) + (tiled ? (2 * (size_t)L + 1) * 4 : 0);
    if (smem > kSmemMax)
        return invalid;
#define DP_NARROW(K) case K: return static_cast<int>( \
        a.ov ? launch<K, true>(a) : launch<K, false>(a));
    if (warps == 1) {
        switch (cpl) {
            DP_NARROW(1) DP_NARROW(2) DP_NARROW(3) DP_NARROW(4)
            DP_NARROW(5) DP_NARROW(6) DP_NARROW(7) DP_NARROW(8)
            default: return invalid;
        }
    }
#undef DP_NARROW
    if (warps != kWideWarps)
        return invalid;
    const cudaError_t err = a.ov
        ? (tiled ? launch_wide_cpl<true, true>(a, cpl)
                 : launch_wide_cpl<true, false>(a, cpl))
        : (tiled ? launch_wide_cpl<false, true>(a, cpl)
                 : launch_wide_cpl<false, false>(a, cpl));
    return static_cast<int>(err);
}
