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
// What bounds it on the card: operations, not bytes. On the main path
// one launch fills 8192 candidates x 100 real read rows x 137 columns,
// about 112 M cells at roughly 20 int32 operations each; its inputs are
// about 14 MB (read, penalty, clip prefix, window: 4-byte codes). The
// paired-end mate rescue fills 512 candidates x 100 rows x 1105 columns,
// about 57 M cells, from about 2.7 MB of inputs.
//
// Design, windows of up to 256 columns (the SE path): one warp per
// candidate. The W+1 window columns lie in contiguous runs of
// CPL = ceil((W+1)/32) columns per lane, H and F in registers. A loop over
// read rows; the row's diagonal neighbour crosses lanes with
// __shfl_up_sync, the cummax is a per-lane scan followed by a
// warp-shuffle inclusive scan, and the row maximum a warp reduction.
// Read char, penalty and clip prefix of row i are read once per warp
// (one broadcast address). All DP state stays in registers, so device
// memory sees each input once and the per-cell integer work is what is
// left to bound the kernel; a read's loop ends at its own length.
//
// Design, wider windows (the paired-end mate rescue: W = maxins + L, 1104
// at the defaults, C = 512 candidates): one warp per candidate would need
// 35 columns per lane, six arrays of them in registers, and would spill;
// and 512 warps leave most of 132 SMs idle. So one block of kWideWarps
// warps takes one candidate, with CPL = ceil((W+1)/256) <= 8 columns per
// lane. Per row, each warp runs the one-warp scheme on its own columns;
// two values cross warps through shared memory: each warp's inclusive
// running-max total (its successors' exclusive prefix) and its last
// column's H (the next row's diagonal neighbour of the next warp's first
// column), with one barrier after each. The 3' clip maximum needs no
// barrier: the row's clip cost is the same for every column, so each
// thread keeps max over rows of (its own row maximum - that cost) and the
// block reduces once at the end.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 28);
constexpr int kWarpsPerBlock = 4;
constexpr int kWideWarps = 8;
constexpr int kMaxCpl = 8;
constexpr unsigned kFull = 0xffffffffu;

template <int CPL>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
dp_score_kernel(const int32_t* __restrict__ rd,
                const int32_t* __restrict__ pen,
                const int32_t* __restrict__ rdlens,
                const int32_t* __restrict__ ref,
                const int32_t* __restrict__ scp_cum,
                int32_t* __restrict__ out,
                int C, int L, int W, int match_bonus, int n_pen,
                int rd_open, int rd_ext, int rf_open, int rf_ext)
{
    const int lane = threadIdx.x & 31;
    const int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (c >= C) return;                 // uniform per warp
    const int32_t* rdc = rd + (size_t)c * L;
    const int32_t* penc = pen + (size_t)c * L;
    const int32_t* scpc = scp_cum + (size_t)c * (L + 1);
    const int len = min(max(rdlens[c], 0), L);
    const int scp_tot = scpc[L];
    const int j0 = lane * CPL;

    int H[CPL], F[CPL], rf[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
        const int j = j0 + k;
        H[k] = (j <= W) ? 0 : kNeg;     // free leading reference gap
        F[k] = kNeg;
        rf[k] = (j >= 1 && j <= W) ? ref[(size_t)c * W + j - 1] : 4;
    }
    int best = -scp_tot;                // fully clipped read

    for (int i = 0; i < len; ++i) {
        const int rc = rdc[i];
        const int pc = penc[i];
        const int clip = -scpc[i + 1];
        const int col0 = -(rf_open + i * rf_ext);
        // previous row's H at this lane's first column - 1
        const int hleft = __shfl_up_sync(kFull, H[CPL - 1], 1);
        int G[CPL], Fn[CPL], M[CPL];
        int run = kNeg;
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
            const int j = j0 + k;
            const int hdiag = (k == 0) ? hleft : H[k - 1];
            const bool isn = (rc >= 4) || (rf[k] >= 4);
            const bool mm = (rc != rf[k]) && !isn;
            const int s = mm ? -pc : (isn ? -n_pen : match_bonus);
            int fn = max(H[k] - rf_open, F[k] - rf_ext);
            int g = max(hdiag + s, fn);
            if (j == 0) { g = col0; fn = col0; }
            if (j > W) { g = kNeg; fn = kNeg; }
            G[k] = g;
            Fn[k] = fn;
            run = max(run, g + rd_ext * j);
            M[k] = run;
        }
        // exclusive prefix max of the lane totals: M over all columns
        // left of this lane
        int tot = run;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int v = __shfl_up_sync(kFull, tot, d);
            if (lane >= d) tot = max(tot, v);
        }
        int excl = __shfl_up_sync(kFull, tot, 1);
        if (lane == 0) excl = kNeg;
        int rowmax = kNeg;
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
            const int j = j0 + k;
            const int mprev = (k == 0) ? excl : max(excl, M[k - 1]);
            int h = max(G[k], mprev - rd_open - rd_ext * (j - 1));
            if (j == 0) h = col0;
            h = max(h, clip);           // 5' soft clip floor
            if (j > W) h = kNeg;
            H[k] = h;
            F[k] = Fn[k];
            rowmax = max(rowmax, h);
        }
        rowmax = __reduce_max_sync(kFull, rowmax);
        // 3' soft clip: end the alignment after read position i+1
        best = max(best, rowmax - (scp_tot + clip));
    }
    int hmax = kNeg;
#pragma unroll
    for (int k = 0; k < CPL; ++k) hmax = max(hmax, H[k]);
    hmax = __reduce_max_sync(kFull, hmax);
    if (lane == 0) out[c] = max(best, hmax);
}

template <int CPL>
__global__ void __launch_bounds__(32 * kWideWarps)
dp_score_wide_kernel(const int32_t* __restrict__ rd,
                     const int32_t* __restrict__ pen,
                     const int32_t* __restrict__ rdlens,
                     const int32_t* __restrict__ ref,
                     const int32_t* __restrict__ scp_cum,
                     int32_t* __restrict__ out,
                     int L, int W, int match_bonus, int n_pen,
                     int rd_open, int rd_ext, int rf_open, int rf_ext)
{
    __shared__ int wtot[kWideWarps];    // each warp's inclusive run total
    __shared__ int hedge[kWideWarps];   // each warp's last column's H
    __shared__ int wbest[kWideWarps];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int c = blockIdx.x;
    const int32_t* rdc = rd + (size_t)c * L;
    const int32_t* penc = pen + (size_t)c * L;
    const int32_t* scpc = scp_cum + (size_t)c * (L + 1);
    const int len = min(max(rdlens[c], 0), L);
    const int scp_tot = scpc[L];
    const int j0 = threadIdx.x * CPL;

    int H[CPL], F[CPL], rf[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
        const int j = j0 + k;
        H[k] = (j <= W) ? 0 : kNeg;     // free leading reference gap
        F[k] = kNeg;
        rf[k] = (j >= 1 && j <= W) ? ref[(size_t)c * W + j - 1] : 4;
    }
    int best = -scp_tot;                // fully clipped read
    if (lane == 31) hedge[warp] = H[CPL - 1];
    __syncthreads();

    for (int i = 0; i < len; ++i) {
        const int rc = rdc[i];
        const int pc = penc[i];
        const int clip = -scpc[i + 1];
        const int col0 = -(rf_open + i * rf_ext);
        // previous row's H at this thread's first column - 1: the lane
        // below, or for lane 0 the previous warp's last column (unused by
        // thread 0, whose first column is j = 0)
        int hleft = __shfl_up_sync(kFull, H[CPL - 1], 1);
        if (lane == 0 && warp > 0) hleft = hedge[warp - 1];
        int G[CPL], Fn[CPL], M[CPL];
        int run = kNeg;
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
            const int j = j0 + k;
            const int hdiag = (k == 0) ? hleft : H[k - 1];
            const bool isn = (rc >= 4) || (rf[k] >= 4);
            const bool mm = (rc != rf[k]) && !isn;
            const int s = mm ? -pc : (isn ? -n_pen : match_bonus);
            int fn = max(H[k] - rf_open, F[k] - rf_ext);
            int g = max(hdiag + s, fn);
            if (j == 0) { g = col0; fn = col0; }
            if (j > W) { g = kNeg; fn = kNeg; }
            G[k] = g;
            Fn[k] = fn;
            run = max(run, g + rd_ext * j);
            M[k] = run;
        }
        int tot = run;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int v = __shfl_up_sync(kFull, tot, d);
            if (lane >= d) tot = max(tot, v);
        }
        if (lane == 31) wtot[warp] = tot;
        __syncthreads();
        // exclusive prefix max of every thread total left of this thread
        int excl = __shfl_up_sync(kFull, tot, 1);
        if (lane == 0) excl = kNeg;
        for (int w = 0; w < warp; ++w) excl = max(excl, wtot[w]);
        int rowmax = kNeg;
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
            const int j = j0 + k;
            const int mprev = (k == 0) ? excl : max(excl, M[k - 1]);
            int h = max(G[k], mprev - rd_open - rd_ext * (j - 1));
            if (j == 0) h = col0;
            h = max(h, clip);           // 5' soft clip floor
            if (j > W) h = kNeg;
            H[k] = h;
            F[k] = Fn[k];
            rowmax = max(rowmax, h);
        }
        // 3' soft clip: end the alignment after read position i+1
        best = max(best, rowmax - (scp_tot + clip));
        if (lane == 31) hedge[warp] = H[CPL - 1];
        __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < CPL; ++k) best = max(best, H[k]);
    best = __reduce_max_sync(kFull, best);
    if (lane == 0) wbest[warp] = best;
    __syncthreads();
    if (threadIdx.x == 0) {
        int b = wbest[0];
        for (int w = 1; w < kWideWarps; ++w) b = max(b, wbest[w]);
        out[c] = b;
    }
}

template <int CPL>
void launch(const int32_t* rd, const int32_t* pen, const int32_t* rdlens,
            const int32_t* ref, const int32_t* scp_cum, int32_t* out,
            int C, int L, int W, int mb, int np, int ro, int re, int fo,
            int fe, cudaStream_t stream)
{
    const dim3 block(32 * kWarpsPerBlock);
    const dim3 grid((C + kWarpsPerBlock - 1) / kWarpsPerBlock);
    dp_score_kernel<CPL><<<grid, block, 0, stream>>>(
        rd, pen, rdlens, ref, scp_cum, out, C, L, W, mb, np, ro, re, fo, fe);
}

template <int CPL>
void launch_wide(const int32_t* rd, const int32_t* pen, const int32_t* rdlens,
                 const int32_t* ref, const int32_t* scp_cum, int32_t* out,
                 int C, int L, int W, int mb, int np, int ro, int re, int fo,
                 int fe, cudaStream_t stream)
{
    dp_score_wide_kernel<CPL><<<C, 32 * kWideWarps, 0, stream>>>(
        rd, pen, rdlens, ref, scp_cum, out, L, W, mb, np, ro, re, fo, fe);
}

}  // namespace

// Widest window of the one-warp kernel: W + 1 <= 32 * kMaxCpl columns;
// wider windows go to the block kernel.
extern "C" int dp_score_warp_max_cols() { return 32 * kMaxCpl; }

// Largest window either kernel takes: W + 1 <= 32 * kWideWarps * kMaxCpl.
extern "C" int dp_score_max_cols() { return 32 * kWideWarps * kMaxCpl; }

// Plain C entry point. Pointers are device pointers to contiguous int32
// arrays: rd, pen (C, L); rdlens (C,); ref (C, W); scp_cum (C, L+1);
// out (C,). Launches on `stream` and returns cudaGetLastError().
extern "C" int dp_score_launch(const void* rd, const void* pen,
                               const void* rdlens, const void* ref,
                               const void* scp_cum, void* out,
                               int C, int L, int W,
                               int match_bonus, int n_pen,
                               int rd_open, int rd_ext,
                               int rf_open, int rf_ext, void* stream)
{
    const auto* a = static_cast<const int32_t*>(rd);
    const auto* p = static_cast<const int32_t*>(pen);
    const auto* n = static_cast<const int32_t*>(rdlens);
    const auto* r = static_cast<const int32_t*>(ref);
    const auto* s = static_cast<const int32_t*>(scp_cum);
    auto* o = static_cast<int32_t*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    if (W < 0 || W + 1 > dp_score_max_cols())
        return static_cast<int>(cudaErrorInvalidValue);
    const bool wide = W + 1 > dp_score_warp_max_cols();
    const int cpl = wide ? (W + 1 + 32 * kWideWarps - 1) / (32 * kWideWarps)
                         : (W + 1 + 31) / 32;
#define DP_CASE(LAUNCH, K)                                                \
    case K:                                                               \
        LAUNCH<K>(a, p, n, r, s, o, C, L, W, match_bonus, n_pen, rd_open, \
                  rd_ext, rf_open, rf_ext, st);                           \
        break;
    if (wide) {
        switch (cpl) {                  // W + 1 > 256: cpl >= 2
            DP_CASE(launch_wide, 2) DP_CASE(launch_wide, 3)
            DP_CASE(launch_wide, 4) DP_CASE(launch_wide, 5)
            DP_CASE(launch_wide, 6) DP_CASE(launch_wide, 7)
            DP_CASE(launch_wide, 8)
            default:
                return static_cast<int>(cudaErrorInvalidValue);
        }
    } else {
        switch (cpl) {
            DP_CASE(launch, 1) DP_CASE(launch, 2) DP_CASE(launch, 3)
            DP_CASE(launch, 4) DP_CASE(launch, 5) DP_CASE(launch, 6)
            DP_CASE(launch, 7) DP_CASE(launch, 8)
            default:
                return static_cast<int>(cudaErrorInvalidValue);
        }
    }
#undef DP_CASE
    return static_cast<int>(cudaGetLastError());
}
