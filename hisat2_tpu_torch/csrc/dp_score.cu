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
// about 14 MB (read, penalty, clip prefix, window: 4-byte codes).
//
// Design: one warp per candidate. The W+1 window columns lie in
// contiguous runs of CPL = ceil((W+1)/32) columns per lane, H and F in
// registers. A loop over read rows; the row's diagonal neighbour crosses
// lanes with __shfl_up_sync, the cummax is a per-lane scan followed by a
// warp-shuffle inclusive scan, and the row maximum a warp reduction.
// Read char, penalty and clip prefix of row i are read once per warp
// (one broadcast address). All DP state stays in registers, so device
// memory sees each input once and the per-cell integer work is what is
// left to bound the kernel; a read's loop ends at its own length.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 28);
constexpr int kWarpsPerBlock = 4;
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

}  // namespace

// Largest window the kernel takes: W + 1 <= 32 * kMaxCpl columns.
extern "C" int dp_score_max_cols() { return 32 * 8; }

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
    switch ((W + 1 + 31) / 32) {
#define DP_CASE(K)                                                        \
    case K:                                                               \
        launch<K>(a, p, n, r, s, o, C, L, W, match_bonus, n_pen, rd_open, \
                  rd_ext, rf_open, rf_ext, st);                           \
        break;
        DP_CASE(1) DP_CASE(2) DP_CASE(3) DP_CASE(4)
        DP_CASE(5) DP_CASE(6) DP_CASE(7) DP_CASE(8)
#undef DP_CASE
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
