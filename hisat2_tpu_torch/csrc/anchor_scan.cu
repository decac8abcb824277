// Anchor scan of the spliced path, for NVIDIA Hopper (sm_90a).
//
// Replaces the plain XLA scan of hisat2_tpu/ops/splice.py:anchor_scan
// (line 779; the JAX package has no Pallas kernel there) and the plain
// PyTorch core it was ported to, hisat2_tpu_torch/ops/splice.py:
// anchor_scan_plain_core, which stays as the CPU path and the oracle.
// It computes the core's result exactly: for each scan row (a seeded
// diagonal whose far exon's anchor was too short to seed), the first NC
// words, nearest first, of up to `tiles` windows of W characters next to
// the diagonal in which the read's far-end 8-mer (a 16-bit code) occurs,
// as (kvalid (S, NC) bool, mpos (S, NC) int32).
//
// The windows, as the plain version addresses them. Tile t of a down row
// (the seeded exon upstream; the anchor is the read's last 8 bases)
// starts at pos + min_intron + rdlen - 8 + t * W characters, of an up row
// at pos - min_intron - (t + 1) * W (int32 arithmetic, wrapping as
// torch's does). The start is clamped at 0 (up scans off the genome's
// start), its word is base = start >> 4, and word j (0 <= j <= W / 16) of
// the window is text_rows[min(r0 + (base % 16 + j) / 16, rows - 1)]
// [(base % 16 + j) % 16] with r0 = min(base / 16, rows - 1): rows past
// the text's end read its last row again. The 16 characters of word j
// and the first 8 of word j + 1 hold the 16 8-mers that start in word j;
// shift s (0..15) is the one at bits 2s..2s+15 of that 48-bit pair. A
// word is a hit when some shift equals the anchor code; its position is
// mpos = 16 * base + 16 * j + s, with s the first matching shift for a
// down row and the last for an up row.
//
// The order, and the padding rule the plain version implies. The plain
// core ranks a tile's words by a key, -(t * W/16 + d) for a hit at
// distance d (d = j for a down row, W/16 - 1 - j for an up row) and
// -2^30 for a miss, takes the NC largest with a stable sort (ties keep
// ascending word order) and merges the tiles' lists nearest first by
// the same stable sort. Every hit's key is at least -8 * 4096 > -2^30,
// so a row's entries are its hits over the tiles, nearest first, up to
// NC; the entries left over are tile 0's lowest-index words without a
// hit, in ascending order, with kvalid false and mpos = 16 * base + 16 *
// j + 0 (down) or + 15 (up): the first shift of an all-false match row
// for a down row, the last for an up row. The result tensor is compared
// whole, so those positions are reproduced too. (W / 16 >= NC keeps
// enough such words in tile 0: a row pads only when tile 0 holds fewer
// than NC hits.)
//
// The deeper tiles. The plain core takes tiles 1 .. tiles-1 for every row
// exactly when some row that is live (or `live` absent), has no N in its
// anchor and a read long enough (has_n false) found nothing in tile 0;
// else every row keeps its tile-0 result. Two launches on the stream,
// with no host synchronisation between them: anchor_scan_tile0 scans tile
// 0, writes every row's hits and padding and its hit count, and sets a
// device flag when such a row found nothing; anchor_scan_deep is queued
// always and returns at once when the flag is 0; otherwise each row with
// fewer than NC tile-0 hits walks tiles 1, 2, ... nearest first until it
// holds NC, moves its padding entries up behind the new hits (a warp
// shuffle), and block 0 adds one to a device counter of calls that took
// the branch (read only by measurements and tests).
//
// The design. One warp a scan row, W = 65536 (4,096 words a tile) on
// every caller. The lanes take consecutive words in nearest order
// (ascending for a down row, descending for an up row), kWordsPerLane a
// pass for loads in flight; each lane tests its word's 16 shifts in
// registers (hit_mask: two shifts a funnel shift of the word pair) into a
// 16-bit match mask; __ballot_sync gives the words with a hit in nearest order,
// the lanes of the first hits write their entries, and the warp stops
// when it holds NC. Nothing is staged in shared memory; each word is read
// once by its lane and once more (from L1) as the next word's upper half.
//
// What bounds it on the card: operations. A batch of 16,384 RNA reads
// scans 5,120 rows (10,240 for 16,384 pairs) over up to 8 tiles of 4,096
// words, 16 window tests a word; the text it reads is the genome's packed
// words, 8 bytes for 16 bases, and the rows share it (4.6 Mbp is 2.3 MB).
// ANCHOR_OPS_PER_TEST (chip_smoke.py) counts 2 integer instructions a
// window test, four for the two tests of one funnel shift (hit_mask):
// the shift, the XOR with the code, the subtraction of 0x00010001 and the
// three-input OR-AND-NOT; the word loads, the ballot, the loop and the
// exact mask of a word with a hit come on top.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;    // scan rows a block
constexpr int kWordsPerLane = 4;     // words a lane tests in one pass
constexpr int kMaxNC = 32;           // entries a row: at most one a lane
constexpr unsigned kFull = 0xffffffffu;

struct Args {
    const long long* text;   // (rows, 16) words, uint32 values in int64
    long long rows;
    const int32_t* pos;      // (S,) seeded diagonals
    const uint8_t* down;     // (S,) bool
    const int32_t* rdlens;   // (S,)
    const int32_t* acode;    // (S,) the anchor's 16-bit code
    const uint8_t* has_n;    // (S,) bool: N in the anchor, or read too short
    const uint8_t* live;     // (S,) bool, or null: every row live
    int S, mi, W, A, NC, tiles;
    uint8_t* kvalid;         // (S, NC) bool
    int32_t* mpos;           // (S, NC)
    int32_t* counts;         // (S,) hits a row holds after tile 0
    int32_t* flag;           // (1,) some live row without N missed tile 0
    unsigned long long* deep_calls;   // (1,) calls that took the branch
};

// One tile's window of one row.
struct Win {
    unsigned base;    // first word: the clamped start >> 4
    long long r0;     // first text row, clamped to the last
    int woff;         // word of the window's start within row r0
};

__device__ __forceinline__ Win window(int pos, bool down, int rdlen,
                                      const Args& a, int t)
{
    // int32 arithmetic that wraps, as the plain version's does
    const unsigned ws = down
        ? (unsigned)pos + (unsigned)a.mi + (unsigned)rdlen - (unsigned)a.A
              + (unsigned)t * (unsigned)a.W
        : (unsigned)pos - (unsigned)a.mi - (unsigned)(t + 1) * (unsigned)a.W;
    const int wsc = (int)ws < 0 ? 0 : (int)ws;
    Win w;
    w.base = (unsigned)wsc >> 4;
    const long long r0 = (long long)(w.base >> 4);
    w.r0 = r0 < a.rows - 1 ? r0 : a.rows - 1;
    w.woff = (int)(w.base & 15u);
    return w;
}

// Word j (0 <= j <= W / 16) of the window.
__device__ __forceinline__ unsigned word_at(const Args& a, const Win& w,
                                            int j)
{
    const int jj = w.woff + j;
    long long r = w.r0 + (jj >> 4);
    r = r < a.rows - 1 ? r : a.rows - 1;
    return (unsigned)__ldg(a.text + r * 16 + (jj & 15));
}

// Bit s set where the 8-mer at shift s of word j equals the code. The
// test of all 16 shifts: one funnel shift of the word pair brings shift
// s into the low half and shift s + 8 into the high half, so eight shifts
// test sixteen 8-mers, two in each 32-bit XOR d with the code in both
// halves. Bit 15 of (d - 0x00010001) & ~d is set exactly when the low
// half of d is zero, bit 31 when the high half is, or when the low half
// was zero and its borrow reached the high half: a false bit only in a
// word that has a hit already. One OR over the eight collects them, so
// the word has a hit exactly when bit 15 or 31 is set; only such a word,
// one in some 4,096, builds its mask shift by shift.
__device__ __forceinline__ unsigned hit_mask(const Args& a, const Win& w,
                                             int j, unsigned code)
{
    const unsigned lo = word_at(a, w, j);
    const unsigned hi = word_at(a, w, j + 1);
    const unsigned code2 = code | (code << 16);
    unsigned zero = 0u;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
        const unsigned d = __funnelshift_r(lo, hi, 2 * s) ^ code2;
        zero |= (d - 0x00010001u) & ~d;
    }
    if ((zero & 0x80008000u) == 0u)
        return 0u;
    unsigned m = 0;
    for (int s = 0; s < 16; ++s) {
        const unsigned v = __funnelshift_r(lo, hi, 2 * s);
        m |= (unsigned)(((v ^ code) & 0xFFFFu) == 0u) << s;
    }
    return m;
}

// Appends tile w's hits, nearest first, to the row's slots [count, NC);
// returns the new count (at most NC).
__device__ int scan_tile(const Args& a, const Win& w, bool down,
                         unsigned code, int count, int32_t* mp,
                         uint8_t* kv, int lane)
{
    const int NW = a.W >> 4;
    const unsigned below = (1u << lane) - 1u;
    for (int c0 = 0; c0 < NW && count < a.NC; c0 += 32 * kWordsPerLane) {
        unsigned mask[kWordsPerLane];
#pragma unroll
        for (int k = 0; k < kWordsPerLane; ++k) {
            const int n = c0 + 32 * k + lane;      // distance order
            mask[k] = n < NW ? hit_mask(a, w, down ? n : NW - 1 - n, code)
                             : 0u;
        }
#pragma unroll
        for (int k = 0; k < kWordsPerLane; ++k) {
            const unsigned b = __ballot_sync(kFull, mask[k] != 0u);
            if (b == 0u || count >= a.NC)
                continue;
            const int slot = count + __popc(b & below);
            if (mask[k] != 0u && slot < a.NC) {
                const int n = c0 + 32 * k + lane;
                const unsigned j = (unsigned)(down ? n : NW - 1 - n);
                const unsigned s = down ? (unsigned)(__ffs(mask[k]) - 1)
                                        : (unsigned)(31 - __clz(mask[k]));
                mp[slot] = (int32_t)((w.base << 4) + 16u * j + s);
                kv[slot] = 1;
            }
            count += __popc(b);
        }
    }
    return count < a.NC ? count : a.NC;
}

// Slots [count, NC): tile 0's lowest-index words without a hit, in
// ascending order (the plain version's padding rule, above).
__device__ void pad_tile0(const Args& a, const Win& w, bool down,
                          unsigned code, int count, int32_t* mp,
                          uint8_t* kv, int lane)
{
    const int NW = a.W >> 4;
    const unsigned below = (1u << lane) - 1u;
    for (int c0 = 0; c0 < NW && count < a.NC; c0 += 32) {
        const int j = c0 + lane;
        const bool miss = j < NW && hit_mask(a, w, j, code) == 0u;
        const unsigned b = __ballot_sync(kFull, miss);
        const int slot = count + __popc(b & below);
        if (miss && slot < a.NC) {
            mp[slot] = (int32_t)((w.base << 4) + 16u * (unsigned)j
                                 + (down ? 0u : 15u));
            kv[slot] = 0;
        }
        count += __popc(b);
    }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
anchor_scan_tile0(const Args a)
{
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (row >= a.S)
        return;                                   // the whole warp
    const bool down = a.down[row] != 0;
    const unsigned code = (unsigned)a.acode[row];
    int32_t* mp = a.mpos + (long long)row * a.NC;
    uint8_t* kv = a.kvalid + (long long)row * a.NC;
    const Win w = window(a.pos[row], down, a.rdlens[row], a, 0);
    const int count = scan_tile(a, w, down, code, 0, mp, kv, lane);
    pad_tile0(a, w, down, code, count, mp, kv, lane);
    if (lane == 0) {
        a.counts[row] = count;
        if (count == 0 && !a.has_n[row] && (a.live == nullptr || a.live[row]))
            *a.flag = 1;
    }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
anchor_scan_deep(const Args a)
{
    if (*a.flag == 0)
        return;                 // every live row resolved in tile 0
    if (blockIdx.x == 0 && threadIdx.x == 0)
        atomicAdd(a.deep_calls, 1ull);
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    if (row >= a.S)
        return;
    const int count0 = a.counts[row];
    if (count0 >= a.NC)
        return;
    const bool down = a.down[row] != 0;
    const unsigned code = (unsigned)a.acode[row];
    int32_t* mp = a.mpos + (long long)row * a.NC;
    uint8_t* kv = a.kvalid + (long long)row * a.NC;
    // lane i holds slot i: the padding entries from slot count0 on
    const int32_t old = lane < a.NC ? mp[lane] : 0;
    __syncwarp();               // read before any lane writes a hit
    int count = count0;
    for (int t = 1; t < a.tiles && count < a.NC; ++t)
        count = scan_tile(a, window(a.pos[row], down, a.rdlens[row], a, t),
                          down, code, count, mp, kv, lane);
    const int moved = count - count0;
    const int32_t pad = __shfl_up_sync(kFull, old, moved < 31 ? moved : 31);
    if (moved > 0 && lane >= count && lane < a.NC)
        mp[lane] = pad;         // kvalid there is still tile 0's false
}

}  // namespace

// Plain C entry point. Pointers are device pointers to contiguous arrays
// (shapes in Args); live may be null. deep = 0 launches the tile-0 kernel
// (after zeroing the flag on the stream), deep = 1 the deep kernel. Shapes
// the kernels do not serve (A != 8, W not a positive multiple of 16 with
// W / 16 >= NC, NC outside 1..32, tiles < 1, no text row, no scan row)
// are refused
// with cudaErrorInvalidValue. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int anchor_scan_launch(
    const void* text, long long rows, const void* pos, const void* down,
    const void* rdlens, const void* acode, const void* has_n,
    const void* live, int S, int mi, int W, int A, int NC, int tiles,
    void* kvalid, void* mpos, void* counts, void* flag, void* deep_calls,
    int deep, void* stream)
{
    if (A != 8 || W < 16 || W % 16 != 0 || NC < 1 || NC > kMaxNC ||
        W / 16 < NC || tiles < 1 || rows < 1 || S < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const Args a{static_cast<const long long*>(text), rows,
                 static_cast<const int32_t*>(pos),
                 static_cast<const uint8_t*>(down),
                 static_cast<const int32_t*>(rdlens),
                 static_cast<const int32_t*>(acode),
                 static_cast<const uint8_t*>(has_n),
                 static_cast<const uint8_t*>(live),
                 S, mi, W, A, NC, tiles,
                 static_cast<uint8_t*>(kvalid),
                 static_cast<int32_t*>(mpos),
                 static_cast<int32_t*>(counts),
                 static_cast<int32_t*>(flag),
                 static_cast<unsigned long long*>(deep_calls)};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid((S + kWarpsPerBlock - 1) / kWarpsPerBlock);
    if (deep) {
        anchor_scan_deep<<<grid, kWarpsPerBlock * 32, 0, st>>>(a);
    } else {
        const cudaError_t e = cudaMemsetAsync(flag, 0, sizeof(int32_t), st);
        if (e != cudaSuccess)
            return static_cast<int>(e);
        anchor_scan_tile0<<<grid, kWarpsPerBlock * 32, 0, st>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
}
