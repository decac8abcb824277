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
// the text's end read its last row again. As a flat word index f = base
// + j that is f itself below 16 * rows and 16 * (rows - 1) + f % 16 past
// it. The 16 characters of word j and the first 8 of word j + 1 hold the
// 16 8-mers that start in word j; shift s (0..15) is the one at bits
// 2s..2s+15 of that 48-bit pair. A word is a hit when some shift equals
// the anchor code; its position is mpos = 16 * base + 16 * j + s, with s
// the first matching shift for a down row and the last for an up row.
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
// holds NC, moves its padding entries up behind the new hits, and block
// 0 adds one to a device counter of calls that took the branch (read
// only by measurements and tests).
//
// The design: one block of 8 warps a scan row. A row walks its tiles
// nearest first in segments of kSegWords = 2,048 words (two a tile at W =
// 65,536); each warp scans a strip of kStripWords = 256 consecutive words
// of the segment, strips in distance order (warp 0 the nearest). A lane
// tests kWordsPerLane = 8 words of its strip, one from each of eight
// rounds of 32 consecutive words (a strip is one pass), so the pass's
// words are in distance order round by round and lane by lane; one vote
// finds the rare pass with a hit, and only there do ballots rank its
// hits. A warp keeps its strip's first NC hits in shared memory (a strip
// may hold more than NC while a nearer one holds some). After each
// segment one barrier (__syncthreads_or: a segment without a hit skips
// the merge); then every thread sums the strips' counts, thread 0 appends
// their hits in strip order to the row's list, and the row stops after
// the first segment that brings it to NC. A row tests at most the rest
// of one segment past its NC-th hit.
//
// What that does about the tail. The one-warp design before it ran S =
// 5,120 rows as one wave of 640 blocks on 660-792 slots, and its time was
// set by the rows that walk all 8 tiles (383 of 5,120 on phase 8's
// inputs), 1,024 words a lane on one warp. Here the longest row is 16
// segments of 8 words a lane, and the 5,120 to 10,240 one-row blocks
// spread over the SMs as blocks end instead of running as one fixed wave.
//
// The text is staged through shared memory: two segment buffers a block,
// each filled by one bulk copy (cp.async.bulk, the Tensor Memory
// Accelerator's plain form) that warp 0 issues when the buffer frees,
// so the next segment's copy flies while this one is scanned, completing
// on the buffer's mbarrier; warp 0 also records the segment's geometry
// beside it. Each text word comes from L2 once a row (the one-warp design
// read it once more from L1 as the next word's upper half), the window
// and row-index arithmetic and the clamp at the last row leave the inner
// loop, and a lane reads the low halves of its word and the next from
// shared memory (two 32-bit loads, consecutive lanes 8 bytes apart: two
// wavefronts each). The copy starts at a 16-byte-aligned word, one before
// the segment where its first word is not, and rounds its size up to 16
// bytes; a segment whose copy would reach past the text's end (or start
// before it) is filled by warp 0 with plain loads under the clamp
// instead, and completes its mbarrier phase by hand. Tile 0's padding
// reads its few words from global memory, issued before the walk.
//
// What bounds it on the card: operations. A batch of 16,384 RNA reads
// scans 5,120 rows (10,240 for 16,384 pairs) over up to 8 tiles of 4,096
// words, 16 window tests a word; the text it reads is the genome's packed
// words, 8 bytes for 16 bases, and the rows share it (4.6 Mbp is 2.3 MB).
// ANCHOR_OPS_PER_TEST (chip_smoke.py) counts 2 integer instructions a
// window test, four for the two tests of one funnel shift (zero_flags):
// the shift, the XOR with the code, the subtraction of 0x00010001 and the
// three-input OR-AND-NOT; the two shared-memory loads a word, the vote,
// the exact mask of a word with a hit and the words past a row's NC-th
// hit in its last segment (5.8% more words than the inputs need on phase
// 8's) come on top. ptxas for sm_90a: 47 registers (tile 0) and 42
// (deep), 35,248 bytes of static shared memory, no spill: 5 blocks of 256
// threads an SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                        // warps a block, one row
constexpr int kThreads = kWarps * 32;
constexpr int kSegWords = 2048;                  // words a staged segment
constexpr int kStripWords = kSegWords / kWarps;  // a warp's strip of it
constexpr int kWordsPerLane = 8;                 // words a lane a pass
constexpr int kPassWords = 32 * kWordsPerLane;
constexpr int kStages = 2;                       // segment buffers a block
constexpr int kBufWords = kSegWords + 4;         // + alignment and hi word
constexpr int kMaxNC = 32;                       // entries a row
constexpr unsigned kFull = 0xffffffffu;

static_assert(kStripWords % kPassWords == 0, "a strip is whole passes");
static_assert((kBufWords * 8) % 16 == 0, "buffers stay 16-byte aligned");

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

// Segment q (nearest first) of a tile: window words [lo, lo + len), word
// lo at buffer word `off` of its stage.
struct SegInfo {
    unsigned base;    // the tile's first word
    int lo, len, off;
};

struct Smem {
    long long buf[kStages][kBufWords];       // staged segments
    SegInfo info[kStages];                   // which segment each holds
    unsigned long long bar[kStages];         // their mbarriers
    int32_t strip[2][kWarps][kMaxNC];        // a strip's first NC hits,
    int strip_n[2][kWarps];                  // by segment parity
    int32_t list[kMaxNC];                    // the row's entries
    int32_t pad[kMaxNC];                     // tile 0's (deep kernel)
};

// ---- mbarrier and bulk copy (PTX) -----------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p)
{
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* b)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem_u32(b)) : "memory");
}

__device__ __forceinline__ void bar_arrive(unsigned long long* b)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(smem_u32(b)) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* b,
                                         unsigned parity)
{
    asm volatile(
        "{\n\t.reg .pred P1;\n"
        "WAIT:\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
        "@P1 bra DONE;\n\t"
        "bra WAIT;\n"
        "DONE:\n\t}"
        :: "r"(smem_u32(b)), "r"(parity) : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on mbarrier b.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* b)
{
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_u32(b)), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                 "complete_tx::bytes [%0], [%1], %2, [%3];"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes),
                    "r"(smem_u32(b)) : "memory");
}

// ---- windows and segments -------------------------------------------

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

// Word j (0 <= j <= W / 16) of the window, from global memory.
__device__ __forceinline__ unsigned word_at(const Args& a, const Win& w,
                                            int j)
{
    const int jj = w.woff + j;
    long long r = w.r0 + (jj >> 4);
    r = r < a.rows - 1 ? r : a.rows - 1;
    return (unsigned)__ldg(a.text + r * 16 + (jj & 15));
}

__device__ __forceinline__ SegInfo segment(const Args& a, int pos,
                                           bool down, int rdlen, int t,
                                           int q)
{
    const int NW = a.W >> 4;
    SegInfo g;
    g.base = window(pos, down, rdlen, a, t).base;
    if (down) {
        g.lo = q * kSegWords;
        g.len = min(kSegWords, NW - g.lo);
    } else {
        const int hi = NW - q * kSegWords;
        g.lo = max(0, hi - kSegWords);
        g.len = hi - g.lo;
    }
    g.off = 0;
    return g;
}

// Fills a buffer with segment g's words lo .. lo + len (the last one the
// upper half of the last pair) and records the segment in info. One bulk
// copy takes the words from a 16-byte-aligned word on, word lo landing at
// buffer word `off` (0 or 1), its size rounded up to 16 bytes; where that
// range leaves the text, plain loads under the clamp fill the buffer from
// word lo at buffer word 0. Warp 0 calls it; the words are read after the
// block's next barrier.
__device__ void stage(const Args& a, SegInfo g, long long* buf,
                      unsigned long long* bar, SegInfo* info, int lane)
{
    const long long start = (long long)g.base + g.lo;   // flat word index
    const unsigned long long at =
        reinterpret_cast<unsigned long long>(a.text) + 8ull * start;
    const int off = (int)((at >> 3) & 1ull);
    const long long e0 = start - off;
    const long long n = (off + g.len + 2) & ~1ll;   // + the hi word, even
    const bool bulk = e0 >= 0 && e0 + n <= a.rows * 16;
    g.off = bulk ? off : 0;
    if (lane == 0)
        *info = g;
    if (bulk) {
        if (lane == 0)
            bulk_load(buf, a.text + e0, (unsigned)(8 * n), bar);
        return;
    }
    const long long r16 = a.rows * 16;
    for (int i = lane; i <= g.len; i += 32) {
        const long long f = start + i;
        buf[i] = __ldg(a.text + (f < r16 ? f : r16 - 16 + (f & 15)));
    }
    // the bulk copies that reuse this buffer later are ordered after
    // these writes; the mbarrier's phase completes by hand
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0)
        bar_arrive(bar);
}

// ---- the window test ------------------------------------------------

// Bit 15 or 31 set where some 8-mer of the word pair (lo, hi) equals the
// code: one funnel shift of the pair brings shift s into the low half and
// shift s + 8 into the high half, so eight shifts test sixteen 8-mers,
// two in each 32-bit XOR d with the code in both halves. Bit 15 of (d -
// 0x00010001) & ~d is set exactly when the low half of d is zero, bit 31
// when the high half is, or when the low half was zero and its borrow
// reached the high half: a false bit only in a word that has a hit
// already. One OR over the eight collects them.
__device__ __forceinline__ unsigned zero_flags(unsigned lo, unsigned hi,
                                               unsigned code2)
{
    unsigned zero = 0u;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
        const unsigned d = __funnelshift_r(lo, hi, 2 * s) ^ code2;
        zero |= (d - 0x00010001u) & ~d;
    }
    return zero & 0x80008000u;
}

// Bit s set where the 8-mer at shift s equals the code (a word with a
// hit, one in some 4,096, builds it shift by shift).
__device__ __forceinline__ unsigned shift_mask(unsigned lo, unsigned hi,
                                               unsigned code)
{
    unsigned m = 0;
    for (int s = 0; s < 16; ++s) {
        const unsigned v = __funnelshift_r(lo, hi, 2 * s);
        m |= (unsigned)(((v ^ code) & 0xFFFFu) == 0u) << s;
    }
    return m;
}

// A pass with a hit: ranks its hits in distance order (round by round,
// lane by lane) after the strip's n and writes those below NC to strip.
template <bool DOWN>
__device__ __forceinline__ int take_hits(const unsigned* w32,
                                         const SegInfo& g, unsigned code,
                                         const unsigned* flags, int c0,
                                         int n, int NC, int32_t* strip,
                                         int lane)
{
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int k = 0; k < kWordsPerLane; ++k) {
        const bool h = flags[k] != 0u;
        const unsigned b = __ballot_sync(kFull, h);
        if (b == 0u)
            continue;
        const int slot = n + __popc(b & below);
        if (h && slot < NC) {
            const int d = c0 + 32 * k + lane;
            const int x = DOWN ? d : g.len - 1 - d;
            const int i = g.off + x;
            const unsigned m = shift_mask(w32[2 * i], w32[2 * i + 2], code);
            const unsigned s = DOWN ? (unsigned)(__ffs(m) - 1)
                                    : (unsigned)(31 - __clz(m));
            strip[slot] = (int32_t)((g.base << 4)
                                    + 16u * (unsigned)(g.lo + x) + s);
        }
        n += __popc(b);
    }
    return n;
}

// This warp's strip of the staged segment: its first NC hits, nearest
// first, into strip; returns how many it holds (at most NC).
template <bool DOWN>
__device__ __forceinline__ int scan_strip(const long long* buf,
                                          const SegInfo& g, unsigned code,
                                          int NC, int32_t* strip, int warp,
                                          int lane)
{
    // the low half of buffer word i is 32-bit word 2i
    const unsigned* w32 = reinterpret_cast<const unsigned*>(buf);
    const unsigned code2 = code | (code << 16);
    const int d0 = warp * kStripWords;
    const int d1 = min(d0 + kStripWords, g.len);
    int n = 0;
    for (int c0 = d0; c0 < d1 && n < NC; c0 += kPassWords) {
        const bool whole = c0 + kPassWords <= d1;
        unsigned flags[kWordsPerLane];
        unsigned any = 0u;
#pragma unroll
        for (int k = 0; k < kWordsPerLane; ++k) {
            const int d = c0 + 32 * k + lane;
            const bool in = whole || d < d1;
            const int i = g.off + (in ? (DOWN ? d : g.len - 1 - d) : 0);
            flags[k] = in ? zero_flags(w32[2 * i], w32[2 * i + 2], code2)
                          : 0u;
            any |= flags[k];
        }
        if (__any_sync(kFull, any != 0u))
            n = take_hits<DOWN>(w32, g, code, flags, c0, n, NC, strip, lane);
    }
    return n < NC ? n : NC;
}

// Walks tiles [t0, t1) of a block's row nearest first, segment by
// segment, until the row holds NC entries; appends the hits to sm.list
// from `count` on and returns the new count. Every thread calls it; warp
// 0 stages segment u + kStages as soon as segment u has freed its buffer.
__device__ int walk(const Args& a, Smem& sm, int row, int t0, int t1,
                    int count)
{
    const int nseg = ((a.W >> 4) + kSegWords - 1) / kSegWords;
    const int total = (t1 - t0) * nseg;
    const bool down = a.down[row] != 0;
    const unsigned code = (unsigned)a.acode[row];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int issued = 0, pos = 0, rdlen = 0;
    if (warp == 0) {
        pos = a.pos[row];
        rdlen = a.rdlens[row];
        for (; issued < kStages && issued < total; ++issued) {
            const int st = issued % kStages;
            stage(a, segment(a, pos, down, rdlen, t0 + issued / nseg,
                             issued % nseg),
                  sm.buf[st], &sm.bar[st], &sm.info[st], lane);
        }
    }
    __syncthreads();              // plain-filled words visible
    int u = 0;
    for (; u < total && count < a.NC; ++u) {
        const int st = u % kStages, par = u & 1;
        bar_wait(&sm.bar[st], (unsigned)(u / kStages) & 1u);
        const SegInfo g = sm.info[st];
        const int n = down
            ? scan_strip<true>(sm.buf[st], g, code, a.NC,
                               sm.strip[par][warp], warp, lane)
            : scan_strip<false>(sm.buf[st], g, code, a.NC,
                                sm.strip[par][warp], warp, lane);
        if (lane == 0)
            sm.strip_n[par][warp] = n;
        // strips written, buffer st read; a segment without a hit skips
        // the merge
        if (__syncthreads_or(n > 0)) {
            int found = 0;
#pragma unroll
            for (int k = 0; k < kWarps; ++k)
                found += sm.strip_n[par][k];
            if (threadIdx.x == 0) {
                int c = count;
                for (int k = 0; k < kWarps && c < a.NC; ++k)
                    for (int i = 0; i < sm.strip_n[par][k] && c < a.NC; ++i)
                        sm.list[c++] = sm.strip[par][k][i];
            }
            count = min(a.NC, count + found);
        }
        if (warp == 0 && count < a.NC && issued < total) {
            stage(a, segment(a, pos, down, rdlen, t0 + issued / nseg,
                             issued % nseg),
                  sm.buf[st], &sm.bar[st], &sm.info[st], lane);
            ++issued;
        }
    }
    // a copy still in flight lands before the block may exit
    if (warp == 0)
        for (; u < issued; ++u)
            bar_wait(&sm.bar[u % kStages], (unsigned)(u / kStages) & 1u);
    return count;
}

__device__ __forceinline__ void init_bars(Smem& sm)
{
    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s)
            bar_init(&sm.bar[s]);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
}

// The misses among window words c0 .. c0 + 31 given each lane's word
// pair, as a ballot (one warp).
__device__ __forceinline__ unsigned miss_ballot(const Args& a, unsigned lo,
                                                unsigned hi, unsigned code2,
                                                int c0, int lane)
{
    return __ballot_sync(kFull, c0 + lane < (a.W >> 4) &&
                         zero_flags(lo, hi, code2) == 0u);
}

// Slots [count, NC) of list: tile 0's lowest-index words without a hit,
// in ascending order (the plain version's padding rule, above); b is
// the misses among words 0 .. 31. One warp.
__device__ void pad_tile0(const Args& a, const Win& w, bool down,
                          unsigned code2, int count, unsigned b,
                          int32_t* list, int lane)
{
    const unsigned below = (1u << lane) - 1u;
    for (int c0 = 0;;) {
        const int slot = count + __popc(b & below);
        if ((b >> lane) & 1u && slot < a.NC)
            list[slot] = (int32_t)((w.base << 4) + 16u * (unsigned)(c0 + lane)
                                   + (down ? 0u : 15u));
        count += __popc(b);
        c0 += 32;
        if (c0 >= (a.W >> 4) || count >= a.NC)
            return;
        b = miss_ballot(a, word_at(a, w, c0 + lane),
                        word_at(a, w, c0 + lane + 1), code2, c0, lane);
    }
}

__global__ void __launch_bounds__(kThreads)
anchor_scan_tile0(const Args a)
{
    __shared__ __align__(16) Smem sm;
    const int row = blockIdx.x;
    init_bars(sm);
    // the padding's first words, loaded while the row is walked
    const bool down = a.down[row] != 0;
    const int lane = threadIdx.x & 31;
    const Win w = window(a.pos[row], down, a.rdlens[row], a, 0);
    unsigned lo = 0u, hi = 0u;
    if (threadIdx.x < 32) {
        lo = word_at(a, w, lane);
        hi = word_at(a, w, lane + 1);
    }
    const int count = walk(a, sm, row, 0, 1, 0);
    if (count < a.NC && threadIdx.x < 32) {
        const unsigned code = (unsigned)a.acode[row];
        const unsigned code2 = code | (code << 16);
        pad_tile0(a, w, down, code2, count,
                  miss_ballot(a, lo, hi, code2, 0, lane), sm.list, lane);
    }
    __syncthreads();
    const int i = threadIdx.x;
    if (i < a.NC) {
        a.mpos[(long long)row * a.NC + i] = sm.list[i];
        a.kvalid[(long long)row * a.NC + i] = i < count;
    }
    if (i == 0) {
        a.counts[row] = count;
        if (count == 0 && !a.has_n[row] && (a.live == nullptr || a.live[row]))
            *a.flag = 1;
    }
}

__global__ void __launch_bounds__(kThreads)
anchor_scan_deep(const Args a)
{
    if (*a.flag == 0)
        return;                 // every live row resolved in tile 0
    if (blockIdx.x == 0 && threadIdx.x == 0)
        atomicAdd(a.deep_calls, 1ull);
    const int row = blockIdx.x;
    const int count0 = a.counts[row];
    if (count0 >= a.NC)
        return;
    __shared__ __align__(16) Smem sm;
    const int i = threadIdx.x;
    int32_t* mp = a.mpos + (long long)row * a.NC;
    if (i < a.NC)
        sm.pad[i] = mp[i];      // slots count0 .. NC - 1: tile 0's padding
    init_bars(sm);
    const int count = walk(a, sm, row, 1, a.tiles, count0);
    __syncthreads();
    if (count > count0 && i >= count0 && i < a.NC) {
        if (i < count) {
            mp[i] = sm.list[i];
            a.kvalid[(long long)row * a.NC + i] = 1;
        } else {
            mp[i] = sm.pad[count0 + i - count];   // kvalid stays false
        }
    }
}

}  // namespace

// Plain C entry point. Pointers are device pointers to contiguous arrays
// (shapes in Args); live may be null. deep = 0 launches the tile-0 kernel
// (after zeroing the flag on the stream), deep = 1 the deep kernel; one
// block of kThreads a scan row. Shapes the kernels do not serve (A != 8,
// W not a positive multiple of 16 with W / 16 >= NC, NC outside 1..32,
// tiles < 1, no text row, no scan row) are refused with
// cudaErrorInvalidValue. Launches on `stream` and returns
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
    if (deep) {
        anchor_scan_deep<<<S, kThreads, 0, st>>>(a);
    } else {
        const cudaError_t e = cudaMemsetAsync(flag, 0, sizeof(int32_t), st);
        if (e != cudaSuccess)
            return static_cast<int>(e);
        anchor_scan_tile0<<<S, kThreads, 0, st>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
}
