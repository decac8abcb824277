// Threaded direct-address k-mer table construction.
//
// Equivalent role to the reference's multithreaded blockwise suffix
// sorting for index build (blockwise_sa.h:234-280 bucket workers) — our
// TPU-first seeding structure is the direct-address k-mer table
// (index/seed_table.py), whose build is a stable counting sort of every
// k-mer start position by its base-4 code. This replaces the
// single-threaded numpy/torch argsort path with a two-pass parallel
// counting sort: per-thread histograms over text slices, a global
// prefix scan, per-thread bucket offsets, then a parallel stable
// scatter (thread t's slice positions all precede thread t+1's, so
// within-bucket position order stays ascending).
//
// Build: g++ -O3 -march=native -std=c++17 -pthread -shared -fPIC
//        -o kmersort.so kmersort.cpp

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// text: n base codes 0..3 (joined references exclude ambiguous runs).
// starts: (4^kt + 1) int32 out; pos: (m_kept) int32 out where only
// kmer starts with i %% stride == 0 are kept (stride-sampled tables for
// Gbp shards — the offrate role of gfm.h _offs; stride 1 = full).
// Returns 0 on success, -1 on bad input (kt out of range / n too big).
int32_t kmer_table(const uint8_t* text, int64_t n, int32_t kt,
                   int32_t* starts, int32_t* pos, int32_t nthreads,
                   int32_t stride)
{
    if (stride < 1) stride = 1;
    if (kt < 1 || kt > 15 || n >= (int64_t)INT32_MAX) return -1;
    const int64_t m = n - kt + 1;
    const int64_t nb = (int64_t)1 << (2 * kt);
    const uint32_t mask = (uint32_t)(nb - 1);
    if (m <= 0) {
        std::memset(starts, 0, (size_t)(nb + 1) * 4);
        return 0;
    }
    int T = nthreads > 0 ? nthreads
                         : (int)std::thread::hardware_concurrency();
    if (T < 1) T = 1;
    if ((int64_t)T > m) T = (int)m;

    // per-thread histograms
    std::vector<std::vector<int32_t>> hist((size_t)T);
    std::vector<std::thread> ts;
    auto slice = [&](int t, int64_t& lo, int64_t& hi) {
        lo = m * t / T;
        hi = m * (t + 1) / T;
    };
    for (int t = 0; t < T; t++) {
        ts.emplace_back([&, t]() {
            hist[(size_t)t].assign((size_t)nb, 0);
            int32_t* h = hist[(size_t)t].data();
            int64_t lo, hi;
            slice(t, lo, hi);
            // rolling code over [lo, hi): seed with the first kt-1 chars
            uint32_t code = 0;
            for (int64_t j = lo; j < lo + kt - 1; j++)
                code = (code << 2) | (text[j] & 3);
            for (int64_t i = lo; i < hi; i++) {
                code = ((code << 2) | (text[i + kt - 1] & 3)) & mask;
                if (i % stride == 0) h[code]++;
            }
        });
    }
    for (auto& th : ts) th.join();
    ts.clear();

    // global exclusive scan + per-thread bucket offsets (hist[t][c]
    // becomes the absolute scatter offset for thread t, code c)
    int64_t run = 0;
    starts[0] = 0;
    for (int64_t c = 0; c < nb; c++) {
        for (int t = 0; t < T; t++) {
            int32_t cnt = hist[(size_t)t][(size_t)c];
            hist[(size_t)t][(size_t)c] = (int32_t)run;
            run += cnt;
        }
        starts[c + 1] = (int32_t)run;
    }

    // parallel stable scatter
    for (int t = 0; t < T; t++) {
        ts.emplace_back([&, t]() {
            int32_t* off = hist[(size_t)t].data();
            int64_t lo, hi;
            slice(t, lo, hi);
            uint32_t code = 0;
            for (int64_t j = lo; j < lo + kt - 1; j++)
                code = (code << 2) | (text[j] & 3);
            for (int64_t i = lo; i < hi; i++) {
                code = ((code << 2) | (text[i + kt - 1] & 3)) & mask;
                if (i % stride == 0) pos[off[code]++] = (int32_t)i;
            }
        });
    }
    for (auto& th : ts) th.join();
    return 0;
}

}  // extern "C"
