// SA-IS suffix array construction (Nong, Zhang & Chan 2009), 32/64-bit.
//
// Equivalent role to the reference's blockwise_sa.h KarkkainenBlockwiseSA +
// diff_sample + multikey_qsort stack (SURVEY.md §2.2): the reference trades
// time for an 8GB-desktop memory budget with blockwise suffix sorting; on a
// TPU host we take the linear-time induced-sorting algorithm with ~9 bytes
// per position, which builds chromosome-scale arrays in seconds and
// human-genome arrays in minutes.
//
// Input: T[0..n-1] over alphabet [1, K) with T[n-1] == 0 the unique
// sentinel (callers append it). Output: SA[0..n-1].
//
// Build: g++ -O3 -shared -fPIC -o libsais.so sais.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

template <typename I, typename Char>
struct Sais {
    const Char* T;
    I n;
    I K;
    I* SA;
    std::vector<uint8_t> types;  // 1 = S-type, 0 = L-type

    Sais(const Char* T_, I* SA_, I n_, I K_) : T(T_), n(n_), K(K_), SA(SA_) {}

    inline bool is_lms(I i) const {
        return i > 0 && types[i] && !types[i - 1];
    }

    void classify() {
        types.assign(n, 0);
        types[n - 1] = 1;
        for (I i = n - 1; i-- > 0;) {
            types[i] = (T[i] < T[i + 1] || (T[i] == T[i + 1] && types[i + 1]))
                           ? 1 : 0;
        }
    }

    void bucket_sizes(std::vector<I>& bkt) const {
        bkt.assign(K, 0);
        for (I i = 0; i < n; i++) bkt[T[i]]++;
    }

    void bucket_heads(std::vector<I>& bkt) const {
        std::vector<I> sz;
        bucket_sizes(sz);
        bkt.assign(K, 0);
        I sum = 0;
        for (I c = 0; c < K; c++) { bkt[c] = sum; sum += sz[c]; }
    }

    void bucket_tails(std::vector<I>& bkt) const {
        std::vector<I> sz;
        bucket_sizes(sz);
        bkt.assign(K, 0);
        I sum = 0;
        for (I c = 0; c < K; c++) { sum += sz[c]; bkt[c] = sum; }
    }

    // induce L then S from placed LMS suffixes
    void induce() {
        std::vector<I> bkt;
        bucket_heads(bkt);
        for (I i = 0; i < n; i++) {
            I j = SA[i];
            if (j == (I)-1 || j == 0) continue;
            if (!types[j - 1]) SA[bkt[T[j - 1]]++] = j - 1;
        }
        bucket_tails(bkt);
        for (I i = n; i-- > 0;) {
            I j = SA[i];
            if (j == (I)-1 || j == 0) continue;
            if (types[j - 1]) SA[--bkt[T[j - 1]]] = j - 1;
        }
    }

    void run() {
        classify();
        // stage 1: sort LMS *substrings* — place LMS at bucket tails in
        // arbitrary order, then induce
        std::vector<I> bkt;
        bucket_tails(bkt);
        std::memset(SA, 0xff, sizeof(I) * (size_t)n);
        for (I i = 1; i < n; i++)
            if (is_lms(i)) SA[--bkt[T[i]]] = i;
        induce();

        // compact the (substring-)sorted LMS positions into SA[0..n1)
        I n1 = 0;
        for (I i = 0; i < n; i++)
            if (SA[i] != (I)-1 && is_lms(SA[i])) SA[n1++] = SA[i];

        // name LMS substrings using SA[n1..n) as a pos/2-indexed work area
        I* work = SA + n1;
        std::memset(work, 0xff, sizeof(I) * (size_t)(n - n1));
        I name = 0;
        I prev = (I)-1;
        for (I i = 0; i < n1; i++) {
            I pos = SA[i];
            bool diff = false;
            if (prev == (I)-1) {
                diff = true;
            } else {
                for (I d = 0;; d++) {
                    if (T[pos + d] != T[prev + d] ||
                        types[pos + d] != types[prev + d]) {
                        diff = true;
                        break;
                    }
                    if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) break;
                }
            }
            if (diff) { name++; prev = pos; }
            work[pos / 2] = name - 1;
        }

        // reduced string T1: names of LMS substrings in text order
        std::vector<I> T1(n1), SA1(n1);
        {
            I cnt = 0;
            for (I i = 0; i < n - n1; i++)
                if (work[i] != (I)-1) T1[cnt++] = work[i];
        }

        if (name < n1) {
            Sais<I, I> rec(T1.data(), SA1.data(), n1, name);
            rec.run();
        } else {
            for (I i = 0; i < n1; i++) SA1[T1[i]] = i;
        }

        // stage 2: place LMS suffixes in their true order, induce final SA
        std::vector<I> lms(n1);
        {
            I cnt = 0;
            for (I i = 1; i < n; i++)
                if (is_lms(i)) lms[cnt++] = i;
        }
        std::memset(SA, 0xff, sizeof(I) * (size_t)n);
        bucket_tails(bkt);
        for (I i = n1; i-- > 0;) {
            I p = lms[SA1[i]];
            SA[--bkt[T[p]]] = p;
        }
        induce();
    }
};

}  // namespace

extern "C" {

// T: values in [1, K), T[n-1] == 0 sentinel. SA: out, length n.
void sais_u8_i32(const uint8_t* T, int32_t* SA, int32_t n, int32_t K) {
    Sais<int32_t, uint8_t> s(T, SA, n, K);
    s.run();
}

void sais_u8_i64(const uint8_t* T, int64_t* SA, int64_t n, int64_t K) {
    Sais<int64_t, uint8_t> s(T, SA, n, K);
    s.run();
}

// Kasai LCP over a plain (sentinel-free) text + suffix array: lcp[r] =
// LCP(suffix SA[r-1], suffix SA[r]), lcp[0] = 0. The repeat builder's
// run walk consumes this (reference repeat_builder.cpp RB_SubSA
// grouping); the Python Kasai loop was the hisat2-repeat-scale blocker.
void kasai_lcp_i64(const uint8_t* T, const int64_t* SA, int64_t* lcp,
                   int64_t n) {
    std::vector<int64_t> rank((size_t)n);
    for (int64_t r = 0; r < n; r++) rank[(size_t)SA[r]] = r;
    int64_t h = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t r = rank[(size_t)i];
        if (r > 0) {
            int64_t j = SA[r - 1];
            int64_t m = (n - i < n - j) ? n - i : n - j;
            while (h < m && T[i + h] == T[j + h]) h++;
            lcp[r] = h;
            if (h) h--;
        } else {
            lcp[0] = 0;
            h = 0;
        }
    }
}

}  // extern "C"
