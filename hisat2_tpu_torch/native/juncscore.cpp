// Native junction scorer: per-lane junction scoring + acceptance gates,
// the C++ mirror of ops/splice_host.junction_score_host + gate_pack_host
// (which themselves mirror the device kernel ops/splice.junction_score +
// _gate_pack; reference policy hi_aligner.h:3753-3786, splice_site.cpp
// PWM). The RNA finish path scores residual/cleanup lanes on the host —
// a few thousand (lane x 104bp) problems per batch — where NumPy's
// ~20 temporaries per call cost ~70ms/batch; this loop does the same
// work cache-resident in a few ms, threaded over lane blocks.
//
// Semantics cross-checked lane-for-lane in tests/test_splice_host.py.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

constexpr int64_t NEG = -(int64_t(1) << 28);   // ops/splice.NEG

inline int64_t max_intron_len(int64_t anchor) {        // canonical, min 7
    if (anchor < 7) return 0;
    int64_t a = std::max<int64_t>(anchor, 2);
    int64_t shift = std::min<int64_t>(std::max<int64_t>(2 * a - 4, 13), 30);
    return int64_t(1) << shift;
}

inline int64_t max_intron_len_noncan(int64_t anchor) { // min 14
    if (anchor < 14) return 0;
    int64_t a = std::max<int64_t>(anchor, 5);
    int64_t shift = std::min<int64_t>(2 * a - 10, 30);
    return int64_t(1) << shift;
}

inline float probscore_thresh(int64_t il) {
    float t = 0.8f;
    if (il >> 12) t = 0.88f;
    if (il >> 13) t = 0.91f;
    if (il >> 14) t = 0.94f;
    if (il >> 15) t = 0.97f;
    if (il >> 16) t = 0.99f;
    return t;
}

struct Params {
    const uint8_t* joined; int64_t n_joined;
    const uint8_t* overlay;            // null when absent
    const int8_t* rd; const int8_t* q;
    const int64_t* rdlens;
    const int64_t* posA; const int64_t* posB;
    int64_t C, L;
    const int64_t* kleft; const int64_t* kright; int64_t nK;
    const int64_t* mm_pens; const int64_t* sc_pens;   // [64]
    int64_t n_pen, match_bonus;
    double smin_I, smin_S;
    int64_t max_intron; int32_t dta;
    int64_t canon_pen, noncanon_pen;
    const double* donor_lo;  // 4 x 9 row-major
    const double* accept_lo; // 4 x 15
    int64_t* out;            // (C, 7) score j strand canon mmL mmR flags
    float* out_ps;           // (C,)
};

void score_lane(const Params& P, int64_t c,
                int32_t* winA, int32_t* winB_ext, int32_t* ovA,
                int32_t* ovB_ext, int64_t* A, int64_t* SCP, int64_t* SB,
                int64_t* prefix, int64_t* suffix, int64_t* MA,
                int64_t* MBc, uint8_t* known) {
    const int64_t L = P.L;
    const int64_t rdlen = P.rdlens[c];
    const int64_t pa = P.posA[c], pb = P.posB[c];
    const int64_t delta = pb - pa;
    const int8_t* rd = P.rd + c * L;
    const int8_t* q = P.q + c * L;
    const bool ov = P.overlay != nullptr;

    // windows (4 beyond the reference ends)
    for (int64_t k = 0; k < L + 18; ++k) {
        int64_t ia = pa + k;                 // winA needs L+16(+2 motif)
        if (k < L + 18) {
            int64_t ib = pb - 16 + k;
            winB_ext[k] = (ib >= 0 && ib < P.n_joined) ? P.joined[ib] : 4;
            if (ov) ovB_ext[k] =
                (ib >= 0 && ib < P.n_joined) ? P.overlay[ib] : 0;
        }
        if (k < L + 18) {
            winA[k] = (ia >= 0 && ia < P.n_joined) ? P.joined[ia] : 4;
            if (ov) ovA[k] = (ia >= 0 && ia < P.n_joined) ? P.overlay[ia]
                                                         : 0;
        }
    }

    // per-position scores + cumsums; A/SCP/SB have L+1 entries
    A[0] = SCP[0] = SB[0] = 0;
    MA[0] = MBc[0] = 0;
    for (int64_t j = 0; j < L; ++j) {
        bool in_read = j < rdlen;
        int64_t qv = std::min<int64_t>(std::max<int64_t>(q[j], 0), 63);
        int64_t sa = 0, sb = 0, scp = 0;
        int64_t ma = 0, mb = 0;
        if (in_read) {
            int32_t wa = winA[j];
            int32_t wb = winB_ext[16 + j];
            bool isnA = rd[j] >= 4 || wa >= 4;
            bool isnB = rd[j] >= 4 || wb >= 4;
            bool mmA = (rd[j] != wa) && !isnA;
            bool mmB = (rd[j] != wb) && !isnB;
            if (ov) {
                if (mmA && (ovA[j] == rd[j] + 1 || ovA[j] == 15))
                    mmA = false;
                if (mmB && (ovB_ext[16 + j] == rd[j] + 1
                            || ovB_ext[16 + j] == 15))
                    mmB = false;
            }
            sa = isnA ? -P.n_pen : (mmA ? -P.mm_pens[qv] : P.match_bonus);
            sb = isnB ? -P.n_pen : (mmB ? -P.mm_pens[qv] : P.match_bonus);
            scp = P.sc_pens[qv];
            // anchor purity counters use raw mismatch-or-N
            ma = (rd[j] != wa || rd[j] >= 4 || wa >= 4) ? 1 : 0;
            mb = (rd[j] != wb || rd[j] >= 4 || wb >= 4) ? 1 : 0;
        }
        A[j + 1] = A[j] + sa;
        SB[j + 1] = SB[j] + sb;
        SCP[j + 1] = SCP[j] + scp;
        MA[j + 1] = MA[j] + ma;
        MBc[j + 1] = MBc[j] + mb;
    }
    // prefix[j] = A[j] - min_{t<=j}(A[t]+SCP[t])
    int64_t runmin = A[0] + SCP[0];
    for (int64_t j = 0; j <= L; ++j) {
        runmin = std::min(runmin, A[j] + SCP[j]);
        prefix[j] = A[j] - runmin;
    }
    // suffix[j] = sufsum[j] - min_{e>=j}(sufsum[e]+tailclip[e])
    int64_t SL = SB[L], SCL = SCP[L];
    int64_t runmin2 = (SL - SB[L]) + (SCL - SCP[L]);
    for (int64_t j = L; j >= 0; --j) {
        int64_t sufsum = SL - SB[j];
        int64_t tailclip = SCL - SCP[j];
        runmin2 = std::min(runmin2, sufsum + tailclip);
        suffix[j] = sufsum - runmin2;
    }

    // known sites at this diagonal pair
    std::memset(known, 0, L + 1);
    if (P.nK > 0) {
        int64_t lo = int64_t(
            std::lower_bound(P.kleft, P.kleft + P.nK, pa) - P.kleft);
        for (int dpr = 0; dpr < 12; ++dpr) {
            int64_t kk = std::min(lo + dpr, P.nK - 1);
            int64_t l_p = P.kleft[kk], r_p = P.kright[kk];
            int64_t jv = l_p - pa + 1;
            if (l_p < pa + L && r_p == pb + jv && jv >= 0 && jv <= L)
                known[jv] = 1;
        }
    }

    double ilp_d = -8.0 + std::log((double)std::max<int64_t>(delta, 1));
    int64_t ilp = std::max<int64_t>(0, (int64_t)ilp_d);
    int64_t best = NEG;
    int64_t best_j = 0;
    for (int64_t j = 0; j <= L; ++j) {
        int64_t b = prefix[j] + suffix[j];
        bool plus = winA[j] == 2 && winA[j + 1] == 3
            && winB_ext[14 + j] == 0 && winB_ext[15 + j] == 2;
        bool minus = winA[j] == 1 && winA[j + 1] == 3
            && winB_ext[14 + j] == 0 && winB_ext[15 + j] == 1;
        bool canonical = plus || minus;
        int64_t cand = NEG;
        if (known[j] && j >= 1 && j <= rdlen - 1)
            cand = std::max(cand, b - ilp);
        if (canonical && j >= 7 && j <= rdlen - 7)
            cand = std::max(cand, b - ilp - P.canon_pen);
        if (j >= 14 && j <= rdlen - 14)
            cand = std::max(cand, b - ilp - P.noncanon_pen);
        if (cand > best) { best = cand; best_j = j; }
    }
    bool bknown = known[best_j] != 0;
    bool bplus = winA[best_j] == 2 && winA[best_j + 1] == 3
        && winB_ext[14 + best_j] == 0 && winB_ext[15 + best_j] == 2;
    bool bminus = winA[best_j] == 1 && winA[best_j + 1] == 3
        && winB_ext[14 + best_j] == 0 && winB_ext[15 + best_j] == 1;
    bool bcanon = bplus || bminus;
    bool ok = delta >= 20 && best > NEG / 2;
    int64_t strand = (bplus || (bknown && !bcanon)) ? 1 : 2;
    int64_t mmL = MA[best_j];
    int64_t mmR = MBc[rdlen] - MBc[best_j];

    // PWM probscore ('-' junctions score the reverse-complemented
    // windows; N -> base 0 BEFORE complement, hi_aligner.h:1672)
    double s_sig = 0.0;
    for (int m = 0; m < 9; ++m) {
        int32_t bse;
        if (bplus) {
            int64_t idx = std::min<int64_t>(
                std::max<int64_t>(best_j - 3 + m, 0), P.L + 15);
            bse = winA[idx];
            if (bse > 3) bse = 0;
        } else {
            int64_t idx = std::min<int64_t>(
                std::max<int64_t>(18 + best_j - m, 0), P.L + 17);
            bse = winB_ext[idx];
            if (bse > 3) bse = 0;
            bse = 3 - bse;
        }
        s_sig += P.donor_lo[bse * 9 + m];
    }
    for (int m = 0; m < 15; ++m) {
        int32_t bse;
        if (bplus) {
            int64_t idx = std::min<int64_t>(
                std::max<int64_t>(2 + best_j + m, 0), P.L + 17);
            bse = winB_ext[idx];
            if (bse > 3) bse = 0;
        } else {
            int64_t idx = std::min<int64_t>(
                std::max<int64_t>(best_j + 13 - m, 0), P.L + 15);
            bse = winA[idx];
            if (bse > 3) bse = 0;
            bse = 3 - bse;
        }
        s_sig += P.accept_lo[bse * 15 + m];
    }
    float ps = (float)(1.0 / (1.0 + std::exp(-s_sig)));

    int64_t score = ok ? best : NEG;
    int64_t str_o = ok ? strand : 0;
    int64_t canon = bknown ? 1 : (bcanon ? 2 : 0);

    // gates (gate_pack_host)
    int64_t min_sc = (int64_t)std::ceil(P.smin_I + P.smin_S
                                        * (double)rdlen);
    bool alive = str_o != 0;
    bool below = score < min_sc;
    bool part = alive && below && canon != 0 && score > NEG / 2;
    int64_t aL = best_j - 2 * mmL;
    int64_t aR = rdlen - best_j - 2 * mmR;
    int64_t shorter = std::max<int64_t>(std::min(aL, aR), 1);
    int64_t lim_c = max_intron_len(shorter);
    int64_t lim_n = max_intron_len_noncan(shorter);
    bool okg = true;
    bool is_can = canon == 2;
    bool gate_c = lim_c < P.max_intron;
    if (is_can && gate_c && delta > lim_c) okg = false;
    if (is_can && gate_c && ps < probscore_thresh(delta)) okg = false;
    if (canon == 0 && lim_n < P.max_intron && delta > lim_n) okg = false;
    if (P.dta) {
        int64_t anchor = std::min(best_j, rdlen - best_j);
        if (is_can && anchor < 14) okg = false;
    }
    bool accept = alive && !below && okg;
    int64_t flags = str_o | (canon << 2) | (int64_t(accept) << 4)
        | (int64_t(part) << 5);

    int64_t* o = P.out + c * 7;
    o[0] = score; o[1] = best_j; o[2] = str_o; o[3] = canon;
    o[4] = mmL; o[5] = mmR; o[6] = flags;
    P.out_ps[c] = ps;
}

}  // namespace

extern "C" void junc_score_batch(
    const uint8_t* joined, int64_t n_joined, const uint8_t* overlay,
    const int8_t* rd, const int8_t* q, const int64_t* rdlens,
    const int64_t* posA, const int64_t* posB, int64_t C, int64_t L,
    const int64_t* kleft, const int64_t* kright, int64_t nK,
    const int64_t* mm_pens, const int64_t* sc_pens,
    int64_t n_pen, int64_t match_bonus,
    double smin_I, double smin_S, int64_t max_intron, int32_t dta,
    int64_t canon_pen, int64_t noncanon_pen,
    const double* donor_lo, const double* accept_lo,
    int64_t* out, float* out_ps, int32_t n_threads) {
    Params P{joined, n_joined, overlay, rd, q, rdlens, posA, posB, C, L,
             kleft, kright, nK, mm_pens, sc_pens, n_pen, match_bonus,
             smin_I, smin_S, max_intron, dta, canon_pen, noncanon_pen,
             donor_lo, accept_lo, out, out_ps};
    int nt = std::max(1, std::min<int>(n_threads, 16));
    if ((int64_t)nt > C) nt = (int)std::max<int64_t>(C, 1);
    auto work = [&](int64_t lo, int64_t hi) {
        std::vector<int32_t> winA(L + 18), winB(L + 18);
        std::vector<int32_t> ovA(L + 18), ovB(L + 18);
        std::vector<int64_t> A(L + 1), SCP(L + 1), SB(L + 1);
        std::vector<int64_t> pre(L + 1), suf(L + 1), MA(L + 1),
            MB(L + 1);
        std::vector<uint8_t> known(L + 1);
        for (int64_t c = lo; c < hi; ++c)
            score_lane(P, c, winA.data(), winB.data(), ovA.data(),
                       ovB.data(), A.data(), SCP.data(), SB.data(),
                       pre.data(), suf.data(), MA.data(), MB.data(),
                       known.data());
    };
    if (nt <= 1 || C < 256) {
        work(0, C);
        return;
    }
    std::vector<std::thread> ths;
    int64_t step = (C + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
        int64_t lo = t * step, hi = std::min<int64_t>(C, lo + step);
        if (lo >= hi) break;
        ths.emplace_back(work, lo, hi);
    }
    for (auto& th : ths) th.join();
}
