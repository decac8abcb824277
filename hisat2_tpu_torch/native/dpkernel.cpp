// Affine-gap DP + traceback for one (read, ref-window) pair.
//
// The fill identities (running-max closure of the read-gap row), end-cell
// tie-breaks (largest i, then smallest j) and traceback state machine of
// hisat2_tpu's NumPy host traceback (hisat2_tpu/ops/sw.py:dp_traceback),
// but for one fix: a 5' clip that ends at the window's first column is a
// clip (S), where that version writes its bases as a leading insertion
// under the clip's score. The reference's equivalent is its SSE DP +
// BtBranchTracer pair (aligner_sw.cpp, aligner_bt.cpp); here the
// winners-only host traceback is the hot part worth native code (the
// batched fill runs on the device).
//
// Build: g++ -O3 -shared -fPIC (see native/__init__.py).

#include <cstdint>
#include <cstring>
#include <vector>

static const int64_t NEG = -(1LL << 28);

extern "C" int32_t dp_traceback_one(
    const uint8_t* rd, const uint8_t* qual, int32_t L,
    const uint8_t* ref, int32_t W,
    const int32_t* mm_pens,   // [64] qual-indexed mismatch penalties
    const int32_t* sc_pens,   // [64] qual-indexed soft-clip penalties
    int32_t match_bonus, int32_t n_pen,
    int32_t rd_open, int32_t rd_ext, int32_t rf_open, int32_t rf_ext,
    // outputs
    int32_t* out_score, int32_t* out_ref_start,
    uint8_t* cig_ops, int32_t* cig_lens, int32_t* out_ncig,  // cap L+W+2
    int32_t* mds, int32_t* out_nmds)                          // cap 2*L
{
    const int64_t Wp = W + 1;
    std::vector<int64_t> H((L + 1) * Wp), E((L + 1) * Wp), F((L + 1) * Wp);
    std::vector<int64_t> SCP(L + 1);
    std::vector<int32_t> q(L);
    SCP[0] = 0;
    for (int i = 0; i < L; i++) {
        int32_t qi = qual[i];
        if (qi < 0) qi = 0;
        if (qi > 63) qi = 63;
        q[i] = qi;
        SCP[i + 1] = SCP[i] + sc_pens[qi];
    }
    for (int64_t j = 0; j <= W; j++) {
        H[j] = 0;
        E[j] = NEG;
        F[j] = NEG;
    }
    // fill (row i uses the same closed-form E as the NumPy version)
    std::vector<int64_t> M(Wp);
    for (int i = 1; i <= L; i++) {
        int64_t* Hp = &H[(int64_t)(i - 1) * Wp];
        int64_t* Hc = &H[(int64_t)i * Wp];
        int64_t* Fp = &F[(int64_t)(i - 1) * Wp];
        int64_t* Fc = &F[(int64_t)i * Wp];
        int64_t* Ec = &E[(int64_t)i * Wp];
        int64_t col0 = -((int64_t)rf_open + (int64_t)(i - 1) * rf_ext);
        if (-SCP[i] > col0) col0 = -SCP[i];
        // Frow + G + running max
        Fc[0] = col0;
        int64_t G0 = col0;
        M[0] = G0;  // G[0] + rd_ext*0
        int64_t run = M[0];
        const uint8_t rc = rd[i - 1];
        const int32_t qp = mm_pens[q[i - 1]];
        std::vector<int64_t> G(Wp);
        G[0] = G0;
        for (int64_t j = 1; j <= W; j++) {
            int64_t f = Hp[j] - rf_open;
            int64_t f2 = Fp[j] - rf_ext;
            if (f2 > f) f = f2;
            Fc[j] = f;
            const uint8_t fc_ = ref[j - 1];
            int64_t s;
            if (rc >= 4 || fc_ >= 4) s = -n_pen;
            else if (rc != fc_) s = -qp;
            else s = match_bonus;
            int64_t g = Hp[j - 1] + s;
            if (f > g) g = f;
            G[j] = g;
            int64_t m = g + (int64_t)rd_ext * j;
            if (m > run) run = m;
            M[j] = run;
        }
        Ec[0] = NEG;
        Hc[0] = col0;
        const int64_t clip = -SCP[i];
        for (int64_t j = 1; j <= W; j++) {
            int64_t e = M[j - 1] - rd_open - (int64_t)rd_ext * (j - 1);
            Ec[j] = e;
            int64_t h = G[j];
            if (e > h) h = e;
            if (clip > h) h = clip;
            Hc[j] = h;
        }
    }

    // end cell: maximize H[i][j] - trailing clip; ties -> larger i, then
    // smaller j (matches np.argmax over the row-reversed matrix)
    int64_t best = NEG * 2;
    int bi = 0, bj = 0;
    for (int i = L; i >= 0; i--) {
        const int64_t tail = SCP[L] - SCP[i];
        const int64_t* Hr = &H[(int64_t)i * Wp];
        for (int64_t j = 0; j <= W; j++) {
            int64_t v = Hr[j] - tail;
            if (v > best) {
                best = v;
                bi = i;
                bj = (int)j;
            }
        }
    }
    int i = bi, j = bj;
    *out_score = (int32_t)best;
    const int clip3 = L - i;

    // traceback (ops emitted reversed, then run-length-encoded forward)
    std::vector<uint8_t> ops;
    ops.reserve(L + 8);
    int nmds = 0;
    char state = 'H';
    while (i > 0) {
        const int64_t* Hc = &H[(int64_t)i * Wp];
        const int64_t* Hp = &H[(int64_t)(i - 1) * Wp];
        const int64_t* Ec = &E[(int64_t)i * Wp];
        const int64_t* Fc = &F[(int64_t)i * Wp];
        const int64_t* Fp = &F[(int64_t)(i - 1) * Wp];
        if (state == 'H') {
            int64_t s = 0;
            bool has_diag = j > 0;
            bool is_mm = false;
            if (has_diag) {
                const uint8_t rc = rd[i - 1], fc_ = ref[j - 1];
                if (rc >= 4 || fc_ >= 4) { s = -n_pen; is_mm = true; }
                else if (rc != fc_) { s = -mm_pens[q[i - 1]]; is_mm = true; }
                else s = match_bonus;
            }
            if (has_diag && Hc[j] == Hp[j - 1] + s) {
                ops.push_back('M');
                if (is_mm) {
                    mds[2 * nmds] = i - 1;
                    mds[2 * nmds + 1] = j - 1;
                    nmds++;
                }
                i--; j--;
            } else if (j == 0) {
                // the window's first column holds col0, the better of a 5'
                // clip and a leading ref gap; F there is col0 too, so the
                // clip is tested first
                if (Hc[0] == -SCP[i])
                    break;
                state = 'F';
            } else if (Hc[j] == Ec[j]) {
                state = 'E';
            } else if (Hc[j] == Fc[j]) {
                state = 'F';
            } else {
                break;  // 5' clip start (checked last: prefer real ops)
            }
        } else if (state == 'E') {
            ops.push_back('D');
            if (Ec[j] == Hc[j - 1] - rd_open || j <= 1
                    || Ec[j] != Ec[j - 1] - rd_ext)
                state = 'H';
            j--;
        } else {  // F
            ops.push_back('I');
            if (j == 0) {
                i--;
                state = 'H';
                continue;
            }
            if (Fc[j] == Hp[j] - rf_open || i <= 1
                    || Fc[j] != Fp[j] - rf_ext)
                state = 'H';
            i--;
        }
    }
    const int clip5 = i;
    *out_ref_start = j;

    // reverse mds (they were collected back-to-front)
    for (int a = 0, b = nmds - 1; a < b; a++, b--) {
        int32_t t0 = mds[2 * a], t1 = mds[2 * a + 1];
        mds[2 * a] = mds[2 * b];
        mds[2 * a + 1] = mds[2 * b + 1];
        mds[2 * b] = t0;
        mds[2 * b + 1] = t1;
    }
    *out_nmds = nmds;

    int nc = 0;
    if (clip5) { cig_ops[nc] = 'S'; cig_lens[nc] = clip5; nc++; }
    for (int k = (int)ops.size() - 1; k >= 0; k--) {
        uint8_t op = ops[k];
        if (nc && cig_ops[nc - 1] == op) cig_lens[nc - 1]++;
        else { cig_ops[nc] = op; cig_lens[nc] = 1; nc++; }
    }
    if (clip3) { cig_ops[nc] = 'S'; cig_lens[nc] = clip3; nc++; }
    *out_ncig = nc;
    return 0;
}
