// Batched SAM record formatting for the aligner's fast path.
//
// Equivalent role to the reference's AlnSinkSam::appendMate + BTString
// assembly (aln_sink.h:3024, sam.h): given column arrays for N simple
// (ungapped, clip-only CIGAR) alignments, emit complete SAM lines into one
// buffer. The Python host keeps only odd records (gapped/spliced/multi).
//
// Build: g++ -O3 -shared -fPIC -o libsamfmt.so samfmt.cpp

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline char* put_str(char* p, const char* s, int len) {
    std::memcpy(p, s, (size_t)len);
    return p + len;
}

inline char* put_int(char* p, int64_t v) {
    if (v < 0) { *p++ = '-'; v = -v; }
    char tmp[20];
    int n = 0;
    do { tmp[n++] = (char)('0' + v % 10); v /= 10; } while (v);
    while (n) *p++ = tmp[--n];
    return p;
}

inline char* put_tag_i(char* p, const char* tag, int64_t v) {
    *p++ = '\t';
    p = put_str(p, tag, 2);
    *p++ = ':'; *p++ = 'i'; *p++ = ':';
    return put_int(p, v);
}

}  // namespace

extern "C" {

// Format N simple SE records. CIGAR is c5 S / mid M / c3 S. Mismatch MD
// data: per-record slice [mm_off[i], mm_off[i+1]) of (mm_cols relative to
// the aligned region start, mm_ref ASCII ref base).
//
// Returns total bytes written; rec_ends[i] = end offset of record i.
int64_t format_se_batch(
    int32_t n,
    const int32_t* flag, const int32_t* rname_idx, const int32_t* pos1,
    const int32_t* mapq,
    const int32_t* c5, const int32_t* mid, const int32_t* c3,
    const int32_t* score, const int32_t* nmm, const int32_t* nm,
    const int32_t* zs,            // INT32_MIN = absent
    const int32_t* nh,
    const uint8_t* name_buf, const int64_t* name_off,
    const uint8_t* seq_buf, const uint8_t* qual_buf, const int64_t* seq_off,
    const int32_t* mm_cols, const uint8_t* mm_ref, const int64_t* mm_off,
    const uint8_t* refname_buf, const int64_t* refname_off,
    char* out, int64_t* rec_ends)
{
    char* p = out;
    for (int32_t i = 0; i < n; i++) {
        // QNAME
        p = put_str(p, (const char*)(name_buf + name_off[i]),
                    (int)(name_off[i + 1] - name_off[i]));
        *p++ = '\t';
        p = put_int(p, flag[i]); *p++ = '\t';
        int32_t r = rname_idx[i];
        p = put_str(p, (const char*)(refname_buf + refname_off[r]),
                    (int)(refname_off[r + 1] - refname_off[r]));
        *p++ = '\t';
        p = put_int(p, pos1[i]); *p++ = '\t';
        p = put_int(p, mapq[i]); *p++ = '\t';
        if (c5[i]) { p = put_int(p, c5[i]); *p++ = 'S'; }
        p = put_int(p, mid[i]); *p++ = 'M';
        if (c3[i]) { p = put_int(p, c3[i]); *p++ = 'S'; }
        p = put_str(p, "\t*\t0\t0\t", 7);
        int seq_len = (int)(seq_off[i + 1] - seq_off[i]);
        p = put_str(p, (const char*)(seq_buf + seq_off[i]), seq_len);
        *p++ = '\t';
        p = put_str(p, (const char*)(qual_buf + seq_off[i]), seq_len);
        // optional fields
        p = put_tag_i(p, "AS", score[i]);
        if (zs[i] != INT32_MIN) p = put_tag_i(p, "ZS", zs[i]);
        p = put_str(p, "\tXN:i:0", 7);
        p = put_tag_i(p, "XM", nmm[i]);
        p = put_str(p, "\tXO:i:0\tXG:i:0", 14);
        p = put_tag_i(p, "NM", nm[i]);
        // MD
        p = put_str(p, "\tMD:Z:", 6);
        int64_t m0 = mm_off[i], m1 = mm_off[i + 1];
        int32_t last = -1;
        for (int64_t m = m0; m < m1; m++) {
            p = put_int(p, mm_cols[m] - last - 1);
            *p++ = (char)mm_ref[m];
            last = mm_cols[m];
        }
        p = put_int(p, mid[i] - 1 - last);
        p = put_str(p, "\tYT:Z:UU", 8);
        p = put_tag_i(p, "NH", nh[i]);
        *p++ = '\n';
        rec_ends[i] = p - out;
    }
    return p - out;
}

// Paired records: same column layout as format_se_batch2 plus mate
// fields (RNEXT is always "=", PNEXT/TLEN given) and a YT:Z code
// (0 UU, 1 CP, 2 DP, 3 UP). ZS slot doubles for the unpaired-mate path.
// Spliced columns (optional, may be null): gapn[i] > 0 writes the CIGAR
// as c5S m1M gapN (mid-m1)M c3S (one intron); xs[i] (0 none / 1 '+' /
// 2 '-') adds the XS:A strand tag (sam.h:930-940).
int64_t format_pe_batch(
    int32_t nrec,
    const int32_t* read_of, const int32_t* flag,
    const int32_t* rname_idx, const int32_t* pos1, const int32_t* mapq,
    const int32_t* c5, const int32_t* mid, const int32_t* c3,
    const int32_t* pnext1, const int32_t* tlen, const int32_t* yt_code,
    const int32_t* score, const int32_t* nmm, const int32_t* nm,
    const int32_t* zs, const int32_t* nh,
    const uint8_t* name_buf, const int64_t* name_off,
    const uint8_t* seq_f, const uint8_t* qual_f,
    const uint8_t* seq_r, const uint8_t* qual_r, const int64_t* seq_off,
    const int32_t* mm_cols, const uint8_t* mm_ref, const int64_t* mm_off,
    const uint8_t* refname_buf, const int64_t* refname_off,
    char* out, int64_t cap, int64_t* rec_ends,
    const int32_t* m1, const int32_t* gapn, const int32_t* xs)
{
    static const char* yts[4] = {"UU", "CP", "DP", "UP"};
    char* p = out;
    for (int32_t i = 0; i < nrec; i++) {
        int32_t rd = read_of[i];
        int name_len = (int)(name_off[rd + 1] - name_off[rd]);
        int seq_len = (int)(seq_off[rd + 1] - seq_off[rd]);
        int32_t r = rname_idx[i];
        int rn_len = (int)(refname_off[r + 1] - refname_off[r]);
        int64_t n_mm = mm_off[i + 1] - mm_off[i];
        int64_t worst = 270 + name_len + rn_len + 2 * (int64_t)seq_len
                        + 12 * n_mm;
        if ((p - out) + worst > cap) return -1 - (int64_t)i;
        p = put_str(p, (const char*)(name_buf + name_off[rd]), name_len);
        *p++ = '\t';
        p = put_int(p, flag[i]); *p++ = '\t';
        p = put_str(p, (const char*)(refname_buf + refname_off[r]), rn_len);
        *p++ = '\t';
        p = put_int(p, pos1[i]); *p++ = '\t';
        p = put_int(p, mapq[i]); *p++ = '\t';
        if (c5[i]) { p = put_int(p, c5[i]); *p++ = 'S'; }
        if (gapn && gapn[i] > 0) {
            p = put_int(p, m1[i]); *p++ = 'M';
            p = put_int(p, gapn[i]); *p++ = 'N';
            p = put_int(p, mid[i] - m1[i]); *p++ = 'M';
        } else {
            p = put_int(p, mid[i]); *p++ = 'M';
        }
        if (c3[i]) { p = put_int(p, c3[i]); *p++ = 'S'; }
        p = put_str(p, "\t=\t", 3);
        p = put_int(p, pnext1[i]); *p++ = '\t';
        p = put_int(p, tlen[i]); *p++ = '\t';
        const uint8_t* sq = (flag[i] & 16) ? seq_r : seq_f;
        const uint8_t* ql = (flag[i] & 16) ? qual_r : qual_f;
        p = put_str(p, (const char*)(sq + seq_off[rd]), seq_len);
        *p++ = '\t';
        p = put_str(p, (const char*)(ql + seq_off[rd]), seq_len);
        p = put_tag_i(p, "AS", score[i]);
        if (zs[i] != INT32_MIN) p = put_tag_i(p, "ZS", zs[i]);
        p = put_str(p, "\tXN:i:0", 7);
        p = put_tag_i(p, "XM", nmm[i]);
        p = put_str(p, "\tXO:i:0\tXG:i:0", 14);
        p = put_tag_i(p, "NM", nm[i]);
        p = put_str(p, "\tMD:Z:", 6);
        int64_t mm0 = mm_off[i], mm1 = mm_off[i + 1];
        int32_t last = -1;
        for (int64_t m = mm0; m < mm1; m++) {
            p = put_int(p, mm_cols[m] - last - 1);
            *p++ = (char)mm_ref[m];
            last = mm_cols[m];
        }
        p = put_int(p, mid[i] - 1 - last);
        if (xs && xs[i]) {
            p = put_str(p, "\tXS:A:", 6);
            *p++ = (xs[i] == 1) ? '+' : '-';
        }
        p = put_str(p, "\tYT:Z:", 6);
        p = put_str(p, yts[yt_code[i] & 3], 2);
        p = put_tag_i(p, "NH", nh[i]);
        *p++ = '\n';
        rec_ends[i] = p - out;
    }
    return p - out;
}

// Format nrec SE records, possibly several per read (-k multi-mapping
// fast path). Per-record arrays are indexed by record; name/seq data is
// per READ via read_of[] indirection, with both orientations of SEQ/QUAL
// precomputed so secondary alignments on the other strand print correctly
// (flag bit 0x10 selects the reverse-complement buffers).
//
// Writes are bounds-checked against cap: the per-record worst case is
// computed before writing and the function returns -1 - i (first record i
// that did not fit) so the host can retry with a larger buffer — fixed
// buffer sizing is computed host-side from the true name/refname/seq
// lengths.
// Spliced columns (optional, may be null): gapn[i] > 0 writes the CIGAR
// as c5S m1M gapN (mid-m1)M c3S (one intron); xs[i] (0 none / 1 '+' /
// 2 '-') adds the XS:A strand tag between MD and YT (sam.h:930-940).
int64_t format_se_batch2(
    int32_t nrec,
    const int32_t* read_of, const int32_t* flag,
    const int32_t* rname_idx, const int32_t* pos1, const int32_t* mapq,
    const int32_t* c5, const int32_t* mid, const int32_t* c3,
    const int32_t* score, const int32_t* nmm, const int32_t* nm,
    const int32_t* zs,            // INT32_MIN = absent
    const int32_t* nh,
    const uint8_t* name_buf, const int64_t* name_off,
    const uint8_t* seq_f, const uint8_t* qual_f,
    const uint8_t* seq_r, const uint8_t* qual_r, const int64_t* seq_off,
    const int32_t* mm_cols, const uint8_t* mm_ref, const int64_t* mm_off,
    const uint8_t* refname_buf, const int64_t* refname_off,
    char* out, int64_t cap, int64_t* rec_ends,
    const int32_t* m1, const int32_t* gapn, const int32_t* xs)
{
    char* p = out;
    for (int32_t i = 0; i < nrec; i++) {
        int32_t rd = read_of[i];
        int name_len = (int)(name_off[rd + 1] - name_off[rd]);
        int seq_len = (int)(seq_off[rd + 1] - seq_off[rd]);
        int32_t r = rname_idx[i];
        if (r < 0) {
            // unaligned record (flag 4); mapq column carries the YF code
            // (0 none, 1 NS, 2 LN, 3 QC) — matches io/sam.format_unaligned
            int64_t worst = 64 + name_len + 2 * (int64_t)seq_len;
            if ((p - out) + worst > cap) return -1 - (int64_t)i;
            p = put_str(p, (const char*)(name_buf + name_off[rd]), name_len);
            *p++ = '\t';
            p = put_str(p, "4\t*\t0\t0\t*\t*\t0\t0\t", 16);
            p = put_str(p, (const char*)(seq_f + seq_off[rd]), seq_len);
            *p++ = '\t';
            p = put_str(p, (const char*)(qual_f + seq_off[rd]), seq_len);
            int32_t yf = mapq[i];
            if (yf == 1) p = put_str(p, "\tYF:Z:NS", 8);
            else if (yf == 2) p = put_str(p, "\tYF:Z:LN", 8);
            else if (yf == 3) p = put_str(p, "\tYF:Z:QC", 8);
            p = put_str(p, "\tYT:Z:UU", 8);
            *p++ = '\n';
            rec_ends[i] = p - out;
            continue;
        }
        int rn_len = (int)(refname_off[r + 1] - refname_off[r]);
        int64_t n_mm = mm_off[i + 1] - mm_off[i];
        // worst case: fixed fields/tags ~230 + variable parts
        int64_t worst = 230 + name_len + rn_len + 2 * (int64_t)seq_len
                        + 12 * n_mm;
        if ((p - out) + worst > cap) return -1 - (int64_t)i;
        p = put_str(p, (const char*)(name_buf + name_off[rd]), name_len);
        *p++ = '\t';
        p = put_int(p, flag[i]); *p++ = '\t';
        p = put_str(p, (const char*)(refname_buf + refname_off[r]), rn_len);
        *p++ = '\t';
        p = put_int(p, pos1[i]); *p++ = '\t';
        p = put_int(p, mapq[i]); *p++ = '\t';
        if (c5[i]) { p = put_int(p, c5[i]); *p++ = 'S'; }
        if (gapn && gapn[i] > 0) {
            p = put_int(p, m1[i]); *p++ = 'M';
            p = put_int(p, gapn[i]); *p++ = 'N';
            p = put_int(p, mid[i] - m1[i]); *p++ = 'M';
        } else {
            p = put_int(p, mid[i]); *p++ = 'M';
        }
        if (c3[i]) { p = put_int(p, c3[i]); *p++ = 'S'; }
        p = put_str(p, "\t*\t0\t0\t", 7);
        const uint8_t* sq = (flag[i] & 16) ? seq_r : seq_f;
        const uint8_t* ql = (flag[i] & 16) ? qual_r : qual_f;
        p = put_str(p, (const char*)(sq + seq_off[rd]), seq_len);
        *p++ = '\t';
        p = put_str(p, (const char*)(ql + seq_off[rd]), seq_len);
        p = put_tag_i(p, "AS", score[i]);
        if (zs[i] != INT32_MIN) p = put_tag_i(p, "ZS", zs[i]);
        p = put_str(p, "\tXN:i:0", 7);
        p = put_tag_i(p, "XM", nmm[i]);
        p = put_str(p, "\tXO:i:0\tXG:i:0", 14);
        p = put_tag_i(p, "NM", nm[i]);
        p = put_str(p, "\tMD:Z:", 6);
        int64_t m0 = mm_off[i], m1 = mm_off[i + 1];
        int32_t last = -1;
        for (int64_t m = m0; m < m1; m++) {
            p = put_int(p, mm_cols[m] - last - 1);
            *p++ = (char)mm_ref[m];
            last = mm_cols[m];
        }
        p = put_int(p, mid[i] - 1 - last);
        if (xs && xs[i]) {
            p = put_str(p, "\tXS:A:", 6);
            *p++ = (xs[i] == 1) ? '+' : '-';
        }
        p = put_str(p, "\tYT:Z:UU", 8);
        p = put_tag_i(p, "NH", nh[i]);
        *p++ = '\n';
        rec_ends[i] = p - out;
    }
    return p - out;
}

// format_se_batch3 — the threaded finish-stage formatter.
//
// Same record layout as format_se_batch2, but takes the read data RAW
// (2-bit-ish base codes 0..4 and phred qualities straight out of the
// batch arrays) and derives ASCII SEQ/QUAL, reverse complements, and MD
// mismatch columns itself; and it runs on an internal std::thread pool
// (ctypes releases the GIL for the whole call). This removes the
// finish-stage's NumPy prep — seq decode, revcomp flip, boolean-mask
// packing — which held the GIL and serialized the Python worker threads
// (the host finish stage was the end-to-end throughput bound).
//
// Per-record mismatch data comes as the fastpack's packed mm lanes
// (col<<3 | refchar-code) plus a count, already relative to the aligned
// region start minus c5 handled here.
//
// rows[] maps local fast-read index -> batch row (seq_codes/quals/lens
// are full-batch arrays). Threads format disjoint record chunks into
// worst-case-sized regions of `out`, then chunks are compacted in place.
namespace {

struct B3Cols {
    const int32_t *read_of, *flag, *rname_idx, *pos1, *mapq;
    const int32_t *c5, *mid, *c3, *score, *nmm, *zs, *nh;
    const int16_t* mm_lanes;   // (nrec, mm_stride) packed col<<3|ref
    const int32_t* mm_cnt;
    int32_t mm_stride;
    const uint8_t* name_buf; const int64_t* name_off;
    const int32_t* rows;       // local read idx -> batch row
    const uint8_t* seq_codes;  // (B, Lp) codes 0..4
    const uint8_t* quals;      // (B, Lp) phred 0..93 (ignored if qconst>=0)
    int32_t qconst;
    int64_t Lp;
    const int32_t* lens;       // per local fast read
    const uint8_t* refname_buf; const int64_t* refname_off;
    const int32_t *m1, *gapn, *xs;   // spliced (nullable)
};

const char B3_DEC[6] = {'A', 'C', 'G', 'T', 'N', 'N'};
const char B3_COMP[6] = {'T', 'G', 'C', 'A', 'N', 'N'};

inline char* b3_seq_qual(char* p, const B3Cols& c, int32_t rd, bool rc) {
    int32_t row = c.rows ? c.rows[rd] : rd;
    int32_t len = c.lens[rd];
    const uint8_t* s = c.seq_codes + (int64_t)row * c.Lp;
    if (!rc) {
        for (int32_t j = 0; j < len; j++) *p++ = B3_DEC[s[j] > 4 ? 4 : s[j]];
    } else {
        for (int32_t j = len - 1; j >= 0; j--)
            *p++ = B3_COMP[s[j] > 4 ? 4 : s[j]];
    }
    *p++ = '\t';
    if (c.qconst >= 0) {
        char q = (char)(33 + (c.qconst > 93 ? 93 : c.qconst));
        std::memset(p, q, (size_t)len);
        p += len;
    } else {
        const uint8_t* q = c.quals + (int64_t)row * c.Lp;
        if (!rc) {
            for (int32_t j = 0; j < len; j++)
                *p++ = (char)(33 + (q[j] > 93 ? 93 : q[j]));
        } else {
            for (int32_t j = len - 1; j >= 0; j--)
                *p++ = (char)(33 + (q[j] > 93 ? 93 : q[j]));
        }
    }
    return p;
}

int64_t b3_chunk(const B3Cols& c, int32_t i0, int32_t i1,
                 char* out, int64_t cap, int64_t* rec_ends) {
    char* p = out;
    for (int32_t i = i0; i < i1; i++) {
        int32_t rd = c.read_of[i];
        int name_len = (int)(c.name_off[rd + 1] - c.name_off[rd]);
        int32_t seq_len = c.lens[rd];
        int32_t r = c.rname_idx[i];
        if (r < 0) {
            int64_t worst = 64 + name_len + 2 * (int64_t)seq_len;
            if ((p - out) + worst > cap) return -1;
            p = put_str(p, (const char*)(c.name_buf + c.name_off[rd]),
                        name_len);
            *p++ = '\t';
            p = put_str(p, "4\t*\t0\t0\t*\t*\t0\t0\t", 16);
            p = b3_seq_qual(p, c, rd, false);
            int32_t yf = c.mapq[i];
            if (yf == 1) p = put_str(p, "\tYF:Z:NS", 8);
            else if (yf == 2) p = put_str(p, "\tYF:Z:LN", 8);
            else if (yf == 3) p = put_str(p, "\tYF:Z:QC", 8);
            p = put_str(p, "\tYT:Z:UU", 8);
            *p++ = '\n';
            rec_ends[i] = p - out;
            continue;
        }
        int rn_len = (int)(c.refname_off[r + 1] - c.refname_off[r]);
        int32_t n_mm = c.mm_cnt[i];
        int64_t worst = 230 + name_len + rn_len + 2 * (int64_t)seq_len
                        + 12 * (int64_t)n_mm;
        if ((p - out) + worst > cap) return -1;
        p = put_str(p, (const char*)(c.name_buf + c.name_off[rd]), name_len);
        *p++ = '\t';
        p = put_int(p, c.flag[i]); *p++ = '\t';
        p = put_str(p, (const char*)(c.refname_buf + c.refname_off[r]),
                    rn_len);
        *p++ = '\t';
        p = put_int(p, c.pos1[i]); *p++ = '\t';
        p = put_int(p, c.mapq[i]); *p++ = '\t';
        if (c.c5[i]) { p = put_int(p, c.c5[i]); *p++ = 'S'; }
        if (c.gapn && c.gapn[i] > 0) {
            p = put_int(p, c.m1[i]); *p++ = 'M';
            p = put_int(p, c.gapn[i]); *p++ = 'N';
            p = put_int(p, c.mid[i] - c.m1[i]); *p++ = 'M';
        } else {
            p = put_int(p, c.mid[i]); *p++ = 'M';
        }
        if (c.c3[i]) { p = put_int(p, c.c3[i]); *p++ = 'S'; }
        p = put_str(p, "\t*\t0\t0\t", 7);
        p = b3_seq_qual(p, c, rd, (c.flag[i] & 16) != 0);
        p = put_tag_i(p, "AS", c.score[i]);
        if (c.zs[i] != INT32_MIN) p = put_tag_i(p, "ZS", c.zs[i]);
        p = put_str(p, "\tXN:i:0", 7);
        p = put_tag_i(p, "XM", c.nmm[i]);
        p = put_str(p, "\tXO:i:0\tXG:i:0", 14);
        p = put_tag_i(p, "NM", c.nmm[i]);
        p = put_str(p, "\tMD:Z:", 6);
        const int16_t* lanes = c.mm_lanes + (int64_t)i * c.mm_stride;
        int32_t last = -1;
        int32_t cc5 = c.c5[i];
        for (int32_t m = 0; m < n_mm; m++) {
            int32_t col = ((int32_t)(uint16_t)lanes[m] >> 3) - cc5;
            int32_t ch = lanes[m] & 7;
            p = put_int(p, col - last - 1);
            *p++ = B3_DEC[ch > 4 ? 4 : ch];
            last = col;
        }
        p = put_int(p, c.mid[i] - 1 - last);
        if (c.xs && c.xs[i]) {
            p = put_str(p, "\tXS:A:", 6);
            *p++ = (c.xs[i] == 1) ? '+' : '-';
        }
        p = put_str(p, "\tYT:Z:UU", 8);
        p = put_tag_i(p, "NH", c.nh[i]);
        *p++ = '\n';
        rec_ends[i] = p - out;
    }
    return p - out;
}

}  // namespace

int64_t format_se_batch3(
    int32_t nrec, int32_t nthreads,
    const int32_t* read_of, const int32_t* flag,
    const int32_t* rname_idx, const int32_t* pos1, const int32_t* mapq,
    const int32_t* c5, const int32_t* mid, const int32_t* c3,
    const int32_t* score, const int32_t* nmm,
    const int32_t* zs, const int32_t* nh,
    const int16_t* mm_lanes, const int32_t* mm_cnt, int32_t mm_stride,
    const uint8_t* name_buf, const int64_t* name_off,
    const int32_t* rows, const uint8_t* seq_codes, const uint8_t* quals,
    int32_t qconst, int64_t Lp, const int32_t* lens,
    const uint8_t* refname_buf, const int64_t* refname_off,
    char* out, int64_t cap, int64_t* rec_ends,
    const int32_t* m1, const int32_t* gapn, const int32_t* xs)
{
    B3Cols c{read_of, flag, rname_idx, pos1, mapq, c5, mid, c3,
             score, nmm, zs, nh, mm_lanes, mm_cnt, mm_stride,
             name_buf, name_off, rows, seq_codes, quals, qconst, Lp,
             lens, refname_buf, refname_off, m1, gapn, xs};
    if (nthreads <= 1 || nrec < 2048) {
        return b3_chunk(c, 0, nrec, out, cap, rec_ends);
    }
    int NT = nthreads > 8 ? 8 : nthreads;
    // per-chunk worst-case regions inside `out`; compact afterwards
    std::vector<int32_t> starts(NT + 1);
    std::vector<int64_t> bases(NT + 1), sizes(NT);
    for (int t = 0; t <= NT; t++)
        starts[t] = (int32_t)((int64_t)nrec * t / NT);
    bases[0] = 0;
    for (int t = 0; t < NT; t++) {
        int64_t w = 0;
        for (int32_t i = starts[t]; i < starts[t + 1]; i++) {
            int32_t rd = read_of[i];
            int64_t nl = name_off[rd + 1] - name_off[rd];
            int32_t r = rname_idx[i];
            int64_t rl = r >= 0 ? refname_off[r + 1] - refname_off[r] : 0;
            w += 240 + nl + rl + 2 * (int64_t)lens[rd]
                 + 12 * (int64_t)(r >= 0 ? mm_cnt[i] : 0);
        }
        bases[t + 1] = bases[t] + w;
    }
    if (bases[NT] > cap) return -1;   // host sizes cap from the same formula
    std::vector<std::thread> ths;
    for (int t = 0; t < NT; t++) {
        ths.emplace_back([&, t]() {
            sizes[t] = b3_chunk(c, starts[t], starts[t + 1],
                                out + bases[t], bases[t + 1] - bases[t],
                                rec_ends);
        });
    }
    for (auto& th : ths) th.join();
    for (int t = 0; t < NT; t++) if (sizes[t] < 0) return -1;
    // compact chunks; rec_ends are chunk-relative -> absolute
    int64_t w = sizes[0];
    for (int t = 1; t < NT; t++) {
        std::memmove(out + w, out + bases[t], (size_t)sizes[t]);
        for (int32_t i = starts[t]; i < starts[t + 1]; i++)
            rec_ends[i] += w;
        w += sizes[t];
    }
    return w;
}

// pack_reads_2bit — submit-stage transfer packing (ReadBatch.packed):
// 2-bit base words + N bitmask + constant-quality detection in one
// threaded pass with the GIL released (the NumPy reshape/shift/reduce
// version cost ~12ms of GIL per 16K-read batch on the submit thread).
// Returns the constant quality value, or -1 if per-base quals vary,
// or 40 if the batch has no in-read positions.
int32_t pack_reads_2bit(
    int32_t B, int64_t L, int32_t nthreads,
    const uint8_t* seqs, const uint8_t* quals, const int64_t* lens,
    uint32_t* seq_words, uint32_t* n_words)
{
    int64_t Lw = (L + 15) / 16;
    int64_t Ln = (L + 31) / 32;
    int NT = nthreads < 1 ? 1 : (nthreads > 8 ? 8 : nthreads);
    std::vector<int32_t> qc(NT, -2);     // -2 = no positions seen yet
    uint8_t q0 = 0;
    bool have_q0 = false;
    for (int32_t i = 0; i < B && !have_q0; i++)
        if (lens[i] > 0) { q0 = quals[(int64_t)i * L]; have_q0 = true; }
    std::vector<std::thread> ths;
    std::vector<uint8_t> vary(NT, 0);
    auto work = [&](int t) {
        int32_t i0 = (int32_t)((int64_t)B * t / NT);
        int32_t i1 = (int32_t)((int64_t)B * (t + 1) / NT);
        for (int32_t i = i0; i < i1; i++) {
            const uint8_t* s = seqs + (int64_t)i * L;
            const uint8_t* q = quals + (int64_t)i * L;
            int64_t len = lens[i];
            uint32_t* sw = seq_words + (int64_t)i * Lw;
            uint32_t* nw = n_words + (int64_t)i * Ln;
            for (int64_t w = 0; w < Lw; w++) {
                uint32_t v = 0;
                int64_t base = w * 16;
                int64_t hi = base + 16 < L ? base + 16 : L;
                for (int64_t j = base; j < hi; j++) {
                    uint32_t cc = s[j];
                    v |= (cc > 3 ? 3u : cc) << (2 * (j - base));
                }
                sw[w] = v;
            }
            for (int64_t w = 0; w < Ln; w++) {
                uint32_t v = 0;
                int64_t base = w * 32;
                int64_t hi = base + 32 < L ? base + 32 : L;
                for (int64_t j = base; j < hi; j++)
                    if (s[j] > 3) v |= 1u << (j - base);
                nw[w] = v;
            }
            if (!vary[t])
                for (int64_t j = 0; j < len; j++)
                    if (q[j] != q0) { vary[t] = 1; break; }
        }
    };
    if (NT == 1) work(0);
    else {
        for (int t = 0; t < NT; t++) ths.emplace_back(work, t);
        for (auto& th : ths) th.join();
    }
    if (!have_q0) return 40;
    for (int t = 0; t < NT; t++) if (vary[t]) return -1;
    return (int32_t)q0;
}

// finish_se_native — the whole SE fastpack finish stage in one call:
// fastpack -> fast-read mask + record columns + formatted SAM bytes +
// summary stats, replicating align/emit._finish_fastpack's fast path
// byte for byte. Slow rows (mask false) stay with the Python per-read
// ladder. See _finish_fastpack for the field semantics; layout constants
// (FASTPACK_REP=11, MM=4) mirror align/pipeline.py:479.
int64_t finish_se_native(
    int32_t B, int64_t Lp, int32_t nthreads,
    const int16_t* fp, int32_t fpw, int32_t KFB,
    const int32_t* trows0, const int16_t* trep0, int32_t tn0,
    int32_t tk0_0, int32_t tk1_0,
    const int32_t* trows1, const int16_t* trep1, int32_t tn1,
    int32_t tk0_1, int32_t tk1_1,
    const uint8_t* seq_codes, const uint8_t* quals, int32_t qconst,
    const int64_t* lens, const uint8_t* yf_qc,
    const int64_t* frag_joined, const int64_t* frag_len,
    const int64_t* frag_toff, const int32_t* frag_tidx, int32_t nfrag,
    const uint8_t* refname_buf, const int64_t* refname_off,
    const uint8_t* name_buf, const int64_t* name_off,
    double min_I, double min_S, double nceil_I, double nceil_S,
    int32_t match_bonus, int32_t khits, int32_t KF, int32_t omit_sec,
    uint8_t* fast_out, int64_t* read_end,
    char* out, int64_t cap, int64_t* stats,
    int32_t* cols, int16_t* mm_out, int64_t* rec_ends_buf)
{
    const int32_t REP = 11, MM = 4;
    // tier slot maps: batch row -> slot in tier t (-1 none)
    std::vector<int32_t> tslot0(tn0 > 0 ? B : 0, -1),
                         tslot1(tn1 > 0 ? B : 0, -1);
    for (int32_t s = 0; s < tn0; s++)
        if (trows0[s] >= 0 && trows0[s] < B) tslot0[trows0[s]] = s;
    for (int32_t s = 0; s < tn1; s++)
        if (trows1[s] >= 0 && trows1[s] < B) tslot1[trows1[s]] = s;
    int nb0 = tk1_0 - tk0_0, nb1 = tk1_1 - tk0_1;

    // lane fetch for report k of read i; returns false if k rides a tier
    // the read has no slot in
    auto lanes_of = [&](int32_t i, int32_t k, const int16_t** lp) -> bool {
        if (k < KFB) { *lp = fp + (int64_t)i * fpw + 4 + REP * k; return true; }
        if (k < tk1_0) {
            if (tn0 == 0 || tslot0[i] < 0) return false;
            *lp = trep0 + ((int64_t)tslot0[i] * nb0 + (k - tk0_0)) * REP;
            return true;
        }
        if (tn1 == 0 || tslot1[i] < 0) return false;
        *lp = trep1 + ((int64_t)tslot1[i] * nb1 + (k - tk0_1)) * REP;
        return true;
    };
    auto frag_of = [&](int64_t astart) -> int32_t {
        // searchsorted(frag_joined, astart, 'right') - 1
        int32_t lo = 0, hi = nfrag;
        while (lo < hi) {
            int32_t mid = (lo + hi) >> 1;
            if (frag_joined[mid] <= astart) lo = mid + 1; else hi = mid;
        }
        return lo - 1;
    };

    int64_t uniq = 0, multi = 0, unal = 0;
    std::vector<int32_t> nrep_of(B), lens32(B);
    // phase A: fast mask
    for (int32_t i = 0; i < B; i++) {
        const int16_t* f = fp + (int64_t)i * fpw;
        int32_t nvalid = f[0];
        int64_t len = lens[i];
        lens32[i] = (int32_t)len;
        const uint8_t* s = seq_codes + (int64_t)i * Lp;
        int32_t nNs = 0;
        for (int64_t j = 0; j < len; j++) nNs += s[j] > 3;
        bool filtered = (len == 0) || ((double)nNs > nceil_I
                                       + nceil_S * (double)len);
        bool aligned = !filtered && nvalid >= 1;
        int32_t nrep = nvalid < khits ? nvalid : khits;
        nrep_of[i] = aligned ? nrep : 1;
        bool fast = aligned && nrep <= KF && (!omit_sec || nrep <= 1);
        int32_t flags = f[3];
        for (int32_t k = 0; fast && k < nrep && k < KF; k++) {
            const int16_t* lp;
            if (!lanes_of(i, k, &lp)) { fast = false; break; }
            bool gapped = (flags >> (2 * k + 1)) & 1;
            int64_t pos = (uint16_t)lp[0] | ((int64_t)(uint16_t)lp[1] << 16);
            int32_t c5 = lp[2], c3 = lp[3];
            int32_t nmm_all = lp[5];
            int64_t astart = pos + c5;
            int64_t span = len - c5 - c3;
            int32_t fr = frag_of(astart);
            bool ok = fr >= 0 && span > 0 && !gapped && nmm_all <= MM
                      && astart + span <= frag_joined[fr] + frag_len[fr];
            fast = ok;
        }
        if (!aligned) fast = true;
        fast_out[i] = fast;
        if (fast) {
            if (!aligned) unal++;
            else if (nvalid == 1) uniq++;
            else multi++;
        }
    }

    // phase B: record columns for fast rows
    int64_t nrec = 0;
    int32_t* r_read = cols;              // global batch row per record
    int32_t* r_flag; int32_t* r_tidx; int32_t* r_pos1; int32_t* r_mapq;
    int32_t* r_c5; int32_t* r_mid; int32_t* r_c3; int32_t* r_score;
    int32_t* r_nmm; int32_t* r_zs; int32_t* r_nh; int32_t* r_cnt;
    {
        int64_t capr = (int64_t)B * (KF > 1 ? KF : 1);
        r_flag = cols + capr; r_tidx = cols + 2 * capr;
        r_pos1 = cols + 3 * capr; r_mapq = cols + 4 * capr;
        r_c5 = cols + 5 * capr; r_mid = cols + 6 * capr;
        r_c3 = cols + 7 * capr; r_score = cols + 8 * capr;
        r_nmm = cols + 9 * capr; r_zs = cols + 10 * capr;
        r_nh = cols + 11 * capr; r_cnt = cols + 12 * capr;
    }
    for (int32_t i = 0; i < B; i++) {
        if (!fast_out[i]) continue;
        const int16_t* f = fp + (int64_t)i * fpw;
        int32_t nvalid = f[0], best = f[1], secb = f[2], flags = f[3];
        bool has_sec = secb != -32768;
        int64_t len = lens[i];
        const uint8_t* s = seq_codes + (int64_t)i * Lp;
        int32_t nNs = 0;
        for (int64_t j = 0; j < len; j++) nNs += s[j] > 3;
        bool filtered = (len == 0) || ((double)nNs > nceil_I
                                       + nceil_S * (double)len);
        bool aligned = !filtered && nvalid >= 1;
        if (!aligned) {
            // one flag-4 record; YF code rides the mapq column
            r_read[nrec] = i; r_flag[nrec] = 4; r_tidx[nrec] = -1;
            r_pos1[nrec] = 0;
            int32_t yf = 0;
            if (len == 0) yf = (yf_qc && yf_qc[i]) ? 3 : 2;
            else if (filtered) yf = 1;
            r_mapq[nrec] = yf;
            r_c5[nrec] = r_mid[nrec] = r_c3[nrec] = 0;
            r_score[nrec] = r_nmm[nrec] = 0;
            r_zs[nrec] = INT32_MIN; r_nh[nrec] = 1; r_cnt[nrec] = 0;
            for (int m = 0; m < MM; m++) mm_out[nrec * MM + m] = 0;
            nrec++;
            continue;
        }
        int32_t nrep = nvalid < khits ? nvalid : khits;
        if (nrep > KF) nrep = KF;
        // primary MAPQ: 60 fast path; table only on equal second-best
        int32_t mq = 60;
        if (has_sec && secb == best) {
            double minsc = min_I + min_S * (double)len;
            int64_t minsc_i = (int64_t)minsc;
            if ((double)minsc_i < minsc) minsc_i++;   // ceil
            int64_t perfect = (int64_t)match_bonus * len;
            int64_t diff = perfect - minsc_i; if (diff < 1) diff = 1;
            int64_t best_over = best - minsc_i;
            // mapq_v2 with bestdiff == 0 (align/mapq.py tail case)
            mq = ((double)best_over >= (double)diff * 0.67) ? 1 : 0;
        }
        for (int32_t k = 0; k < nrep; k++) {
            const int16_t* lp; lanes_of(i, k, &lp);
            int64_t pos = (uint16_t)lp[0] | ((int64_t)(uint16_t)lp[1] << 16);
            int32_t c5 = lp[2], c3 = lp[3];
            int64_t astart = pos + c5;
            int32_t fr = frag_of(astart);
            r_read[nrec] = i;
            r_flag[nrec] = (((flags >> (2 * k)) & 1) ? 0 : 16)
                           | (k > 0 ? 256 : 0);
            r_tidx[nrec] = frag_tidx[fr];
            r_pos1[nrec] = (int32_t)(frag_toff[fr] + astart
                                     - frag_joined[fr] + 1);
            r_mapq[nrec] = k == 0 ? mq : 255;
            r_c5[nrec] = c5; r_c3[nrec] = c3;
            r_mid[nrec] = (int32_t)(len - c5 - c3);
            r_score[nrec] = lp[6];
            r_nmm[nrec] = lp[4];
            r_zs[nrec] = has_sec ? secb : INT32_MIN;
            r_nh[nrec] = nrep;
            r_cnt[nrec] = lp[5];
            for (int m = 0; m < MM; m++)
                mm_out[nrec * MM + m] = lp[7 + m];
            nrec++;
        }
    }
    stats[0] = uniq; stats[1] = multi; stats[2] = unal; stats[3] = nrec;

    // phase C: format (threaded); read_of = global batch row, rows = id
    B3Cols c{r_read, r_flag, r_tidx, r_pos1, r_mapq, r_c5, r_mid, r_c3,
             r_score, r_nmm, r_zs, r_nh, mm_out, r_cnt, MM,
             name_buf, name_off, nullptr, seq_codes, quals, qconst, Lp,
             lens32.data(), refname_buf, refname_off,
             nullptr, nullptr, nullptr};
    int64_t total;
    int NT = nthreads < 1 ? 1 : (nthreads > 8 ? 8 : nthreads);
    if (NT <= 1 || nrec < 2048) {
        total = b3_chunk(c, 0, (int32_t)nrec, out, cap, rec_ends_buf);
        if (total < 0) return -1;
    } else {
        std::vector<int32_t> starts(NT + 1);
        std::vector<int64_t> bases(NT + 1), sizes(NT);
        for (int t = 0; t <= NT; t++)
            starts[t] = (int32_t)(nrec * t / NT);
        bases[0] = 0;
        for (int t = 0; t < NT; t++) {
            int64_t w = 0;
            for (int32_t i = starts[t]; i < starts[t + 1]; i++) {
                int32_t rd = r_read[i];
                int64_t nl = name_off[rd + 1] - name_off[rd];
                int32_t r = r_tidx[i];
                int64_t rl = r >= 0 ? refname_off[r + 1] - refname_off[r] : 0;
                w += 240 + nl + rl + 2 * lens[rd] + 12 * (int64_t)MM;
            }
            bases[t + 1] = bases[t] + w;
        }
        if (bases[NT] > cap) return -1;
        std::vector<std::thread> ths;
        for (int t = 0; t < NT; t++)
            ths.emplace_back([&, t]() {
                sizes[t] = b3_chunk(c, starts[t], starts[t + 1],
                                    out + bases[t], bases[t + 1] - bases[t],
                                    rec_ends_buf);
            });
        for (auto& th : ths) th.join();
        for (int t = 0; t < NT; t++) if (sizes[t] < 0) return -1;
        int64_t w = sizes[0];
        for (int t = 1; t < NT; t++) {
            std::memmove(out + w, out + bases[t], (size_t)sizes[t]);
            for (int32_t i = starts[t]; i < starts[t + 1]; i++)
                rec_ends_buf[i] += w;
            w += sizes[t];
        }
        total = w;
    }
    // read_end: end offset of each fast read's LAST record
    for (int64_t i = 0; i < nrec; i++)
        read_end[r_read[i]] = rec_ends_buf[i];
    return total;
}

// finish_pe_native — the paired-end analog of finish_se_native:
// pe-pack (align/paired.py PEPACK_* layout) -> fast-pair mask +
// interleaved mate1/mate2 record columns + SAM bytes + stats in one
// threaded GIL-released call, replicating _finish_pe_pack's fast path
// byte for byte. Slow pairs stay with the Python per-pair ladder.
namespace {

struct PECols {
    const int32_t *rd;       // pair*2 + mate
    const int32_t *flag, *rname, *pos1, *mapq, *c5, *mid, *c3;
    const int32_t *pnext1, *tlen, *score, *nmm, *nh, *cnt;
    const int16_t* mm;       // (nrec, MM)
    int32_t MM;
    const uint8_t* name_buf; const int64_t* name_off;   // per pair
    const uint8_t *seq1, *qual1, *seq2, *qual2;
    int64_t Lp1, Lp2;
    const int32_t *lens1, *lens2;  // per pair row, int32
    int32_t qconst;
    const uint8_t* refname_buf; const int64_t* refname_off;
};

inline char* pe_seq_qual(char* p, const PECols& c, int32_t rd, bool rc) {
    int32_t pair = rd >> 1, mate = rd & 1;
    const uint8_t* s = mate ? c.seq2 + (int64_t)pair * c.Lp2
                            : c.seq1 + (int64_t)pair * c.Lp1;
    int32_t len = mate ? c.lens2[pair] : c.lens1[pair];
    if (!rc) { for (int32_t j = 0; j < len; j++)
                   *p++ = B3_DEC[s[j] > 4 ? 4 : s[j]]; }
    else     { for (int32_t j = len - 1; j >= 0; j--)
                   *p++ = B3_COMP[s[j] > 4 ? 4 : s[j]]; }
    *p++ = '\t';
    if (c.qconst >= 0) {
        char q = (char)(33 + (c.qconst > 93 ? 93 : c.qconst));
        std::memset(p, q, (size_t)len); p += len;
    } else {
        const uint8_t* q = mate ? c.qual2 + (int64_t)pair * c.Lp2
                                : c.qual1 + (int64_t)pair * c.Lp1;
        if (!rc) { for (int32_t j = 0; j < len; j++)
                       *p++ = (char)(33 + (q[j] > 93 ? 93 : q[j])); }
        else     { for (int32_t j = len - 1; j >= 0; j--)
                       *p++ = (char)(33 + (q[j] > 93 ? 93 : q[j])); }
    }
    return p;
}

int64_t pe_chunk(const PECols& c, int32_t i0, int32_t i1,
                 char* out, int64_t cap, int64_t* rec_ends) {
    char* p = out;
    for (int32_t i = i0; i < i1; i++) {
        int32_t rd = c.rd[i], pair = rd >> 1, mate = rd & 1;
        int name_len = (int)(c.name_off[pair + 1] - c.name_off[pair]);
        int32_t seq_len = mate ? c.lens2[pair] : c.lens1[pair];
        int32_t r = c.rname[i];
        int rn_len = (int)(c.refname_off[r + 1] - c.refname_off[r]);
        int32_t n_mm = c.cnt[i];
        int64_t worst = 240 + name_len + rn_len + 2 * (int64_t)seq_len
                        + 12 * (int64_t)n_mm;
        if ((p - out) + worst > cap) return -1;
        p = put_str(p, (const char*)(c.name_buf + c.name_off[pair]),
                    name_len);
        *p++ = '\t';
        p = put_int(p, c.flag[i]); *p++ = '\t';
        p = put_str(p, (const char*)(c.refname_buf + c.refname_off[r]),
                    rn_len);
        *p++ = '\t';
        p = put_int(p, c.pos1[i]); *p++ = '\t';
        p = put_int(p, c.mapq[i]); *p++ = '\t';
        if (c.c5[i]) { p = put_int(p, c.c5[i]); *p++ = 'S'; }
        p = put_int(p, c.mid[i]); *p++ = 'M';
        if (c.c3[i]) { p = put_int(p, c.c3[i]); *p++ = 'S'; }
        p = put_str(p, "\t=\t", 3);
        p = put_int(p, c.pnext1[i]); *p++ = '\t';
        p = put_int(p, c.tlen[i]); *p++ = '\t';
        p = pe_seq_qual(p, c, rd, (c.flag[i] & 16) != 0);
        p = put_tag_i(p, "AS", c.score[i]);
        p = put_str(p, "\tXN:i:0", 7);
        p = put_tag_i(p, "XM", c.nmm[i]);
        p = put_str(p, "\tXO:i:0\tXG:i:0", 14);
        p = put_tag_i(p, "NM", c.nmm[i]);
        p = put_str(p, "\tMD:Z:", 6);
        const int16_t* lanes = c.mm + (int64_t)i * c.MM;
        int32_t last = -1, cc5 = c.c5[i];
        for (int32_t m = 0; m < n_mm; m++) {
            int32_t col = ((int32_t)(uint16_t)lanes[m] >> 3) - cc5;
            p = put_int(p, col - last - 1);
            *p++ = B3_DEC[(lanes[m] & 7) > 4 ? 4 : (lanes[m] & 7)];
            last = col;
        }
        p = put_int(p, c.mid[i] - 1 - last);
        p = put_str(p, "\tYT:Z:CP", 8);
        p = put_tag_i(p, "NH", c.nh[i]);
        *p++ = '\n';
        rec_ends[i] = p - out;
    }
    return p - out;
}

}  // namespace

int64_t finish_pe_native(
    int32_t B, int64_t Lp1, int64_t Lp2, int32_t nthreads,
    const int16_t* fp, int32_t fpw, int32_t NRB,
    const int32_t* trows0, const int16_t* trep0, int32_t tn0,
    int32_t tk0_0, int32_t tk1_0,
    const int32_t* trows1, const int16_t* trep1, int32_t tn1,
    int32_t tk0_1, int32_t tk1_1,
    const uint8_t* seq1, const uint8_t* qual1, const int64_t* lens1,
    const uint8_t* seq2, const uint8_t* qual2, const int64_t* lens2,
    int32_t qconst,
    const int64_t* frag_joined, const int64_t* frag_len,
    const int64_t* frag_toff, const int32_t* frag_tidx, int32_t nfrag,
    const uint8_t* refname_buf, const int64_t* refname_off,
    const uint8_t* name_buf, const int64_t* name_off,
    double min_I, double min_S, int32_t match_bonus,
    int32_t khits, int32_t NR, int32_t omit_sec,
    const uint8_t* force_slow,            // per pair, may be all-zero
    uint8_t* fast_out, int64_t* pair_end,
    char* out, int64_t cap, int64_t* stats,
    int32_t* cols, int16_t* mm_out, int64_t* rec_ends_buf)
{
    const int32_t MATE = 11, REP = 2 * MATE + 1, HDR = 4, MM = 4;
    std::vector<int32_t> tslot0(tn0 > 0 ? B : 0, -1),
                         tslot1(tn1 > 0 ? B : 0, -1);
    for (int32_t s = 0; s < tn0; s++)
        if (trows0[s] >= 0 && trows0[s] < B) tslot0[trows0[s]] = s;
    for (int32_t s = 0; s < tn1; s++)
        if (trows1[s] >= 0 && trows1[s] < B) tslot1[trows1[s]] = s;
    int nb0 = tk1_0 - tk0_0, nb1 = tk1_1 - tk0_1;
    auto lanes_of = [&](int32_t i, int32_t k, const int16_t** lp) -> bool {
        if (k < NRB) { *lp = fp + (int64_t)i * fpw + HDR + REP * k;
                       return true; }
        if (k < tk1_0) {
            if (tn0 == 0 || tslot0[i] < 0) return false;
            *lp = trep0 + ((int64_t)tslot0[i] * nb0 + (k - tk0_0)) * REP;
            return true;
        }
        if (tn1 == 0 || tslot1[i] < 0) return false;
        *lp = trep1 + ((int64_t)tslot1[i] * nb1 + (k - tk0_1)) * REP;
        return true;
    };
    auto frag_of = [&](int64_t astart) -> int32_t {
        int32_t lo = 0, hi = nfrag;
        while (lo < hi) {
            int32_t mid = (lo + hi) >> 1;
            if (frag_joined[mid] <= astart) lo = mid + 1; else hi = mid;
        }
        return lo - 1;
    };

    std::vector<int32_t> l1_32(B), l2_32(B);
    for (int32_t i = 0; i < B; i++) {
        l1_32[i] = (int32_t)lens1[i]; l2_32[i] = (int32_t)lens2[i];
    }

    int64_t npairs = 0, cu = 0, cm = 0, nrec = 0;
    int64_t capr = (int64_t)B * 2 * (NR > 1 ? NR : 1);
    int32_t* r_rd = cols;
    int32_t *r_flag = cols + capr, *r_rname = cols + 2 * capr;
    int32_t *r_pos1 = cols + 3 * capr, *r_mapq = cols + 4 * capr;
    int32_t *r_c5 = cols + 5 * capr, *r_mid = cols + 6 * capr;
    int32_t *r_c3 = cols + 7 * capr, *r_pn = cols + 8 * capr;
    int32_t *r_tl = cols + 9 * capr, *r_sc = cols + 10 * capr;
    int32_t *r_nmm = cols + 11 * capr, *r_nh = cols + 12 * capr;
    int32_t *r_cnt = cols + 13 * capr;

    for (int32_t i = 0; i < B; i++) {
        const int16_t* h = fp + (int64_t)i * fpw;
        int32_t nvalid = h[0], best = h[1], sec = h[2];
        bool has_sec = sec != -32768;
        int32_t nrep = nvalid < khits ? nvalid : khits;
        bool fast = nvalid >= 1 && nrep <= NR && (!omit_sec || nrep <= 1)
                    && !(force_slow && force_slow[i]);
        int64_t len1 = lens1[i], len2 = lens2[i];
        struct RepF { int64_t toff1, toff2; int32_t tidx1, tidx2,
                      c51, c31, c52, c32, sc1, sc2, nm1, nm2,
                      cnt1, cnt2; bool fw1, fw2; const int16_t *m1l, *m2l; };
        RepF rf[16];
        int32_t kmax = nrep < NR ? nrep : NR;
        if (kmax > 16) kmax = 16;
        for (int32_t k = 0; fast && k < kmax; k++) {
            const int16_t* lp;
            if (!lanes_of(i, k, &lp)) { fast = false; break; }
            int32_t rfl = lp[0];
            bool g1 = (rfl >> 1) & 1, g2 = (rfl >> 3) & 1;
            const int16_t* a = lp + 1;
            const int16_t* b = lp + 1 + MATE;
            int64_t pos1v = (uint16_t)a[0] | ((int64_t)(uint16_t)a[1] << 16);
            int64_t pos2v = (uint16_t)b[0] | ((int64_t)(uint16_t)b[1] << 16);
            int32_t c51 = a[2], c31 = a[3], c52 = b[2], c32 = b[3];
            int64_t as1 = pos1v + c51, as2 = pos2v + c52;
            int64_t sp1 = len1 - c51 - c31, sp2 = len2 - c52 - c32;
            int32_t f1 = frag_of(as1), f2 = frag_of(as2);
            bool ok = f1 >= 0 && f2 >= 0 && sp1 > 0 && sp2 > 0
                      && as1 + sp1 <= frag_joined[f1] + frag_len[f1]
                      && as2 + sp2 <= frag_joined[f2] + frag_len[f2]
                      && frag_tidx[f1] == frag_tidx[f2]
                      && !g1 && !g2 && a[5] <= MM && b[5] <= MM;
            if (!ok) { fast = false; break; }
            rf[k] = RepF{frag_toff[f1] + as1 - frag_joined[f1],
                         frag_toff[f2] + as2 - frag_joined[f2],
                         frag_tidx[f1], frag_tidx[f2],
                         c51, c31, c52, c32, a[6], b[6], a[4], b[4],
                         a[5], b[5],
                         ((rfl >> 0) & 1) != 0, ((rfl >> 2) & 1) != 0,
                         a + 7, b + 7};
        }
        fast_out[i] = fast;
        if (!fast) continue;
        npairs++;
        if (nvalid >= 2) cm++; else cu++;
        int32_t mq = 60;
        if (has_sec && sec == best) {
            double ms1 = min_I + min_S * (double)len1;
            double ms2 = min_I + min_S * (double)len2;
            int64_t m1i = (int64_t)ms1; if ((double)m1i < ms1) m1i++;
            int64_t m2i = (int64_t)ms2; if ((double)m2i < ms2) m2i++;
            int64_t minsc = m1i + m2i;
            int64_t perfect = (int64_t)match_bonus * (len1 + len2);
            int64_t diff = perfect - minsc; if (diff < 1) diff = 1;
            int64_t best_over = best - minsc;
            mq = ((double)best_over >= (double)diff * 0.67) ? 1 : 0;
        }
        for (int32_t k = 0; k < kmax; k++) {
            const RepF& r = rf[k];
            int64_t mid1 = len1 - r.c51 - r.c31;
            int64_t mid2 = len2 - r.c52 - r.c32;
            int64_t left = r.toff1 - r.c51 < r.toff2 - r.c52
                           ? r.toff1 - r.c51 : r.toff2 - r.c52;
            int64_t rt1 = r.toff1 + mid1 + r.c31;
            int64_t rt2 = r.toff2 + mid2 + r.c32;
            int64_t right = rt1 > rt2 ? rt1 : rt2;
            int64_t tl = right - left;
            int64_t tl1 = r.toff1 <= r.toff2 ? tl : -tl;
            int32_t mqr = k == 0 ? mq : 255;
            int32_t sup = k > 0 ? 256 : 0;
            // mate1 record
            r_rd[nrec] = i * 2;
            r_flag[nrec] = 1 | 64 | 2 | (r.fw1 ? 0 : 16)
                           | (r.fw2 ? 0 : 32) | sup;
            r_rname[nrec] = r.tidx1;
            r_pos1[nrec] = (int32_t)(r.toff1 + 1);
            r_pn[nrec] = (int32_t)(r.toff2 + 1);
            r_tl[nrec] = (int32_t)tl1;
            r_mapq[nrec] = mqr; r_c5[nrec] = r.c51;
            r_mid[nrec] = (int32_t)mid1; r_c3[nrec] = r.c31;
            r_sc[nrec] = r.sc1; r_nmm[nrec] = r.nm1;
            r_nh[nrec] = nrep; r_cnt[nrec] = r.cnt1;
            for (int m = 0; m < MM; m++)
                mm_out[nrec * MM + m] = r.m1l[m];
            nrec++;
            // mate2 record
            r_rd[nrec] = i * 2 + 1;
            r_flag[nrec] = 1 | 128 | 2 | (r.fw2 ? 0 : 16)
                           | (r.fw1 ? 0 : 32) | sup;
            r_rname[nrec] = r.tidx2;
            r_pos1[nrec] = (int32_t)(r.toff2 + 1);
            r_pn[nrec] = (int32_t)(r.toff1 + 1);
            r_tl[nrec] = (int32_t)(-tl1);
            r_mapq[nrec] = mqr; r_c5[nrec] = r.c52;
            r_mid[nrec] = (int32_t)mid2; r_c3[nrec] = r.c32;
            r_sc[nrec] = r.sc2; r_nmm[nrec] = r.nm2;
            r_nh[nrec] = nrep; r_cnt[nrec] = r.cnt2;
            for (int m = 0; m < MM; m++)
                mm_out[nrec * MM + m] = r.m2l[m];
            nrec++;
        }
    }
    stats[0] = npairs; stats[1] = cu; stats[2] = cm; stats[3] = nrec;

    PECols c{r_rd, r_flag, r_rname, r_pos1, r_mapq, r_c5, r_mid, r_c3,
             r_pn, r_tl, r_sc, r_nmm, r_nh, r_cnt, mm_out, MM,
             name_buf, name_off, seq1, qual1, seq2, qual2, Lp1, Lp2,
             l1_32.data(), l2_32.data(), qconst,
             refname_buf, refname_off};
    int64_t total;
    int NT = nthreads < 1 ? 1 : (nthreads > 8 ? 8 : nthreads);
    if (NT <= 1 || nrec < 2048) {
        total = pe_chunk(c, 0, (int32_t)nrec, out, cap, rec_ends_buf);
        if (total < 0) return -1;
    } else {
        std::vector<int32_t> starts(NT + 1);
        std::vector<int64_t> bases(NT + 1), sizes(NT);
        for (int t = 0; t <= NT; t++)
            starts[t] = (int32_t)(nrec * t / NT);
        bases[0] = 0;
        for (int t = 0; t < NT; t++) {
            int64_t w = 0;
            for (int32_t i = starts[t]; i < starts[t + 1]; i++) {
                int32_t pair = r_rd[i] >> 1;
                int64_t nl = name_off[pair + 1] - name_off[pair];
                int32_t r = r_rname[i];
                int64_t rl = refname_off[r + 1] - refname_off[r];
                int64_t sl = (r_rd[i] & 1) ? lens2[pair] : lens1[pair];
                w += 250 + nl + rl + 2 * sl + 12 * (int64_t)MM;
            }
            bases[t + 1] = bases[t] + w;
        }
        if (bases[NT] > cap) return -1;
        std::vector<std::thread> ths;
        for (int t = 0; t < NT; t++)
            ths.emplace_back([&, t]() {
                sizes[t] = pe_chunk(c, starts[t], starts[t + 1],
                                    out + bases[t], bases[t + 1] - bases[t],
                                    rec_ends_buf);
            });
        for (auto& th : ths) th.join();
        for (int t = 0; t < NT; t++) if (sizes[t] < 0) return -1;
        int64_t w = sizes[0];
        for (int t = 1; t < NT; t++) {
            std::memmove(out + w, out + bases[t], (size_t)sizes[t]);
            for (int32_t i = starts[t]; i < starts[t + 1]; i++)
                rec_ends_buf[i] += w;
            w += sizes[t];
        }
        total = w;
    }
    for (int64_t i = 0; i < nrec; i++)
        pair_end[r_rd[i] >> 1] = rec_ends_buf[i];
    return total;
}

// format_pe_mix — mixed/unaligned PAIR records (YT:Z:UP), the native
// formatter for the vectorized no-concordant classification in
// align/emit._finish_pe_slow_and_stitch: per record either an aligned
// single mate (clip-only CIGAR + AS/[ZS]/XN/XM/XO/XG/NM/MD/YT/NH tags,
// reference SamConfig optional-field order) or an unaligned mate
// (CIGAR '*', mate RNAME/POS when the other mate mapped). TLEN is 0 on
// every mixed record (io/sam.py format_aligned pairs w/o mate_mapped).
// r_rname < 0 prints '*' and POS 0; r_rnext 1 prints '=', 0 prints '*'.
// mm lanes: (col_in_read_orientation << 3) | refbase, MD cols relative
// to c5 like pe_chunk. Returns bytes written; rec_ends[k] per record.
int64_t format_pe_mix(
    int32_t nrec,
    const int32_t* r_pair, const int32_t* r_mate, const int32_t* r_flag,
    const int32_t* r_rname, const int32_t* r_pos1, const int32_t* r_mapq,
    const int32_t* r_c5, const int32_t* r_mid, const int32_t* r_c3,
    const int32_t* r_rnext, const int32_t* r_pn1,
    const int32_t* r_score, const int32_t* r_zs,
    const int32_t* r_nmm, const int32_t* r_nh, const int32_t* r_cnt,
    const int16_t* mm, int32_t MMX,
    const uint8_t* name_buf, const int64_t* name_off,
    const uint8_t* seq1, const uint8_t* qual1, int64_t Lp1,
    const int32_t* lens1,
    const uint8_t* seq2, const uint8_t* qual2, int64_t Lp2,
    const int32_t* lens2, int32_t qconst,
    const uint8_t* refname_buf, const int64_t* refname_off,
    char* out, int64_t cap, int64_t* rec_ends)
{
    PECols c{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
             nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
             nullptr, nullptr, nullptr, 0,
             nullptr, nullptr, seq1, qual1, seq2, qual2, Lp1, Lp2,
             lens1, lens2, qconst, nullptr, nullptr};
    char* p = out;
    for (int32_t k = 0; k < nrec; k++) {
        int32_t pair = r_pair[k], mate = r_mate[k];
        int32_t rd = pair * 2 + mate;
        int name_len = (int)(name_off[pair + 1] - name_off[pair]);
        int32_t seq_len = mate ? lens2[pair] : lens1[pair];
        int32_t r = r_rname[k];
        int rn_len = r >= 0
            ? (int)(refname_off[r + 1] - refname_off[r]) : 1;
        int64_t worst = 250 + name_len + rn_len + 2 * (int64_t)seq_len
                        + 12 * (int64_t)MMX;
        if ((p - out) + worst > cap) return -1;
        p = put_str(p, (const char*)(name_buf + name_off[pair]), name_len);
        *p++ = '\t';
        p = put_int(p, r_flag[k]); *p++ = '\t';
        if (r >= 0)
            p = put_str(p, (const char*)(refname_buf + refname_off[r]),
                        rn_len);
        else
            *p++ = '*';
        *p++ = '\t';
        p = put_int(p, r_pos1[k]); *p++ = '\t';
        p = put_int(p, r_mapq[k]); *p++ = '\t';
        bool unal = (r_flag[k] & 4) != 0;
        if (unal) {
            *p++ = '*';
        } else {
            if (r_c5[k]) { p = put_int(p, r_c5[k]); *p++ = 'S'; }
            p = put_int(p, r_mid[k]); *p++ = 'M';
            if (r_c3[k]) { p = put_int(p, r_c3[k]); *p++ = 'S'; }
        }
        *p++ = '\t';
        *p++ = r_rnext[k] ? '=' : '*';
        *p++ = '\t';
        p = put_int(p, r_pn1[k]);
        p = put_str(p, "\t0\t", 3);
        p = pe_seq_qual(p, c, rd, !unal && (r_flag[k] & 16));
        if (!unal) {
            p = put_tag_i(p, "AS", r_score[k]);
            if (r_zs[k] != INT32_MIN) p = put_tag_i(p, "ZS", r_zs[k]);
            p = put_str(p, "\tXN:i:0", 7);
            p = put_tag_i(p, "XM", r_nmm[k]);
            p = put_str(p, "\tXO:i:0\tXG:i:0", 14);
            p = put_tag_i(p, "NM", r_nmm[k]);
            p = put_str(p, "\tMD:Z:", 6);
            const int16_t* lanes = mm + (int64_t)k * MMX;
            int32_t last = -1, cc5 = r_c5[k], n_mm = r_cnt[k];
            for (int32_t m = 0; m < n_mm; m++) {
                int32_t col = ((int32_t)(uint16_t)lanes[m] >> 3) - cc5;
                p = put_int(p, col - last - 1);
                *p++ = B3_DEC[(lanes[m] & 7) > 4 ? 4 : (lanes[m] & 7)];
                last = col;
            }
            p = put_int(p, r_mid[k] - 1 - last);
            p = put_str(p, "\tYT:Z:UP", 8);
            p = put_tag_i(p, "NH", r_nh[k]);
        } else {
            p = put_str(p, "\tYT:Z:UP", 8);
        }
        *p++ = '\n';
        rec_ends[k] = p - out;
    }
    return p - out;
}

}  // extern "C"
