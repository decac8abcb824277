// FASTQ block parser: whole records of a buffer of decompressed FASTQ
// bytes into a batch's dense arrays (io/reads.py: batch_iter's block path
// and read_fastq's per-Read view).
//
// The grammar is the one a line reader over Python's text layer gives
// (universal newlines, str.strip, str.split):
//   * a line ends at "\n", "\r\n" or a lone "\r";
//   * a record is a header line and the three lines after it (sequence,
//     "+" line, qualities); header lines that are blank after stripping
//     are skipped; at the end of the input a missing line reads as empty;
//   * every line is stripped of surrounding whitespace as str.strip
//     strips it (str.isspace, UTF-8 encoded);
//   * the name is the stripped header after its first character, up to
//     the first whitespace;
//   * the input is UTF-8; sequence and quality lines are ASCII.
// A record that breaks these rules, or whose qualities cannot cover its
// sequence in a batch, stops the call with an error code.
//
// Called through ctypes, which releases the interpreter lock for the
// call. Build: g++ -O3 -shared -fPIC -o fastq.so fastq.cpp

#include <cstdint>
#include <cstring>

namespace {

enum Status : int32_t {
    DONE = 0,         // max_records taken, or the buffer ends with the input
    NEED_MORE = 1,    // the buffer ends inside a record: give it more bytes
    WIDER = 2,        // a record needs a row of out[4] bytes
    E_NAME = -1,      // a header with no name
    E_SEQ = -2,       // a non-ASCII character in a sequence line
    E_QUAL = -3,      // a non-ASCII character in a quality line
    E_UTF8 = -4,      // bytes that are not UTF-8
    E_SHORT = -5,     // fewer qualities than bases (batch rows)
};

// Length of the whitespace character (str.isspace) that starts at p, or 0.
inline int ws_at(const uint8_t* p, const uint8_t* e) {
    const uint8_t c = p[0];
    if (c < 0x80)
        return (c == ' ' || (c >= 9 && c <= 13) || (c >= 0x1c && c <= 0x1f));
    if (c == 0xc2)                                     // U+0085, U+00A0
        return (e - p >= 2 && (p[1] == 0x85 || p[1] == 0xa0)) ? 2 : 0;
    if (e - p < 3) return 0;
    if (c == 0xe1) return (p[1] == 0x9a && p[2] == 0x80) ? 3 : 0;  // U+1680
    if (c == 0xe2) {
        if (p[1] == 0x80) {             // U+2000..200A, U+2028/2029, U+202F
            const uint8_t d = p[2];
            return ((d >= 0x80 && d <= 0x8a) || d == 0xa8 || d == 0xa9
                    || d == 0xaf) ? 3 : 0;
        }
        return (p[1] == 0x81 && p[2] == 0x9f) ? 3 : 0;              // U+205F
    }
    if (c == 0xe3) return (p[1] == 0x80 && p[2] == 0x80) ? 3 : 0;  // U+3000
    return 0;
}

// Length of the whitespace character that ends at e (valid UTF-8), or 0.
inline int ws_before(const uint8_t* b, const uint8_t* e) {
    if (e[-1] < 0x80) return ws_at(e - 1, e);
    if (e - b >= 2 && ws_at(e - 2, e) == 2) return 2;
    if (e - b >= 3 && ws_at(e - 3, e) == 3) return 3;
    return 0;
}

// Bytes of the UTF-8 character whose lead byte is c.
inline int char_len(uint8_t c) {
    return c < 0x80 ? 1 : c < 0xe0 ? 2 : c < 0xf0 ? 3 : 4;
}

// [b, e) is UTF-8 as Python's strict decoder takes it (no overlong forms,
// no surrogates, nothing past U+10FFFF).
bool utf8_ok(const uint8_t* b, const uint8_t* e) {
    while (b < e) {
        const uint8_t c = *b;
        if (c < 0x80) { ++b; continue; }
        int n;
        uint8_t lo = 0x80, hi = 0xbf;
        if (c >= 0xc2 && c <= 0xdf) n = 1;
        else if (c == 0xe0) { n = 2; lo = 0xa0; }
        else if (c == 0xed) { n = 2; hi = 0x9f; }
        else if (c >= 0xe1 && c <= 0xef) n = 2;
        else if (c == 0xf0) { n = 3; lo = 0x90; }
        else if (c == 0xf4) { n = 3; hi = 0x8f; }
        else if (c >= 0xf1 && c <= 0xf3) n = 3;
        else return false;
        if (e - b <= n || b[1] < lo || b[1] > hi) return false;
        for (int k = 2; k <= n; ++k)
            if (b[k] < 0x80 || b[k] > 0xbf) return false;
        b += n + 1;
    }
    return true;
}

inline bool ascii(const uint8_t* b, const uint8_t* e) {
    uint8_t acc = 0;
    for (; b < e; ++b) acc |= *b;
    return acc < 0x80;
}

struct Line {
    const uint8_t* b;     // the line, stripped
    const uint8_t* e;
    const uint8_t* next;  // the start of the next line
};

// The line at p: 1, or 0 where the buffer ends before the line's end is
// known (more bytes may follow), or -1 past the input's end (an empty
// line, as readline gives there). Sets *bad where the line is not UTF-8.
inline int read_line(const uint8_t* p, const uint8_t* end, bool at_eof,
                     Line& ln, bool& bad) {
    if (p >= end) {
        if (!at_eof) return 0;
        ln.b = ln.e = ln.next = end;
        return -1;
    }
    const uint8_t* q = p;
    while (q < end && *q != '\n' && *q != '\r') ++q;
    if (q == end) {
        if (!at_eof) return 0;
        ln.next = end;
    } else if (*q == '\r') {
        if (q + 1 == end && !at_eof) return 0;
        ln.next = (q + 1 < end && q[1] == '\n') ? q + 2 : q + 1;
    } else {
        ln.next = q + 1;
    }
    if (!utf8_ok(p, q)) bad = true;
    const uint8_t* b = p;
    const uint8_t* e = q;
    int w;
    while (b < e && (w = ws_at(b, e))) b += w;
    while (e > b && (w = ws_before(b, e))) e -= w;
    ln.b = b;
    ln.e = e;
    return 1;
}

// Python's slice [start:stop] of a sequence of n items: its first item
// and its length.
inline void py_slice(int64_t n, int64_t start, int64_t stop, int64_t& a,
                     int64_t& len) {
    if (start < 0) start = start + n < 0 ? 0 : start + n;
    else if (start > n) start = n;
    if (stop < 0) stop = stop + n < 0 ? 0 : stop + n;
    else if (stop > n) stop = n;
    a = start;
    len = stop > start ? stop - start : 0;
}

}  // namespace

extern "C" {

// Parse whole records from buf[0, nbytes) into rows 0.. of the arrays.
//
// at_eof:      the input ends with the buffer (a last record may be cut).
// max_records: rows to fill at most; skip: records to drop first (parsed
//              and checked, not stored).
// width:       the arrays' row length (a longer record stops the call
//              with WIDER).
// seq_tab:     byte -> base code; qual_tab: byte -> quality (ASCII bytes).
// trim5/trim3: bases cut from each end, as seq[trim5:len - trim3]; the
//              qualities take the same slice.
// ignore_quals: qualities read 30.
// raw:         rows hold the record's own bases and qualities (lens and
//              qlens give each length; width must cover both): a Read's
//              view. Else a batch row: lens bases, their qualities (a
//              single quality stands for every base), padded with code 4
//              and quality 0.
// qual_bytes:  (raw) the quality line's bytes as they are, any UTF-8.
// names:       each row's name and a '\n' (room for nbytes bytes).
// out:         [0] rows filled, [1] bytes consumed (whole records; on an
//              error, up to the record at fault), [2] records skipped,
//              [3] name bytes written, [4] the row length WIDER asks for.
// Returns a Status.
int32_t fastq_parse(const uint8_t* buf, int64_t nbytes, int32_t at_eof,
                    int64_t max_records, int64_t skip, int32_t width,
                    const uint8_t* seq_tab,
                    const int8_t* qual_tab, int64_t trim5, int64_t trim3,
                    int32_t ignore_quals, int32_t raw, int32_t qual_bytes,
                    uint8_t* seqs, int8_t* quals, int32_t* lens,
                    int32_t* qlens, uint8_t* names, int64_t* out) {
    const uint8_t* const end = buf + nbytes;
    const uint8_t* p = buf;
    int64_t rows = 0, skipped = 0, nname = 0;
    int32_t status = DONE;
    out[4] = 0;
    while (rows < max_records) {
        const uint8_t* rec = p;
        bool bad = false;
        Line hd, sq, pl, ql;
        int r;
        while ((r = read_line(p, end, at_eof, hd, bad)) == 1 && hd.b == hd.e
               && !bad)
            rec = p = hd.next;                  // a blank header line
        if (bad) { status = E_UTF8; break; }
        if (r == 0) { status = NEED_MORE; break; }
        if (r == -1) break;                     // the input's end
        if (read_line(hd.next, end, at_eof, sq, bad) == 0
            || read_line(sq.next, end, at_eof, pl, bad) == 0
            || read_line(pl.next, end, at_eof, ql, bad) == 0) {
            status = NEED_MORE;
            break;
        }
        if (bad) { status = E_UTF8; break; }
        // the name: the header after its first character, to whitespace
        const uint8_t* nb = hd.b + char_len(hd.b[0]);
        int w;
        while (nb < hd.e && (w = ws_at(nb, hd.e))) nb += w;
        const uint8_t* ne = nb;
        while (ne < hd.e && !ws_at(ne, hd.e)) ne += char_len(ne[0]);
        if (ne == nb) { status = E_NAME; break; }
        if (!ascii(sq.b, sq.e)) { status = E_SEQ; break; }
        if (!qual_bytes && !ascii(ql.b, ql.e)) { status = E_QUAL; break; }
        if (skipped < skip) {
            ++skipped;
            p = ql.next;
            continue;
        }
        const int64_t ns = sq.e - sq.b, nq = ql.e - ql.b;
        int64_t sa = 0, n = ns, qa = 0, m = nq;
        if (trim5 || trim3) {
            py_slice(ns, trim5, ns - trim3, sa, n);
            py_slice(nq, trim5, ns - trim3, qa, m);
        }
        if (ignore_quals) m = n;
        const int64_t need = raw ? (n > m ? n : m) : n;
        if (need > width) {
            status = WIDER;
            out[4] = need;
            break;
        }
        if (!raw && !ignore_quals && n > 0 && m < n && m != 1) {
            status = E_SHORT;
            break;
        }
        uint8_t* srow = seqs + rows * (int64_t)width;
        int8_t* qrow = quals + rows * (int64_t)width;
        const uint8_t* s = sq.b + sa;
        for (int64_t k = 0; k < n; ++k) srow[k] = seq_tab[s[k]];
        std::memset(srow + n, 4, (size_t)(width - n));
        const int64_t nqual = raw ? m : n;
        const uint8_t* q = ql.b + qa;
        if (ignore_quals) {
            std::memset(qrow, 30, (size_t)nqual);
        } else if (qual_bytes) {
            std::memcpy(qrow, q, (size_t)nqual);
        } else if (m >= nqual) {
            for (int64_t k = 0; k < nqual; ++k) qrow[k] = qual_tab[q[k]];
        } else {                                // one quality for every base
            std::memset(qrow, qual_tab[q[0]], (size_t)nqual);
        }
        std::memset(qrow + nqual, 0, (size_t)(width - nqual));
        lens[rows] = (int32_t)n;
        qlens[rows] = (int32_t)m;
        std::memcpy(names + nname, nb, (size_t)(ne - nb));
        nname += ne - nb;
        names[nname++] = '\n';
        ++rows;
        p = ql.next;
    }
    out[0] = rows;
    out[1] = p - buf;
    out[2] = skipped;
    out[3] = nname;
    return status;
}

}  // extern "C"
