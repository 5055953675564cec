/* Native byte-level input parsers (FASTA + quote-free DSV fast path).
 *
 * Native equivalent of the reference's in-place parse/compact loops
 * (/root/reference/src/io/source/fasta.c, dsv.c) — same cleaning and
 * validation semantics as the Python parsers in sequencealigner_tpu/io/,
 * exposed as a small C library loaded via ctypes (io/native.py).  The Python
 * parsers remain the fallback and the quote-aware DSV path.
 *
 * Contract (both functions):
 *   returns number of sequences on success, -1 on error (errbuf filled).
 *   out      : cleaned sequence bytes, concatenated (caller allocates >= n)
 *   offsets  : int64[max_seqs + 1], offsets[0] = 0, offsets[i+1] = end of seq i
 *   gap_abs  : |linear gap| for the length limit (0 = none),
 *              limit = ((2^31 - 2) / 2) / max(gap_abs, 1)   (input.c:15-19)
 *
 * Build: gcc -O3 -shared -fPIC -o libfastparse.so fastparse.c
 */

#include <stdint.h>
#include <stdio.h>
#include <string.h>

#define S32_MAX 2147483647LL
#define SEQ_LEN_MAX ((S32_MAX - 1) / 2)

#define ERR(...)                                        \
    do {                                                \
        snprintf(errbuf, 256, __VA_ARGS__);             \
        return -1;                                      \
    } while (0)

static inline uint8_t upcase(uint8_t c) {
    return (c >= 'a' && c <= 'z') ? (uint8_t)(c - 32) : c;
}

/* Clean one raw span into out; returns cleaned length or -1. */
static int64_t clean_seq(const uint8_t *raw, int64_t len, const int32_t *lut,
                         int drop_quotes, int64_t seq_no, uint8_t *out,
                         char *errbuf) {
    int64_t w = 0;
    for (int64_t i = 0; i < len; i++) {
        uint8_t c = upcase(raw[i]);
        if (c == '\r' || c == '\n' || c == ' ')
            continue;
        if (drop_quotes && c == '"')
            continue;
        if (c == 0 || c > 127)
            ERR("Sequence #%lld is corrupted", (long long)seq_no);
        if (lut[c] < 0)
            ERR("Sequence #%lld is invalid", (long long)seq_no);
        out[w++] = c;
    }
    return w;
}

static int check_lengths(int64_t slen, int64_t total, int64_t seq_no,
                         int32_t gap_abs, char *errbuf) {
    int64_t limit = gap_abs ? SEQ_LEN_MAX / gap_abs : SEQ_LEN_MAX;
    if (slen == 0)
        ERR("Sequence #%lld is empty", (long long)seq_no);
    if (slen > limit)
        ERR("Sequence #%lld exceeds length limits", (long long)seq_no);
    if (total + slen + 1 > S32_MAX)
        ERR("Length overflow after %lld sequences", (long long)seq_no);
    return 0;
}

long long fasta_parse(const uint8_t *data, int64_t n, const int32_t *lut,
                      int32_t gap_abs, uint8_t *out, int64_t *offsets,
                      int64_t max_seqs, char *errbuf) {
    if (n == 0 || data[0] != '>')
        ERR("Data before first header");

    int64_t num = 0, w = 0, total = 0, pos = 0;
    offsets[0] = 0;
    while (pos < n) {
        /* header line runs to the first CR/LF ('>' mid-header is text) */
        while (pos < n && data[pos] != '\n' && data[pos] != '\r')
            pos++;
        while (pos < n && (data[pos] == '\n' || data[pos] == '\r'))
            pos++;
        if (pos >= n)
            ERR("Last header has no data");
        int64_t start = pos;
        while (pos < n && data[pos] != '>')
            pos++;
        if (num >= max_seqs)
            ERR("Too many sequences for output buffers");
        int64_t slen =
            clean_seq(data + start, pos - start, lut, 0, num + 1, out + w, errbuf);
        if (slen < 0)
            return -1;
        if (check_lengths(slen, total, num + 1, gap_abs, errbuf) < 0)
            return -1;
        total += slen + 1;
        w += slen;
        offsets[++num] = w;
    }
    return num;
}

/* DSV fast path: no '"' anywhere in data (caller checks), header row already
 * consumed (data starts at the first data row or at the header row when it
 * is data).  Exact error precedence of dsv.c's row loop. */
long long dsv_parse_fast(const uint8_t *data, int64_t n, const int32_t *lut,
                         int32_t gap_abs, uint8_t delim, int32_t cols,
                         int32_t seq_col, uint8_t *out, int64_t *offsets,
                         int64_t max_seqs, char *errbuf) {
    int64_t num = 0, w = 0, total = 0, pos = 0;
    offsets[0] = 0;
    while (pos < n) {
        while (pos < n && (data[pos] == '\n' || data[pos] == '\r'))
            pos++;
        if (pos >= n)
            break;
        num++;
        /* count fields and locate the sequence span */
        int32_t field = 0;
        int64_t fstart = pos, sstart = -1, send = -1;
        for (;;) {
            if (pos >= n || data[pos] == '\n' || data[pos] == '\r' ||
                data[pos] == delim) {
                if (field == seq_col) {
                    sstart = fstart;
                    send = pos;
                }
                field++;
                if (pos < n && data[pos] == delim) {
                    pos++;
                    fstart = pos;
                    continue;
                }
                break;
            }
            pos++;
        }
        if (sstart < 0)
            ERR("DSV row #%lld has no sequence column", (long long)num);
        if (send == sstart)
            ERR("Sequence #%lld is empty", (long long)num);
        if (num > max_seqs)
            ERR("Too many sequences for output buffers");
        int64_t slen = clean_seq(data + sstart, send - sstart, lut, 1, num,
                                 out + w, errbuf);
        if (slen < 0)
            return -1;
        if (check_lengths(slen, total, num, gap_abs, errbuf) < 0)
            return -1;
        if (field < cols)
            ERR("DSV row #%lld has too few columns", (long long)num);
        if (field > cols)
            ERR("DSV row #%lld has too many columns", (long long)num);
        total += slen + 1;
        w += slen;
        offsets[num] = w;
    }
    return num;
}
