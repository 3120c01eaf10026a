// Native BOX-file row parser (the framework's C++ data-loader core).
//
// The reference parses BOX files with a per-line Python loop
// (reference: repic/utils/common.py:75-112); the framework's batch
// workloads parse tens of thousands of files per run, so the hot
// tier is native: one pass over the raw bytes, strtod_l per token
// (C locale, correctly rounded — bit-identical to CPython's float()),
// rows emitted as 5 doubles (x, y, w, h, conf) with the Python
// loop's defaults (w=h=0, conf=1) for short rows.
//
// Semantics contract (mirrors repic_tpu_torch/utils/box_io.py:_read_box_slow,
// which remains the specification):
//   * lines split on '\n' or '\r' (Python universal newlines);
//     blank lines are skipped anywhere;
//   * if the FIRST non-blank line starts with a word-like token
//     (ASCII letter or underscore) that does not parse as a float,
//     it is a header and is skipped.  A non-parsing token that does
//     NOT look like a word (digits, signs, dots, non-ASCII bytes)
//     defers the whole file to the Python tiers instead — it might
//     be a value only CPython's float() accepts (PEP 515
//     underscores, unicode digits), and silently dropping it as a
//     "header" would lose a data row;
//   * rows may have 2..5 tokens; tokens past the fifth are ignored
//     WITHOUT being parsed (the Python loop never touches them);
//   * any unparseable token in columns 1..5, or a row with fewer
//     than 2 tokens, aborts the parse (return -1) — the caller falls
//     back to the Python tiers, which raise exactly as the loop
//     would;
//   * strtod supersets CPython float() in two ways that are guarded
//     explicitly: C hex floats ("0x1p3") and "nan(char-seq)" payload
//     forms are rejected.
//
// The caller guarantees buf[len] == '\0' (strtod may peek one past a
// token that touches the end of the buffer).

#include <cstdlib>
#include <cstring>
#include <locale.h>

namespace {

locale_t c_locale() {
    static locale_t loc = newlocale(LC_ALL_MASK, "C", nullptr);
    return loc;
}

// Locale-INDEPENDENT character classes (glibc isalpha/isspace follow
// LC_CTYPE, which CPython sets from the environment — a legacy 8-bit
// locale would classify high bytes as letters and break the contract
// below).
inline bool ascii_space(char c) {
    return c == ' ' || c == '\t' || c == '\f' || c == '\v';
}

inline bool ascii_word(char c) {
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z')
        || c == '_';
}

// True iff [q, t) is a token CPython's float() would also accept,
// parsed into *v.  Assumes t > q.
bool parse_token(const char* q, const char* t, double* v) {
    const char* h = q;
    if (h < t && (*h == '+' || *h == '-')) ++h;
    if (h >= t) return false;
    // strtod-only forms float() rejects: hex floats, nan payloads
    if ((t - h) > 1 && h[0] == '0' && (h[1] == 'x' || h[1] == 'X'))
        return false;
    if ((h[0] == 'n' || h[0] == 'N') && (t - h) != 3)
        return false;  // "nan" only; "nan(0)" is strtod-only
    char* ep = nullptr;
    *v = strtod_l(q, &ep, c_locale());
    return ep == t;
}

}  // namespace

extern "C" {

// Parse up to max_rows rows into out (5 doubles per row).
// Returns the row count, or -1 when the file needs the Python tiers.
long boxparse_rows(
    const char* buf, long len, double* out, long max_rows)
{
    const char* p = buf;
    const char* end = buf + len;
    long rows = 0;
    bool first_content = true;
    while (p < end) {
        const char* le = p;
        while (le < end && *le != '\n' && *le != '\r') ++le;

        double vals[5] = {0.0, 0.0, 0.0, 0.0, 1.0};
        int ncols = 0;
        int bad_col = -1;
        char tok0_first = '\0';
        const char* q = p;
        while (q < le) {
            while (q < le && ascii_space(*q)) ++q;
            if (q >= le) break;
            const char* t = q;
            while (t < le && !ascii_space(*t)) ++t;
            if (ncols == 0) tok0_first = *q;
            if (ncols < 5) {
                if (!parse_token(q, t, &vals[ncols])) {
                    bad_col = ncols;
                    break;
                }
            }
            ++ncols;  // tokens past the fifth: counted, never parsed
            q = t;
        }

        if (ncols > 0 || bad_col == 0) {
            if (bad_col >= 0) {
                bool wordlike = ascii_word(tok0_first);
                if (first_content && bad_col == 0 && wordlike) {
                    // header line: skipped, but only the first
                    first_content = false;
                    p = le + 1;
                    continue;
                }
                return -1;
            }
            if (ncols < 2) return -1;  // the loop would IndexError
            first_content = false;
            if (rows >= max_rows) return -1;  // caller sized it wrong
            memcpy(out + rows * 5, vals, sizeof(vals));
            ++rows;
        }
        p = le + 1;
    }
    return rows;
}

}  // extern "C"
