// Native libsvm/libffm chunk parser (a copy of
// ytk_mp4j_tpu/csrc/mp4j_parse.cpp for the PyTorch port): the data
// loader's hot path. ytk-learn streams libsvm text; this scanner parses
// the raw chunk bytes in one pass with hand-rolled int/float scanners and
// no intermediate strings.
//
// STRICT-SUBSET contract: this parser accepts exactly the common shape
// of what utils/libsvm.parse_line accepts (decimal int ids, ordinary
// float literals). Anything else — over-long lines, mixed widths,
// underscore literals, hex floats, inf/nan, out-of-int32 ids — returns
// a negative code and the Python caller replays the chunk through
// parse_line, which raises the exact diagnostic (or accepts the exotic
// valid forms at Python speed). It must NEVER accept what parse_line
// rejects.
//
// ABI: plain C via ctypes (see ytk_mp4j_tpu_torch/utils/native.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <locale.h>

namespace {

// strtof is LC_NUMERIC-sensitive: under a comma-decimal locale it would
// refuse every "0.5" and silently push all parsing onto the Python
// replay path. Pin the C locale once (POSIX strtof_l).
locale_t c_locale() {
  static locale_t loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
  return loc;
}

inline bool is_space(char c) {
  return c == ' ' || c == '\t' || c == '\r' || c == '\f' || c == '\v';
}

// Python int() literal semantics, minus underscores: optional sign then
// decimal digits only. Overflow returns false (caller falls back).
bool parse_i64(const char* b, const char* e, int64_t* out) {
  if (b == e) return false;
  bool neg = false;
  if (*b == '+' || *b == '-') {
    neg = (*b == '-');
    ++b;
  }
  if (b == e) return false;
  int64_t v = 0;
  for (; b != e; ++b) {
    if (*b < '0' || *b > '9') return false;
    if (v > (INT64_MAX - (*b - '0')) / 10) return false;
    v = v * 10 + (*b - '0');
  }
  *out = neg ? -v : v;
  return true;
}

// Ordinary float literals only. The charset gate rejects C-only forms
// (hex floats "0x1p3") and word forms ("inf", "nan") BEFORE strtof can
// accept them — those must go through the Python float() path so the
// two parsers never disagree on acceptance.
bool parse_f32(const char* b, const char* e, float* out) {
  if (b == e) return false;
  for (const char* p = b; p != e; ++p) {
    char c = *p;
    if (!((c >= '0' && c <= '9') || c == '+' || c == '-' || c == '.' ||
          c == 'e' || c == 'E'))
      return false;
  }
  char tmp[64];
  size_t n = (size_t)(e - b);
  if (n >= sizeof tmp) return false;
  memcpy(tmp, b, n);
  tmp[n] = '\0';
  char* endp = nullptr;
  // parse at DOUBLE precision then cast, matching the Python path's
  // float() -> np.float32 double rounding exactly: strtof's single
  // rounding diverges by 1 ulp on some literals (e.g.
  // "0.0000180163488039397634566"), which would make fast-path and
  // replay-path training bytes differ. Overflow -> +-inf, like float().
  double v = strtod_l(tmp, &endp, c_locale());
  if (endp != tmp + n) return false;
  *out = (float)v;
  return true;
}

}  // namespace

extern "C" {

// Parse a chunk of whole lines (newline-separated; blank lines are
// skipped). Output buffers are [max_rows, max_nnz] row-major and
// zero-filled by the caller (absent slots keep field/feat/val = 0, the
// padding convention of utils/libsvm.read_libsvm). libsvm tokens
// (feat:val) leave fields at 0; libffm tokens are field:feat:val; a
// line may use either width but not both (parse_line's rule).
// Returns 0 with *out_rows = parsed row count, or -1 on any refused
// line (caller replays in Python for diagnostics), or -2 if more than
// max_rows non-blank lines arrive.
int64_t mp4j_parse_libsvm(const char* buf, int64_t len, int32_t max_nnz,
                          int64_t max_rows, int32_t* feats,
                          int32_t* fields, float* vals, float* labels,
                          int64_t* out_rows) {
  int64_t row = 0;
  const char* p = buf;
  const char* end = buf + len;
  while (p < end) {
    const char* eol = (const char*)memchr(p, '\n', (size_t)(end - p));
    if (!eol) eol = end;
    const char* q = p;
    while (q < eol && is_space(*q)) ++q;
    if (q == eol) {  // blank line
      p = eol + 1;
      continue;
    }
    if (row >= max_rows) return -2;
    const char* ts = q;
    while (q < eol && !is_space(*q)) ++q;
    if (!parse_f32(ts, q, &labels[row])) return -1;
    int32_t slot = 0;
    int width = 0;  // 0 until the line's first token decides
    for (;;) {
      while (q < eol && is_space(*q)) ++q;
      if (q == eol) break;
      ts = q;
      while (q < eol && !is_space(*q)) ++q;
      const char* c1 = (const char*)memchr(ts, ':', (size_t)(q - ts));
      if (!c1) return -1;
      const char* c2 =
          (const char*)memchr(c1 + 1, ':', (size_t)(q - c1 - 1));
      int w = c2 ? 3 : 2;
      if (c2 && memchr(c2 + 1, ':', (size_t)(q - c2 - 1))) return -1;
      if (width == 0) width = w;
      if (w != width) return -1;       // mixed widths on one line
      if (slot >= max_nnz) return -1;  // over-long line
      int64_t feat, field = 0;
      float v;
      if (w == 2) {
        if (!parse_i64(ts, c1, &feat)) return -1;
        if (!parse_f32(c1 + 1, q, &v)) return -1;
      } else {
        if (!parse_i64(ts, c1, &field)) return -1;
        if (!parse_i64(c1 + 1, c2, &feat)) return -1;
        if (!parse_f32(c2 + 1, q, &v)) return -1;
      }
      if (feat < INT32_MIN || feat > INT32_MAX || field < INT32_MIN ||
          field > INT32_MAX)
        return -1;  // replay raises OverflowError like the old path
      int64_t off = row * (int64_t)max_nnz + slot;
      feats[off] = (int32_t)feat;
      fields[off] = (int32_t)field;
      vals[off] = v;
      ++slot;
    }
    ++row;
    p = eol + 1;
  }
  *out_rows = row;
  return 0;
}

}  // extern "C"
