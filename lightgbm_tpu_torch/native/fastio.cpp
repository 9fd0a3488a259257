// Native IO + binning runtime of the host side.
//
// Port of lightgbm_tpu/native/fastio.cpp: the text parsers (reference:
// src/io/parser.cpp CSVParser/TSVParser/LibSVMParser, native because
// Python-level row loops are orders of magnitude too slow for 10M-row
// files) and the value->bin loop (src/io/bin.cpp BinMapper::ValueToBin).
//
// Plain C ABI consumed through ctypes. Parallelism: std::thread over row
// chunks, the analog of the reference's OpenMP parallel parsing.
//
// Built at first use by native/__init__.py with g++ -O3 -shared into
// lightgbm_tpu_torch/_build/. The parser falls back to Python when the
// build fails, and says so in the log.

#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// 0 = auto (hardware concurrency); set via set_num_threads (the reference's
// num_threads / OMP_NUM_THREADS analog, config.h:122)
std::atomic<int> g_num_threads{0};

inline bool is_na_token(const char* s, size_t len) {
  if (len == 0) return true;
  // na / nan / null / none / n/a / unknown / ? (parser.h NA conventions)
  char buf[9];
  if (len > 8) return false;
  for (size_t i = 0; i < len; ++i) buf[i] = static_cast<char>(std::tolower(s[i]));
  buf[len] = 0;
  return !strcmp(buf, "na") || !strcmp(buf, "nan") || !strcmp(buf, "null") ||
         !strcmp(buf, "none") || !strcmp(buf, "n/a") || !strcmp(buf, "?") ||
         !strcmp(buf, "unknown");
}

inline const char* find_ws(const char* p, const char* end) {
  // label/feature separator: space OR tab (the reference and the Python
  // fallback accept both)
  while (p < end && *p != ' ' && *p != '\t') ++p;
  return p < end ? p : nullptr;
}

inline double parse_token(const char* s, const char* end) {
  while (s < end && (*s == ' ' || *s == '\r')) ++s;
  const char* e = end;
  while (e > s && (*(e - 1) == ' ' || *(e - 1) == '\r')) --e;
  if (e <= s || is_na_token(s, static_cast<size_t>(e - s)))
    return std::nan("");
  char* parsed_end = nullptr;
  double v = std::strtod(s, &parsed_end);
  if (parsed_end == s) return std::nan("");
  return v;
}

struct LineIndex {
  std::vector<const char*> starts;
  std::vector<const char*> ends;
};

LineIndex index_lines(const char* buf, int64_t n_bytes) {
  LineIndex idx;
  const char* p = buf;
  const char* end = buf + n_bytes;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    // skip blank lines
    const char* q = p;
    while (q < line_end && (*q == ' ' || *q == '\r' || *q == '\t')) ++q;
    if (q < line_end) {
      idx.starts.push_back(p);
      idx.ends.push_back(line_end);
    }
    p = line_end + 1;
  }
  return idx;
}

int hardware_threads() {
  int forced = g_num_threads.load(std::memory_order_relaxed);
  if (forced > 0) return forced;
  unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(n) : 4;
}

template <typename Fn>
void parallel_for(int64_t n, Fn fn) {
  int nt = hardware_threads();
  if (n < 4 * nt) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(lo + chunk, n);
    if (lo >= hi) break;
    threads.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Cap worker threads (num_threads param; 0 restores auto-detection).
void set_num_threads(int n) {
  g_num_threads.store(n, std::memory_order_relaxed);
}

// Count rows & delimited columns of the first data line. Returns rows.
int64_t csv_dims(const char* buf, int64_t n_bytes, char delim, int64_t* n_cols) {
  LineIndex idx = index_lines(buf, n_bytes);
  if (idx.starts.empty()) {
    *n_cols = 0;
    return 0;
  }
  int64_t cols = 1;
  for (const char* p = idx.starts[0]; p < idx.ends[0]; ++p)
    if (*p == delim) ++cols;
  *n_cols = cols;
  return static_cast<int64_t>(idx.starts.size());
}

// Parse a delimited text buffer into a dense row-major double matrix.
// Returns 0 on success, -1 on a row with the wrong column count (its index
// is stored in *bad_row).
int32_t csv_parse(const char* buf, int64_t n_bytes, char delim,
                  int64_t n_rows, int64_t n_cols, int32_t skip_first,
                  double* out, int64_t* bad_row) {
  LineIndex idx = index_lines(buf, n_bytes);
  int64_t offset = skip_first ? 1 : 0;
  if (static_cast<int64_t>(idx.starts.size()) - offset < n_rows) return -2;
  *bad_row = -1;
  // atomics: status/bad_row are written from every worker thread (same bug
  // class as the libsvm_scan fetch-max race fixed earlier)
  std::atomic<int32_t> status{0};
  std::atomic<int64_t> bad{-1};
  parallel_for(n_rows, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const char* p = idx.starts[i + offset];
      const char* line_end = idx.ends[i + offset];
      double* row = out + i * n_cols;
      int64_t c = 0;
      while (c < n_cols) {
        const char* tok_end =
            static_cast<const char*>(memchr(p, delim, line_end - p));
        if (!tok_end) tok_end = line_end;
        row[c++] = parse_token(p, tok_end);
        if (tok_end >= line_end) break;
        p = tok_end + 1;
      }
      if (c != n_cols) {
        status.store(-1, std::memory_order_relaxed);
        bad.store(i, std::memory_order_relaxed);
      }
    }
  });
  *bad_row = bad.load();
  return status.load();
}

// LibSVM pass 1: per-row nonzero counts, max feature index, labels.
int64_t libsvm_scan(const char* buf, int64_t n_bytes, double* labels,
                    int64_t* row_nnz, int64_t cap_rows, int64_t* max_idx) {
  LineIndex idx = index_lines(buf, n_bytes);
  int64_t n = std::min<int64_t>(cap_rows, idx.starts.size());
  std::atomic<int64_t> mx{-1};
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    int64_t local_mx = -1;
    for (int64_t i = lo; i < hi; ++i) {
      const char* p = idx.starts[i];
      const char* line_end = idx.ends[i];
      const char* sp = find_ws(p, line_end);
      const char* lab_end = sp ? sp : line_end;
      labels[i] = parse_token(p, lab_end);
      int64_t cnt = 0;
      p = lab_end;
      while (p < line_end) {
        const char* colon =
            static_cast<const char*>(memchr(p, ':', line_end - p));
        if (!colon) break;
        ++cnt;
        const char* k = colon;
        while (k > p && std::isdigit(*(k - 1))) --k;
        int64_t fidx = std::strtoll(k, nullptr, 10);
        if (fidx > local_mx) local_mx = fidx;
        p = colon + 1;
      }
      row_nnz[i] = cnt;
    }
    // atomic fetch-max (the previous volatile retry loop could lose updates)
    int64_t cur = mx.load(std::memory_order_relaxed);
    while (local_mx > cur &&
           !mx.compare_exchange_weak(cur, local_mx,
                                     std::memory_order_relaxed)) {
    }
  });
  *max_idx = mx.load();
  return n;
}

// LibSVM pass 2: fill a dense row-major [n_rows, n_cols] matrix (absent = 0).
int32_t libsvm_fill(const char* buf, int64_t n_bytes, int64_t n_rows,
                    int64_t n_cols, double* out) {
  LineIndex idx = index_lines(buf, n_bytes);
  if (static_cast<int64_t>(idx.starts.size()) < n_rows) return -2;
  parallel_for(n_rows, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const char* p = idx.starts[i];
      const char* line_end = idx.ends[i];
      const char* sp = find_ws(p, line_end);
      double* row = out + i * n_cols;
      p = sp ? sp + 1 : line_end;
      while (p < line_end) {
        while (p < line_end && (*p == ' ' || *p == '\t')) ++p;
        char* after_idx = nullptr;
        long long fidx = std::strtoll(p, &after_idx, 10);
        if (after_idx == p || after_idx >= line_end || *after_idx != ':') break;
        const char* vstart = after_idx + 1;
        char* after_v = nullptr;
        double v = std::strtod(vstart, &after_v);
        if (after_v == vstart) break;
        if (fidx >= 0 && fidx < n_cols) row[fidx] = v;
        p = after_v;
      }
    }
  });
  return 0;
}

}  // extern "C"

namespace {

// Value->bin for one value: bins are (prev, bound] intervals; the answer is
// the count of bounds strictly below v, capped at nb-1. For the common
// max_bin<=64 case a branchless linear scan beats binary search: it
// auto-vectorizes (no data-dependent branches to mispredict) — this is the
// hot loop of dataset construction on a 1-core host.
inline int64_t value_to_bin(double v, const double* b, int64_t nb) {
  if (nb <= 64) {
    int64_t cnt = 0;
    for (int64_t k = 0; k < nb - 1; ++k) cnt += (v > b[k]);
    return cnt;
  }
  int64_t lo_i = 0, hi_i = nb - 1;
  while (lo_i < hi_i) {
    int64_t mid = (lo_i + hi_i) >> 1;
    if (v <= b[mid]) hi_i = mid; else lo_i = mid + 1;
  }
  return lo_i;
}

template <typename T>
void bin_columns_impl(const T* data, int64_t n, int64_t f,
                      const double* bounds_flat, const int64_t* bounds_off,
                      const int32_t* na_bin, uint8_t* out) {
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const T* row = data + i * f;
      uint8_t* orow = out + i * f;
      for (int64_t j = 0; j < f; ++j) {
        // f32 inputs upcast in-register: comparisons against the f64 bounds
        // are exact, so f32 ingestion loses nothing vs a host-side f64 copy
        double v = static_cast<double>(row[j]);
        if (std::isnan(v)) {
          orow[j] = static_cast<uint8_t>(na_bin[j] >= 0 ? na_bin[j] : 0);
          continue;
        }
        orow[j] = static_cast<uint8_t>(value_to_bin(
            v, bounds_flat + bounds_off[j], bounds_off[j + 1] - bounds_off[j]));
      }
    }
  });
}

}  // namespace

extern "C" {

// Batch value->bin over all columns (BinMapper::ValueToBin, bin.cpp).
// data: [N, F] row-major f64 (or f32 via the _f32 variant). For feature j:
// bounds_flat[bounds_off[j] .. bounds_off[j+1]) = ascending upper bounds of
// the non-NaN bins; NaN -> na_bin[j] (if >= 0 else bin of 0.0).
void bin_columns(const double* data, int64_t n, int64_t f,
                 const double* bounds_flat, const int64_t* bounds_off,
                 const int32_t* na_bin, uint8_t* out) {
  bin_columns_impl(data, n, f, bounds_flat, bounds_off, na_bin, out);
}

void bin_columns_f32(const float* data, int64_t n, int64_t f,
                     const double* bounds_flat, const int64_t* bounds_off,
                     const int32_t* na_bin, uint8_t* out) {
  bin_columns_impl(data, n, f, bounds_flat, bounds_off, na_bin, out);
}

}  // extern "C"
