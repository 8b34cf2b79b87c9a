// Fast multithreaded CSV -> float64 matrix parser.
//
// The reference loads data with pandas (data_funcs.py:82) — fine for its
// one-shot research runs, but this framework's sweep engine re-reads
// datasets across many processes and hosts, so ingestion is part of the
// runtime. This native loader memory-maps the file, splits it into
// per-thread row ranges, and parses numeric fields with a branch-light
// strtod-style scanner. Empty fields and non-numeric text become NaN
// (pandas semantics for missing values). Quoted fields are supported,
// including commas inside quotes (delimiter scanning tracks quote
// state); embedded newlines inside quotes are NOT supported (rows are
// indexed by '\n').
//
// C ABI (consumed from Python via ctypes — see data/fast_csv.py):
//   csv_open(path)            -> handle (parses header, counts rows)
//   csv_num_rows/cols(handle)
//   csv_header(handle)        -> '\n'-joined column names (owned by handle)
//   csv_read(handle, out)     -> fills a row-major double[rows*cols];
//                                column 0 of the file (the index) is
//                                returned separately via csv_read_index.
//   csv_close(handle)

#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Csv {
  int fd = -1;
  const char* data = nullptr;
  size_t size = 0;
  size_t body_offset = 0;           // first byte after the header line
  std::vector<std::string> columns; // header names excluding the index col
  std::string header_joined;        // cached for csv_header()
  std::vector<size_t> row_offsets;  // start of each data row
  bool has_index = true;            // pandas to_csv writes an index col
};

// Find the end of the current line (handles trailing \r for CRLF files).
inline size_t line_end(const char* d, size_t pos, size_t size) {
  const char* nl = static_cast<const char*>(
      memchr(d + pos, '\n', size - pos));
  return nl ? static_cast<size_t>(nl - d) : size;
}

// Powers of ten for the fast path (double is exact up to 1e22).
const double kPow10[23] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10,
    1e11, 1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21,
    1e22};

// Slow path: strtod on a NUL-terminated copy.  `b` points into a
// borrowed mmap with no terminator — calling strtod on it directly
// could scan past the field (mis-parsing across a comma) and, when the
// file ends on a page boundary with no trailing newline, read past the
// mapping.  Full consumption is required so garbage-suffixed numerics
// like "12x" stay NaN (pandas: a non-numeric cell makes the column
// object-typed, and this loader's contract maps text cells to NaN).
inline double parse_slow(const char* b, const char* e, bool* ok) {
  const size_t len = static_cast<size_t>(e - b);
  char sbuf[64];
  std::string heap;
  const char* cs;
  if (len < sizeof(sbuf)) {
    memcpy(sbuf, b, len);
    sbuf[len] = '\0';
    cs = sbuf;
  } else {
    heap.assign(b, e);
    cs = heap.c_str();
  }
  char* pe = nullptr;
  double v = strtod(cs, &pe);
  *ok = (len > 0 && pe == cs + len);
  return *ok ? v : NAN;
}

// Hand-rolled decimal float parser: ~5x faster than locale-aware strtod
// for the fixed "[-]ddd.ddd[e[-]dd]" format CSV numbers use.  Falls back
// to strtod for very long mantissas where the u64 accumulator would
// overflow (keeps bit-exact parity with pandas' parser) and for
// non-decimal spellings ("inf", "nan") strtod understands.
inline double parse_number(const char* b, const char* e, bool* ok) {
  const char* p = b;
  bool neg = false;
  if (p < e && (*p == '-' || *p == '+')) neg = (*p++ == '-');
  uint64_t mant = 0;
  int digits = 0, frac_digits = 0;
  while (p < e && *p >= '0' && *p <= '9') {
    mant = mant * 10 + static_cast<uint64_t>(*p - '0');
    ++digits; ++p;
  }
  if (p < e && *p == '.') {
    ++p;
    while (p < e && *p >= '0' && *p <= '9') {
      mant = mant * 10 + static_cast<uint64_t>(*p - '0');
      ++digits; ++frac_digits; ++p;
    }
  }
  int exp10 = 0;
  if (p < e && (*p == 'e' || *p == 'E')) {
    ++p;
    bool eneg = false;
    if (p < e && (*p == '-' || *p == '+')) eneg = (*p++ == '-');
    int ev = 0;
    while (p < e && *p >= '0' && *p <= '9') ev = ev * 10 + (*p++ - '0');
    exp10 = eneg ? -ev : ev;
  }
  // Fast path only when exact: a <=15-digit mantissa fits a double
  // losslessly and one multiply/divide by an exact power of ten (<=1e22)
  // rounds once, so the result matches correctly-rounded strtod bit for
  // bit.  Beyond that (long mantissas, |net exp| > 22) pow() would
  // double-round — fall back to strtod.
  int net_exp = exp10 - frac_digits;
  if (digits == 0 || p != e || digits > 15 ||
      net_exp > 22 || net_exp < -22) {
    return parse_slow(b, e, ok);
  }
  double v = static_cast<double>(mant);
  if (net_exp > 0) {
    v = v * kPow10[net_exp];
  } else if (net_exp < 0) {
    v = v / kPow10[-net_exp];
  }
  *ok = true;
  return neg ? -v : v;
}

// Parse one field [begin, end) -> double; empty / non-numeric -> NaN.
inline double parse_field(const char* begin, const char* end) {
  while (begin < end && (*begin == ' ' || *begin == '"')) ++begin;
  while (end > begin && (end[-1] == ' ' || end[-1] == '"' ||
                         end[-1] == '\r')) --end;
  if (begin >= end) return NAN;
  bool ok = false;
  double v = parse_number(begin, end, &ok);
  return ok ? v : NAN;  // text field (e.g. "Train") -> NaN
}

void split_header(Csv* c, size_t hdr_end) {
  std::vector<std::string> cols;
  const char* p = c->data;
  const char* end = c->data + hdr_end;
  const char* fstart = p;
  bool in_q = false;
  while (p <= end) {
    if (p < end && *p == '"') in_q = !in_q;
    if (p == end || (*p == ',' && !in_q)) {
      std::string name(fstart, static_cast<size_t>(p - fstart));
      while (!name.empty() && (name.back() == '\r' || name.back() == '"'))
        name.pop_back();
      if (!name.empty() && name.front() == '"') name.erase(0, 1);
      cols.push_back(std::move(name));
      if (p == end) break;
      fstart = p + 1;
    }
    ++p;
  }
  // pandas' to_csv leads with an unnamed index column
  c->has_index = !cols.empty() && cols[0].empty();
  if (c->has_index) cols.erase(cols.begin());
  c->columns = std::move(cols);
  for (size_t i = 0; i < c->columns.size(); ++i) {
    if (i) c->header_joined += '\n';
    c->header_joined += c->columns[i];
  }
}

void index_rows(Csv* c) {
  size_t pos = c->body_offset;
  while (pos < c->size) {
    size_t end = line_end(c->data, pos, c->size);
    if (end > pos) c->row_offsets.push_back(pos);
    pos = end + 1;
  }
}

}  // namespace

extern "C" {

void* csv_open(const char* path) {
  Csv* c = new Csv();
  c->fd = open(path, O_RDONLY);
  if (c->fd < 0) { delete c; return nullptr; }
  struct stat st;
  if (fstat(c->fd, &st) != 0 || st.st_size == 0) {
    close(c->fd); delete c; return nullptr;
  }
  c->size = static_cast<size_t>(st.st_size);
  c->data = static_cast<const char*>(
      mmap(nullptr, c->size, PROT_READ, MAP_PRIVATE, c->fd, 0));
  if (c->data == MAP_FAILED) { close(c->fd); delete c; return nullptr; }

  size_t hdr_end = line_end(c->data, 0, c->size);
  split_header(c, hdr_end);
  c->body_offset = hdr_end + 1;
  index_rows(c);
  return c;
}

int64_t csv_num_rows(void* h) {
  return static_cast<Csv*>(h)->row_offsets.size();
}

int64_t csv_num_cols(void* h) {
  return static_cast<Csv*>(h)->columns.size();
}

const char* csv_header(void* h) {
  return static_cast<Csv*>(h)->header_joined.c_str();
}

// Fill `out` (rows*cols, row-major) and `index_out` (rows) with parsed
// values. Text cells -> NaN in `out`; the index column (if present) is
// parsed into index_out (NaN for non-numeric row labels).
void csv_read(void* h, double* out, double* index_out, int32_t n_threads) {
  Csv* c = static_cast<Csv*>(h);
  const size_t rows = c->row_offsets.size();
  const size_t cols = c->columns.size();
  if (n_threads <= 0) {
    n_threads = static_cast<int32_t>(
        std::min<size_t>(std::thread::hardware_concurrency(), 16));
    if (n_threads <= 0) n_threads = 1;
  }

  auto worker = [&](size_t r0, size_t r1) {
    for (size_t r = r0; r < r1; ++r) {
      size_t pos = c->row_offsets[r];
      size_t end = line_end(c->data, pos, c->size);
      size_t field = 0;
      const char* fstart = c->data + pos;
      const char* line_end_p = c->data + end;
      const char* p = fstart;
      size_t out_col = 0;
      bool in_q = false;
      while (p <= line_end_p) {
        if (p < line_end_p && *p == '"') in_q = !in_q;
        if (p == line_end_p || (*p == ',' && !in_q)) {
          double v = parse_field(fstart, p);
          if (field == 0 && c->has_index) {
            if (index_out) index_out[r] = v;
          } else if (out_col < cols) {
            out[r * cols + out_col] = v;
            ++out_col;
          }
          ++field;
          fstart = p + 1;
        }
        ++p;
      }
      // short rows: pad with NaN
      for (; out_col < cols; ++out_col) out[r * cols + out_col] = NAN;
    }
  };

  if (n_threads == 1 || rows < 256) {
    worker(0, rows);
  } else {
    std::vector<std::thread> threads;
    size_t chunk = (rows + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
      size_t r0 = t * chunk;
      size_t r1 = std::min(rows, r0 + chunk);
      if (r0 >= r1) break;
      threads.emplace_back(worker, r0, r1);
    }
    for (auto& th : threads) th.join();
  }
}

// Read one named column as raw strings ('\n'-joined, heap-allocated;
// caller frees with csv_free_string). Used for text columns like
// 'dataset' that the numeric reader maps to NaN.
char* csv_read_text_column(void* h, int64_t col_idx) {
  Csv* c = static_cast<Csv*>(h);
  const size_t cols = c->columns.size();
  if (col_idx < 0 || static_cast<size_t>(col_idx) >= cols) return nullptr;
  std::string out;
  const size_t target = static_cast<size_t>(col_idx) +
                        (c->has_index ? 1 : 0);
  for (size_t r = 0; r < c->row_offsets.size(); ++r) {
    size_t pos = c->row_offsets[r];
    size_t end = line_end(c->data, pos, c->size);
    const char* fstart = c->data + pos;
    const char* line_end_p = c->data + end;
    const char* p = fstart;
    size_t field = 0;
    bool in_q = false;
    while (p <= line_end_p) {
      if (p < line_end_p && *p == '"') in_q = !in_q;
      if (p == line_end_p || (*p == ',' && !in_q)) {
        if (field == target) {
          const char* b = fstart;
          const char* e = p;
          while (b < e && (*b == ' ' || *b == '"')) ++b;
          while (e > b && (e[-1] == ' ' || e[-1] == '"' ||
                           e[-1] == '\r')) --e;
          out.append(b, e);
          break;
        }
        ++field;
        fstart = p + 1;
      }
      ++p;
    }
    out += '\n';
  }
  if (!out.empty()) out.pop_back();
  char* buf = static_cast<char*>(malloc(out.size() + 1));
  memcpy(buf, out.c_str(), out.size() + 1);
  return buf;
}

void csv_free_string(char* s) { free(s); }

void csv_close(void* h) {
  Csv* c = static_cast<Csv*>(h);
  if (c->data && c->data != MAP_FAILED)
    munmap(const_cast<char*>(c->data), c->size);
  if (c->fd >= 0) close(c->fd);
  delete c;
}

}  // extern "C"
