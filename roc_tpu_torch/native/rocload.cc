// rocload — the host loaders of roc_tpu_torch's data layer, built into
// one library with rocplan.cc (roc_tpu_torch/native/__init__.py loads it
// with ctypes).  A copy of the loader passes of the JAX package's
// native/rocio.cc with the same C ABI:
//   * the .lux binary graph reader and writer (reference gnn.cc:756-801,
//     load_task.cu:229-243)
//   * the CSV feature parser, whole and by rows (load_task.cu:41-73)
//   * the Train/Val/Test/None mask parser (load_task.cu:169-183)
//   * the edge-balanced greedy partitioner (gnn.cc:806-829)
//   * self-edge insertion (the offline .add_self_edge.lux conversion,
//     gnn.cc:756)
//   * the ELL bucket widths (core/ell.py row_widths)
// Every buffer is a caller-allocated numpy array; errors are negative
// return codes (the loader maps them to Python exceptions).

#include <cerrno>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

constexpr int kOk = 0;
constexpr int kErrOpen = -1;
constexpr int kErrRead = -2;
constexpr int kErrFormat = -3;
constexpr int kErrValue = -4;

struct FileCloser {
  FILE* f;
  ~FileCloser() {
    if (f) fclose(f);
  }
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// .lux binary format: u32 num_nodes, u64 num_edges, num_nodes x u64
// inclusive-end row offsets, num_edges x u32 source ids (dst-sorted CSR).
// ---------------------------------------------------------------------------

int roc_lux_header(const char* path, uint32_t* num_nodes,
                   uint64_t* num_edges) {
  FILE* f = fopen(path, "rb");
  if (!f) return kErrOpen;
  FileCloser closer{f};
  if (fread(num_nodes, sizeof(uint32_t), 1, f) != 1) return kErrRead;
  if (fread(num_edges, sizeof(uint64_t), 1, f) != 1) return kErrRead;
  return kOk;
}

// row_ptr: int64 [num_nodes + 1] (exclusive-start, row_ptr[0] = 0);
// col_idx: int32 [num_edges].  Validates monotone offsets and final
// offset == num_edges (the reference asserts the same, gnn.cc:798-800).
int roc_lux_read(const char* path, int64_t num_nodes, int64_t num_edges,
                 int64_t* row_ptr, int32_t* col_idx) {
  FILE* f = fopen(path, "rb");
  if (!f) return kErrOpen;
  FileCloser closer{f};
  if (fseek(f, sizeof(uint32_t) + sizeof(uint64_t), SEEK_SET) != 0)
    return kErrRead;

  row_ptr[0] = 0;
  constexpr int64_t kChunk = 1 << 20;
  void* heap = malloc(kChunk * sizeof(uint64_t));
  if (!heap) return kErrRead;
  {
    uint64_t* buf = (uint64_t*)heap;
    int64_t done = 0;
    int64_t prev = 0;
    while (done < num_nodes) {
      int64_t n = num_nodes - done < kChunk ? num_nodes - done : kChunk;
      if ((int64_t)fread(buf, sizeof(uint64_t), n, f) != n) {
        free(heap);
        return kErrRead;
      }
      for (int64_t i = 0; i < n; ++i) {
        int64_t v = (int64_t)buf[i];
        if (v < prev) {
          free(heap);
          return kErrFormat;  // monotonicity
        }
        row_ptr[done + i + 1] = v;
        prev = v;
      }
      done += n;
    }
    if (prev != num_edges) {
      free(heap);
      return kErrFormat;
    }
  }
  {
    uint32_t* buf = (uint32_t*)heap;
    int64_t done = 0;
    while (done < num_edges) {
      int64_t n = num_edges - done < 2 * kChunk ? num_edges - done
                                                : 2 * kChunk;
      if ((int64_t)fread(buf, sizeof(uint32_t), n, f) != n) {
        free(heap);
        return kErrRead;
      }
      for (int64_t i = 0; i < n; ++i) {
        if (buf[i] >= (uint64_t)num_nodes) {
          free(heap);
          return kErrValue;
        }
        col_idx[done + i] = (int32_t)buf[i];
      }
      done += n;
    }
  }
  free(heap);
  return kOk;
}

int roc_lux_write(const char* path, int64_t num_nodes, int64_t num_edges,
                  const int64_t* row_ptr, const int32_t* col_idx) {
  FILE* f = fopen(path, "wb");
  if (!f) return kErrOpen;
  FileCloser closer{f};
  uint32_t v32 = (uint32_t)num_nodes;
  uint64_t e64 = (uint64_t)num_edges;
  if (fwrite(&v32, sizeof(v32), 1, f) != 1) return kErrRead;
  if (fwrite(&e64, sizeof(e64), 1, f) != 1) return kErrRead;
  for (int64_t v = 1; v <= num_nodes; ++v) {
    uint64_t off = (uint64_t)row_ptr[v];
    if (fwrite(&off, sizeof(off), 1, f) != 1) return kErrRead;
  }
  for (int64_t e = 0; e < num_edges; ++e) {
    uint32_t s = (uint32_t)col_idx[e];
    if (fwrite(&s, sizeof(s), 1, f) != 1) return kErrRead;
  }
  return kOk;
}

// ---------------------------------------------------------------------------
// CSV feature parser: `rows` lines of `cols` comma-separated floats.
// Orders of magnitude faster than np.loadtxt on Reddit-scale matrices.
// ---------------------------------------------------------------------------

namespace {
inline bool is_csv_sep(char c) {
  return c == ',' || c == '\n' || c == '\r' || c == ' ' || c == '\t';
}

// Locale-independent float parse of [tok, end).  Prefers
// std::from_chars (GCC 11+ ships the float overload); older libstdc++
// falls back to strtof with temporary NUL termination — *end is
// writable in both call sites (a separator byte, or the sentinel slot
// past the chunk buffer).  Returns false on malformed input.
inline bool parse_float_tok(char* tok, char* end, float* v) {
  if (*tok == '+') ++tok;  // from_chars rejects the leading '+'
                           // that strtof/np.loadtxt accept
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
  auto res = std::from_chars(tok, end, *v);
  return res.ec == std::errc{} && res.ptr == end;
#else
  char saved = *end;
  *end = '\0';
  char* stop = nullptr;
  errno = 0;
  *v = strtof(tok, &stop);
  *end = saved;
  return stop == end && errno != ERANGE;
#endif
}
}  // namespace

int roc_load_features_csv(const char* path, float* out, int64_t rows,
                          int64_t cols) {
  FILE* f = fopen(path, "rb");
  if (!f) return kErrOpen;
  FileCloser closer{f};
  // Fixed-size chunked parse (constant memory at any file size); a
  // token split across a chunk boundary is carried to the front of the
  // next chunk.  std::from_chars is locale-independent — strtof under
  // a non-C LC_NUMERIC would reject valid '.'-separated files.
  constexpr size_t kBuf = size_t{1} << 22;  // 4 MiB
  char* buf = (char*)malloc(kBuf + 1);
  if (!buf) return kErrRead;
  const int64_t total = rows * cols;
  int64_t i = 0;
  size_t carry = 0;
  int rc = kOk;
  for (;;) {
    size_t got = fread(buf + carry, 1, kBuf - carry, f);
    if (got == 0 && ferror(f)) {
      // a mid-file I/O failure is a read error, not a shape mismatch
      free(buf);
      return kErrRead;
    }
    size_t len = carry + got;
    const bool eof = got == 0;
    carry = 0;
    char* p = buf;
    char* const lim = buf + len;
    while (p < lim) {
      if (is_csv_sep(*p)) {
        ++p;
        continue;
      }
      char* tok = p;
      while (p < lim && !is_csv_sep(*p)) ++p;
      if (p == lim && !eof) {
        // token may continue in the next chunk
        carry = (size_t)(lim - tok);
        if (carry == kBuf) {
          rc = kErrFormat;  // single token larger than the buffer
        } else {
          memmove(buf, tok, carry);
        }
        break;
      }
      float v;
      if (!parse_float_tok(tok, p, &v)) {
        rc = kErrFormat;
        break;
      }
      if (i >= total) {
        // file holds more values than the declared shape
        rc = kErrFormat;
        break;
      }
      out[i++] = v;
    }
    if (rc != kOk || eof) break;
  }
  free(buf);
  // Exact-count check: a wrong `cols` mis-aligns every row, so both
  // under- and over-full files are format errors (the numpy fallback's
  // reshape raises in the same cases).
  return (rc == kOk && i == total) ? kOk : (rc != kOk ? rc : kErrFormat);
}

// Partition-local CSV read: skip `row_lo` newline-terminated lines,
// then parse (row_hi - row_lo) * cols floats.  The skip scans chunks
// counting '\n' without tokenizing — the reference loader's
// skip-to-rowLeft behavior (load_task.cu:41-51) for text features.
int roc_load_features_csv_rows(const char* path, float* out,
                               int64_t row_lo, int64_t row_hi,
                               int64_t cols) {
  FILE* f = fopen(path, "rb");
  if (!f) return kErrOpen;
  FileCloser closer{f};
  constexpr size_t kBuf = size_t{1} << 22;
  char* buf = (char*)malloc(kBuf + 1);
  if (!buf) return kErrRead;
  // Phase 1: skip row_lo lines.
  int64_t lines = 0;
  size_t resume = 0;  // unconsumed bytes at buf start for phase 2
  size_t len = 0;
  char* p = nullptr;
  while (lines < row_lo) {
    len = fread(buf, 1, kBuf, f);
    if (len == 0) {
      free(buf);
      return ferror(f) ? kErrRead : kErrFormat;  // fewer lines than rows
    }
    p = buf;
    char* const lim = buf + len;
    while (p < lim && lines < row_lo) {
      char* nl = (char*)memchr(p, '\n', (size_t)(lim - p));
      if (!nl) {
        p = lim;
        break;
      }
      ++lines;
      p = nl + 1;
    }
    if (lines == row_lo) {
      resume = (size_t)(buf + len - p);
      memmove(buf, p, resume);
      break;
    }
  }
  // Phase 2: parse exactly (row_hi - row_lo) * cols values, reusing the
  // chunked tokenizer with the carried tail.
  const int64_t total = (row_hi - row_lo) * cols;
  int64_t i = 0;
  size_t carry = resume;
  int rc = kOk;
  while (i < total) {
    size_t got = fread(buf + carry, 1, kBuf - carry, f);
    if (got == 0 && ferror(f)) {
      free(buf);
      return kErrRead;
    }
    size_t n = carry + got;
    const bool eof = got == 0;
    carry = 0;
    char* q = buf;
    char* const lim = buf + n;
    while (q < lim && i < total) {
      if (is_csv_sep(*q)) {
        ++q;
        continue;
      }
      char* tok = q;
      while (q < lim && !is_csv_sep(*q)) ++q;
      if (q == lim && !eof) {
        carry = (size_t)(lim - tok);
        if (carry == kBuf) {
          rc = kErrFormat;
        } else {
          memmove(buf, tok, carry);
        }
        break;
      }
      float v;
      if (!parse_float_tok(tok, q, &v)) {
        rc = kErrFormat;
        break;
      }
      out[i++] = v;
    }
    if (rc != kOk || (eof && i < total)) break;
  }
  free(buf);
  if (rc != kOk) return rc;
  return i == total ? kOk : kErrFormat;
}

// ---------------------------------------------------------------------------
// Mask parser: one of "Train"/"Val"/"Test"/"None" per line -> int32
// {1, 2, 3, 0} — the framework's MASK_* encoding (roc_tpu_torch/core/graph.py
// MASK_TRAIN/VAL/TEST/NONE and its numpy fallback).  Note the reference
// enum MaskType orders TRAIN=0/VAL=1/TEST=2/NONE=3 (gnn.h:98-103); only
// the on-disk tokens are shared, not the integer values.  Tokens are
// compared whole, like the numpy fallback — no prefix acceptance.
// ---------------------------------------------------------------------------

int roc_load_mask(const char* path, int32_t* out, int64_t n) {
  FILE* f = fopen(path, "rb");
  if (!f) return kErrOpen;
  FileCloser closer{f};
  char line[64];
  for (int64_t v = 0; v < n; ++v) {
    if (!fgets(line, sizeof(line), f)) return kErrRead;
    // strip surrounding whitespace like the fallback's str.strip()
    char* tok = line;
    while (*tok == ' ' || *tok == '\t') ++tok;
    size_t end = strlen(tok);
    while (end > 0 && (tok[end - 1] == '\n' || tok[end - 1] == '\r' ||
                       tok[end - 1] == ' ' || tok[end - 1] == '\t'))
      --end;
    tok[end] = '\0';
    if (strcmp(tok, "Train") == 0) {
      out[v] = 1;
    } else if (strcmp(tok, "Val") == 0) {
      out[v] = 2;
    } else if (strcmp(tok, "Test") == 0) {
      out[v] = 3;
    } else if (strcmp(tok, "None") == 0) {
      out[v] = 0;
    } else {
      return kErrFormat;
    }
  }
  return kOk;
}

// ---------------------------------------------------------------------------
// Edge-balanced greedy partitioner (reference gnn.cc:806-829): walk
// vertices accumulating in-degree; close a range when the running count
// exceeds cap = ceil(E / num_parts).  bounds: int64 [num_parts, 2]
// inclusive [left, right]; empty tail ranges get left > right.
// ---------------------------------------------------------------------------

int roc_edge_balanced_bounds(const int64_t* row_ptr, int64_t num_nodes,
                             int64_t num_parts, int64_t* bounds) {
  if (num_parts <= 0) return kErrValue;
  int64_t num_edges = row_ptr[num_nodes];
  int64_t cap = (num_edges + num_parts - 1) / num_parts;
  int64_t part = 0;
  int64_t left = 0;
  int64_t cnt = 0;
  for (int64_t v = 0; v < num_nodes; ++v) {
    cnt += row_ptr[v + 1] - row_ptr[v];
    if (cnt > cap && part < num_parts - 1) {
      bounds[2 * part] = left;
      bounds[2 * part + 1] = v;
      ++part;
      left = v + 1;
      cnt = 0;
    }
  }
  bounds[2 * part] = left;
  bounds[2 * part + 1] = num_nodes - 1;
  ++part;
  for (; part < num_parts; ++part) {
    bounds[2 * part] = num_nodes;      // empty tail range
    bounds[2 * part + 1] = num_nodes - 1;
  }
  return kOk;
}

// ---------------------------------------------------------------------------
// Self-edge insertion (the offline `.add_self_edge.lux` conversion the
// reference assumes, gnn.cc:756).  Two-phase: count, then fill.
// new_row_ptr: int64 [V+1]; new_col_idx: int32 [E + missing].
// Returns the number of inserted edges (>= 0) or a negative error.
// ---------------------------------------------------------------------------

int64_t roc_add_self_edges(const int64_t* row_ptr, const int32_t* col_idx,
                           int64_t num_nodes, int64_t* new_row_ptr,
                           int32_t* new_col_idx, int64_t new_capacity) {
  // Pass 1: which rows already have a self edge?
  int64_t missing = 0;
  for (int64_t v = 0; v < num_nodes; ++v) {
    bool has = false;
    for (int64_t e = row_ptr[v]; e < row_ptr[v + 1]; ++e) {
      if (col_idx[e] == v) {
        has = true;
        break;
      }
    }
    // stash per-row flag in new_row_ptr temporarily
    new_row_ptr[v + 1] = has ? 0 : 1;
    missing += has ? 0 : 1;
  }
  int64_t new_edges = row_ptr[num_nodes] + missing;
  if (new_edges > new_capacity) return kErrValue;
  // Pass 2: fill, keeping per-row edges contiguous (dst-major order).
  int64_t out = 0;
  new_row_ptr[0] = 0;
  for (int64_t v = 0; v < num_nodes; ++v) {
    bool insert = new_row_ptr[v + 1] != 0;
    for (int64_t e = row_ptr[v]; e < row_ptr[v + 1]; ++e)
      new_col_idx[out++] = col_idx[e];
    if (insert) new_col_idx[out++] = (int32_t)v;
    new_row_ptr[v + 1] = out;
  }
  return missing;
}

// ---------------------------------------------------------------------------
// ELL bucket shape computation: per-row power-of-two width bucket
// (floored at min_width).  Returns per-row widths so Python can
// allocate the stacked arrays without a per-row Python loop.
// ---------------------------------------------------------------------------

int roc_ell_widths(const int64_t* row_ptr, int64_t num_rows,
                   int32_t min_width, int32_t* widths) {
  for (int64_t v = 0; v < num_rows; ++v) {
    int64_t d = row_ptr[v + 1] - row_ptr[v];
    int32_t w = min_width;
    while (w < d) w *= 2;
    widths[v] = d == 0 ? 0 : w;
  }
  return kOk;
}

}  // extern "C"
