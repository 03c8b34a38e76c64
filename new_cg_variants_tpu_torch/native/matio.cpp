// Host-side data loading of the PyTorch/CUDA port: a MatrixMarket
// coordinate parser and the COO -> padded-ELL packing, with a plain C
// interface bound through ctypes (new_cg_variants_tpu_torch/matio/_native.py).
//
// Built with g++ (C++17, -O3, no -march=native: the library is the same on
// every x86-64 host) into the package's ignored _build/ directory at first
// use.  The JAX package's native/matio.cpp computes the same functions; this
// is the port's own source.
//
//   ncgvt_read_coordinate  the entry triplets of a coordinate file, 0-based
//   ncgvt_pack_ell         COO sorted by (row, col) -> slot-major padded ELL
//   ncgvt_free             release the reader's buffers

#include <cstdint>
#include <cstdio>
#include <cstdlib>

namespace {

// The whole file in a NUL-terminated heap buffer, or nullptr.
char* slurp(const char* path) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long len = std::ftell(f);
  if (len < 0) {
    std::fclose(f);
    return nullptr;
  }
  std::fseek(f, 0, SEEK_SET);
  char* buf = static_cast<char*>(std::malloc(static_cast<size_t>(len) + 1));
  if (buf) buf[std::fread(buf, 1, static_cast<size_t>(len), f)] = '\0';
  std::fclose(f);
  return buf;
}

void skip_line(const char*& p) {
  while (*p && *p != '\n') ++p;
  if (*p == '\n') ++p;
}

// One integer field at p; false when there is none.
bool next_int(const char*& p, long long* out) {
  char* end = nullptr;
  *out = std::strtoll(p, &end, 10);
  if (end == p) return false;
  p = end;
  return true;
}

}  // namespace

extern "C" {

// Parse the entries of a MatrixMarket coordinate file with a value on every
// line (real, double or integer field).  The size line's nnz sets the count;
// the three output arrays are malloc'd (free with ncgvt_free) and indices
// are 0-based.  Returns the number of entries, or -1 when the file cannot be
// read or holds fewer well-formed entries than its size line says.
int64_t ncgvt_read_coordinate(const char* path, int64_t** row_out,
                              int64_t** col_out, double** val_out) {
  char* buf = slurp(path);
  if (!buf) return -1;
  const char* p = buf;
  while (*p == '%') skip_line(p);
  long long m = 0, n = 0, nnz = 0;
  if (!next_int(p, &m) || !next_int(p, &n) || !next_int(p, &nnz) || nnz < 0) {
    std::free(buf);
    return -1;
  }
  auto* row = static_cast<int64_t*>(std::malloc(sizeof(int64_t) * (nnz + 1)));
  auto* col = static_cast<int64_t*>(std::malloc(sizeof(int64_t) * (nnz + 1)));
  auto* val = static_cast<double*>(std::malloc(sizeof(double) * (nnz + 1)));
  int64_t k = 0;
  if (row && col && val) {
    for (; k < nnz; ++k) {
      long long i = 0, j = 0;
      if (!next_int(p, &i) || !next_int(p, &j)) break;
      char* end = nullptr;
      double v = std::strtod(p, &end);
      if (end == p) break;  // a pattern line: no value
      p = end;
      row[k] = i - 1;
      col[k] = j - 1;
      val[k] = v;
    }
  }
  std::free(buf);
  if (!(row && col && val) || k != nnz) {
    std::free(row);
    std::free(col);
    std::free(val);
    return -1;
  }
  *row_out = row;
  *col_out = col;
  *val_out = val;
  return k;
}

void ncgvt_free(void* p) { std::free(p); }

// COO -> padded ELL in slot-major storage: entry e of row i, the s-th of its
// row in the given order, goes to val_t[s * n + i] (added into the zero the
// caller filled it with, as the JAX package's packing adds) and
// idx_t[s * n + i].  The caller fills val_t with zeros and idx_t with each
// slot's row index (padding that gathers in bounds).  Entries must be
// sorted by (row, col).  Returns 0, or -1 when a row index is out of range
// or a row has more than L entries.
int ncgvt_pack_ell(const int64_t* row, const int64_t* col, const double* val,
                   int64_t nnz, int64_t n, int64_t L, double* val_t,
                   int32_t* idx_t) {
  auto* slot = static_cast<int64_t*>(std::calloc(n > 0 ? n : 1,
                                                 sizeof(int64_t)));
  if (!slot) return -1;
  for (int64_t e = 0; e < nnz; ++e) {
    int64_t i = row[e];
    if (i < 0 || i >= n || slot[i] >= L) {
      std::free(slot);
      return -1;
    }
    int64_t s = slot[i]++;
    val_t[s * n + i] += val[e];
    idx_t[s * n + i] = static_cast<int32_t>(col[e]);
  }
  std::free(slot);
  return 0;
}

}  // extern "C"
