// Fast PLINK .ld parser and band assembler for sgvamp.
//
// The reference parses .ld tables with pandas.read_table and assembles a
// CSR in Python (reference src/main.py:205-257, scripts/plink2np.py:33-49),
// which is minutes-slow and memory-hungry at biobank scale. This native
// path streams the file once, resolves SNP names against the harmonized
// variant index with a single hash map, and can assemble symmetric band
// storage directly - the layout the banded operators pack from.
//
// C ABI (ctypes-friendly):
//   ldparse_parse(path, variants_blob, n_variants) -> handle (NULL on OOM)
//   ldparse_error(handle)  -> error string or NULL
//   ldparse_count(handle)  -> number of parsed (a, b, r) triplets
//   ldparse_copy(handle, a, b, v) -> copy out triplets (caller allocates)
//   ldparse_free(handle)
//   ldparse_max_bandwidth(n, a, b) -> max |a-b|
//   ldparse_to_band(n, a, b, v, M, bw, band) -> dropped-entry count;
//       band is float32 (M, 2*bw+1), diagonal preset to 1 by this call.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Result {
  std::vector<int64_t> a, b;
  std::vector<double> v;
  std::string err;
};

// Split a line into whitespace-separated tokens (in place, no copies).
inline int tokenize(char* line, char** toks, int max_toks) {
  int n = 0;
  char* p = line;
  while (*p && n < max_toks) {
    while (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n') ++p;
    if (!*p) break;
    toks[n++] = p;
    while (*p && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n') ++p;
    if (*p) *p++ = '\0';
  }
  return n;
}

template <typename T>
int64_t to_band_impl(int64_t n, const int64_t* a, const int64_t* b,
                     const double* v, int64_t M, int64_t bw, T* band) {
  const int64_t nd = 2 * bw + 1;
  // unit diagonal (reference csr assembly adds ones(M), src/main.py:255)
  for (int64_t i = 0; i < M; ++i) band[i * nd + bw] = T(1);
  int64_t dropped = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t r0 = a[i], c0 = b[i];
    int64_t d = c0 - r0;
    if (d > bw || d < -bw) {
      ++dropped;
      continue;
    }
    T val = static_cast<T>(v[i]);
    band[r0 * nd + (bw + d)] = val;       // R[r0, c0]
    band[c0 * nd + (bw - d)] = val;       // symmetric mirror
  }
  return dropped;
}

}  // namespace

extern "C" {

void* ldparse_parse(const char* path, const char* variants_blob,
                    int64_t n_variants) {
  auto* res = new (std::nothrow) Result();
  if (!res) return nullptr;

  // Build the variant -> reference-index map over the '\n'-separated blob.
  std::unordered_map<std::string_view, int64_t> index;
  index.reserve(static_cast<size_t>(n_variants) * 2);
  {
    const char* p = variants_blob;
    for (int64_t i = 0; i < n_variants; ++i) {
      const char* q = strchr(p, '\n');
      size_t len = q ? static_cast<size_t>(q - p) : strlen(p);
      index.emplace(std::string_view(p, len), i);
      if (!q) break;
      p = q + 1;
    }
  }

  FILE* f = fopen(path, "rb");
  if (!f) {
    res->err = std::string("cannot open ") + path;
    return res;
  }

  char buf[1 << 16];
  char* toks[64];
  int col_a = -1, col_b = -1, col_r = -1;

  // Header: locate SNP_A, SNP_B, R columns.
  if (fgets(buf, sizeof(buf), f)) {
    int n = tokenize(buf, toks, 64);
    for (int i = 0; i < n; ++i) {
      if (!strcmp(toks[i], "SNP_A")) col_a = i;
      else if (!strcmp(toks[i], "SNP_B")) col_b = i;
      else if (!strcmp(toks[i], "R")) col_r = i;
    }
  }
  if (col_a < 0 || col_b < 0 || col_r < 0) {
    res->err = "missing SNP_A/SNP_B/R columns in .ld header";
    fclose(f);
    return res;
  }
  int need = (col_a > col_b ? col_a : col_b) > col_r
                 ? (col_a > col_b ? col_a : col_b)
                 : col_r;

  int64_t lineno = 1;
  while (fgets(buf, sizeof(buf), f)) {
    ++lineno;
    int n = tokenize(buf, toks, 64);
    if (n == 0) continue;  // blank line
    if (n <= need) {
      res->err = "short line " + std::to_string(lineno);
      break;
    }
    auto ia = index.find(std::string_view(toks[col_a]));
    auto ib = index.find(std::string_view(toks[col_b]));
    if (ia == index.end() || ib == index.end()) {
      res->err = "unknown SNP on line " + std::to_string(lineno);
      break;
    }
    res->a.push_back(ia->second);
    res->b.push_back(ib->second);
    res->v.push_back(strtod(toks[col_r], nullptr));
  }
  fclose(f);
  return res;
}

const char* ldparse_error(void* h) {
  auto* res = static_cast<Result*>(h);
  return res->err.empty() ? nullptr : res->err.c_str();
}

int64_t ldparse_count(void* h) {
  return static_cast<int64_t>(static_cast<Result*>(h)->a.size());
}

void ldparse_copy(void* h, int64_t* a, int64_t* b, double* v) {
  auto* res = static_cast<Result*>(h);
  size_t n = res->a.size();
  memcpy(a, res->a.data(), n * sizeof(int64_t));
  memcpy(b, res->b.data(), n * sizeof(int64_t));
  memcpy(v, res->v.data(), n * sizeof(double));
}

void ldparse_free(void* h) { delete static_cast<Result*>(h); }

int64_t ldparse_max_bandwidth(int64_t n, const int64_t* a, const int64_t* b) {
  int64_t bw = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t d = a[i] > b[i] ? a[i] - b[i] : b[i] - a[i];
    if (d > bw) bw = d;
  }
  return bw;
}

int64_t ldparse_to_band(int64_t n, const int64_t* a, const int64_t* b,
                        const double* v, int64_t M, int64_t bw, float* band) {
  return to_band_impl(n, a, b, v, M, bw, band);
}

int64_t ldparse_to_band_f64(int64_t n, const int64_t* a, const int64_t* b,
                            const double* v, int64_t M, int64_t bw,
                            double* band) {
  return to_band_impl(n, a, b, v, M, bw, band);
}

}  // extern "C"

// -- direct CSR -> symmetric band (data/loaders.csr_to_band fast path) -----
//
// The Python path expands CSR to COO, masks |col-row| <= bw, and fancy-
// scatters 100M+ entries (measured 25 s of the 53 s biobank ingestion at
// M=512k / 135M nnz); one row-ordered pass over indptr/indices writes the
// band rows sequentially instead. The diagonal comes from the matrix
// itself (same contract as the Python path). Returns the dropped-entry
// count (|col - row| > bw).

namespace {

template <typename I, typename V>
int64_t csr_to_band_impl(int64_t M, const I* indptr, const I* indices,
                         const V* data, int64_t bw, float* band) {
  const int64_t W = 2 * bw + 1;
  int64_t dropped = 0;
  for (int64_t i = 0; i < M; ++i) {
    float* row = band + i * W;
    const int64_t k1 = static_cast<int64_t>(indptr[i + 1]);
    for (int64_t k = static_cast<int64_t>(indptr[i]); k < k1; ++k) {
      const int64_t d = static_cast<int64_t>(indices[k]) - i;
      if (d < -bw || d > bw) {
        ++dropped;
        continue;
      }
      row[bw + d] = static_cast<float>(data[k]);
    }
  }
  return dropped;
}

template <typename I>
int64_t csr_max_bw_impl(int64_t M, const I* indptr, const I* indices) {
  int64_t bw = 0;
  for (int64_t i = 0; i < M; ++i) {
    const int64_t k1 = static_cast<int64_t>(indptr[i + 1]);
    for (int64_t k = static_cast<int64_t>(indptr[i]); k < k1; ++k) {
      const int64_t d = static_cast<int64_t>(indices[k]) - i;
      const int64_t ad = d < 0 ? -d : d;
      if (ad > bw) bw = ad;
    }
  }
  return bw;
}

}  // namespace

extern "C" {

int64_t ldparse_csr_to_band_i32_f32(int64_t M, const int32_t* indptr,
                                    const int32_t* indices, const float* data,
                                    int64_t bw, float* band) {
  return csr_to_band_impl(M, indptr, indices, data, bw, band);
}

int64_t ldparse_csr_to_band_i32_f64(int64_t M, const int32_t* indptr,
                                    const int32_t* indices, const double* data,
                                    int64_t bw, float* band) {
  return csr_to_band_impl(M, indptr, indices, data, bw, band);
}

int64_t ldparse_csr_to_band_i64_f32(int64_t M, const int64_t* indptr,
                                    const int64_t* indices, const float* data,
                                    int64_t bw, float* band) {
  return csr_to_band_impl(M, indptr, indices, data, bw, band);
}

int64_t ldparse_csr_to_band_i64_f64(int64_t M, const int64_t* indptr,
                                    const int64_t* indices, const double* data,
                                    int64_t bw, float* band) {
  return csr_to_band_impl(M, indptr, indices, data, bw, band);
}

int64_t ldparse_csr_max_bw_i32(int64_t M, const int32_t* indptr,
                               const int32_t* indices) {
  return csr_max_bw_impl(M, indptr, indices);
}

int64_t ldparse_csr_max_bw_i64(int64_t M, const int64_t* indptr,
                               const int64_t* indices) {
  return csr_max_bw_impl(M, indptr, indices);
}

// -- band -> upper-triangle int8 blocks (SymBandedLD.from_band fast path) --
//
// One pass builds the (nb, hb+1, B, B) upper blocks from float32 band
// storage and quantizes them symmetrically per block (q = rint(v/scale),
// scale = max|v|/127), bit-identical to the numpy path: the float32
// divide and round-half-even match np.rint elementwise, and abs-max is
// order-independent. Rows past M_orig are the pad rows (unit diagonal);
// columns past the band are zero; blocks whose column index runs past the
// matrix (d >= 1, i >= nb - d) stay exactly zero with scale 0 - the same
// invariants the Python path enforces. The numpy version moves ~5 GB of
// float temporaries through 2 vCPUs (measured 16.8 s at M=512k, B=128);
// this pass reads the band once and writes int8 + scales (~1 s).

void ldparse_band_pack_i8(const float* band, int64_t M_orig, int64_t nd,
                          int64_t B, int64_t nb, int64_t hb, int8_t* upper,
                          float* scales) {
  const int64_t bw = (nd - 1) / 2;
  std::vector<float> blk(static_cast<size_t>(B) * B);
  for (int64_t i = 0; i < nb; ++i) {
    for (int64_t d = 0; d <= hb; ++d) {
      int8_t* out = upper + ((i * (hb + 1) + d) * B * B);
      float* sc_out = scales + (i * (hb + 1) + d);
      if (d >= 1 && i >= nb - d) {  // past-matrix block: exact zeros
        memset(out, 0, static_cast<size_t>(B) * B);
        *sc_out = 0.0f;
        continue;
      }
      float amax = 0.0f;
      for (int64_t p = 0; p < B; ++p) {
        const int64_t row = i * B + p;
        float* dst = blk.data() + p * B;
        if (row >= M_orig) {  // pad row: unit diagonal only
          memset(dst, 0, static_cast<size_t>(B) * sizeof(float));
          if (d == 0) {
            dst[p] = 1.0f;
            if (1.0f > amax) amax = 1.0f;
          }
          continue;
        }
        const float* brow = band + row * nd;
        const int64_t base = bw + d * B - p;  // col offset for q = 0
        const int64_t q0 = base < 0 ? -base : 0;
        const int64_t q1 = base + B > nd ? nd - base : B;
        for (int64_t q = 0; q < q0; ++q) dst[q] = 0.0f;
        for (int64_t q = q0; q < q1; ++q) {
          const float v = brow[base + q];
          dst[q] = v;
          const float a = v < 0 ? -v : v;
          if (a > amax) amax = a;
        }
        for (int64_t q = q1 < 0 ? 0 : q1; q < B; ++q) dst[q] = 0.0f;
      }
      const float sc = amax / 127.0f;
      *sc_out = sc;
      if (sc == 0.0f) {
        memset(out, 0, static_cast<size_t>(B) * B);
        continue;
      }
      for (int64_t k = 0; k < B * B; ++k) {
        float q = nearbyintf(blk[k] / sc);
        if (q > 127.0f) q = 127.0f;
        if (q < -127.0f) q = -127.0f;
        out[k] = static_cast<int8_t>(q);
      }
    }
  }
}

}  // extern "C"
