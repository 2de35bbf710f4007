// Multi-threaded bucket-store row layout.
//
// The host-side build lays the search-space corpus out in bucket-sorted,
// block-aligned order (gather by `order`, scatter to `pos`), normalizing
// and converting dtype on the fly. In round-1 this was a single-core NumPy
// loop costing 346 s of the 10M build (BENCH_10M.md); here it is a C++
// kernel parallelized over row ranges with std::thread.
//
// TPU-native counterpart of the reference's pandas groupby bucket
// formation (search/li/LearnedIndex.py:143-145) at scales pandas cannot
// reach. Exposed to Python via ctypes (tpulmi/native/__init__.py).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline float bf16_to_f32(uint16_t h) {
  uint32_t x = static_cast<uint32_t>(h) << 16;
  float f;
  std::memcpy(&f, &x, 4);
  return f;
}

inline uint16_t f32_to_bf16(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  // round to nearest even (matches ml_dtypes / XLA)
  uint32_t rounded = x + 0x7FFFu + ((x >> 16) & 1u);
  return static_cast<uint16_t>(rounded >> 16);
}

inline float f16_to_f32(uint16_t h) {
  uint32_t sign = (h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1Fu;
  uint32_t mant = h & 0x3FFu;
  uint32_t x;
  if (exp == 0) {
    if (mant == 0) {
      x = sign;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while ((mant & 0x400u) == 0) {
        mant <<= 1;
        --exp;
      }
      mant &= 0x3FFu;
      x = sign | (exp << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    x = sign | 0x7F800000u | (mant << 13);
  } else {
    x = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &x, 4);
  return f;
}

enum DType { F32 = 0, F16 = 1, BF16 = 2, I8 = 3 };

struct Args {
  const void* src;
  int src_dtype;
  const int32_t* order;
  const int64_t* pos;
  void* dst;
  int dst_dtype;
  float* scales;    // nullable (int8 only)
  int32_t* ids;     // nullable
  int64_t n;
  int64_t d;
  int normalize;
};

void worker(const Args& a, int64_t lo, int64_t hi, std::vector<float>& row) {
  const int64_t d = a.d;
  for (int64_t i = lo; i < hi; ++i) {
    const int64_t s = a.order[i];
    const int64_t t = a.pos[i];
    // load source row -> f32
    switch (a.src_dtype) {
      case F32: {
        const float* p = static_cast<const float*>(a.src) + s * d;
        std::memcpy(row.data(), p, d * sizeof(float));
        break;
      }
      case F16: {
        const uint16_t* p = static_cast<const uint16_t*>(a.src) + s * d;
        for (int64_t j = 0; j < d; ++j) row[j] = f16_to_f32(p[j]);
        break;
      }
      case BF16: {
        const uint16_t* p = static_cast<const uint16_t*>(a.src) + s * d;
        for (int64_t j = 0; j < d; ++j) row[j] = bf16_to_f32(p[j]);
        break;
      }
    }
    if (a.normalize) {
      double acc = 0.0;
      for (int64_t j = 0; j < d; ++j) acc += double(row[j]) * double(row[j]);
      float inv = 1.0f / float(std::sqrt(acc) > 1e-12 ? std::sqrt(acc) : 1e-12);
      for (int64_t j = 0; j < d; ++j) row[j] *= inv;
    }
    // store to destination dtype
    switch (a.dst_dtype) {
      case F32: {
        float* p = static_cast<float*>(a.dst) + t * d;
        std::memcpy(p, row.data(), d * sizeof(float));
        break;
      }
      case BF16: {
        uint16_t* p = static_cast<uint16_t*>(a.dst) + t * d;
        for (int64_t j = 0; j < d; ++j) p[j] = f32_to_bf16(row[j]);
        break;
      }
      case I8: {
        float amax = 0.0f;
        for (int64_t j = 0; j < d; ++j) {
          float v = std::fabs(row[j]);
          if (v > amax) amax = v;
        }
        if (amax < 1e-12f) amax = 1e-12f;
        const float scale = 127.0f / amax;
        int8_t* p = static_cast<int8_t*>(a.dst) + t * d;
        for (int64_t j = 0; j < d; ++j) {
          float q = std::nearbyintf(row[j] * scale);
          if (q > 127.0f) q = 127.0f;
          if (q < -127.0f) q = -127.0f;
          p[j] = static_cast<int8_t>(q);
        }
        if (a.scales) a.scales[t] = amax;
        break;
      }
    }
    if (a.ids) a.ids[t] = static_cast<int32_t>(s);
  }
}

}  // namespace

extern "C" int tpulmi_scatter_rows(
    const void* src, int src_dtype, const int32_t* order, const int64_t* pos,
    void* dst, int dst_dtype, float* scales, int32_t* ids, int64_t n,
    int64_t d, int normalize, int n_threads) {
  if (src_dtype < 0 || src_dtype > 2 || dst_dtype < 0 || dst_dtype > 3 ||
      dst_dtype == F16) {
    return 1;
  }
  if (n_threads < 1) n_threads = 1;
  if (n_threads > 64) n_threads = 64;
  std::vector<std::thread> threads;
  Args a{src, src_dtype, order, pos, dst, dst_dtype, scales, ids,
         n, d, normalize};
  const int64_t per = (n + n_threads - 1) / n_threads;
  for (int ti = 0; ti < n_threads; ++ti) {
    const int64_t lo = int64_t(ti) * per;
    const int64_t hi = lo + per < n ? lo + per : n;
    if (lo >= hi) break;
    threads.emplace_back([&a, lo, hi]() {
      std::vector<float> row(static_cast<size_t>(a.d));
      worker(a, lo, hi, row);
    });
  }
  for (auto& t : threads) t.join();
  return 0;
}

// ---------------------------------------------------------------------------
// Fused candidate gather + dot for the exact host rerank.
//
// The Python rerank (tpulmi/index.py:_rerank_host) gathers Q*K_EFF corpus
// rows into a (Q, K_EFF, d) block (~307 MB at the 10M shape) and runs a
// batched matmul over it — two passes over the candidate bytes plus a large
// transient allocation, ~0.34 s of every 10M search on this single-core
// host. Here each candidate row is read ONCE and dotted against its query
// on the fly (F16C+FMA vectorized when available), no intermediate block.
// Sentinel ids (< 0) are clamped to row 0 exactly like the NumPy gather;
// the caller overwrites those entries with the sentinel distance.
// ---------------------------------------------------------------------------

#if defined(__F16C__) && defined(__FMA__) && defined(__AVX__)
#define TPULMI_VEC_F16 1
#endif
#if defined(TPULMI_VEC_F16) || (defined(__AVX2__) && defined(__FMA__))
#include <immintrin.h>
#endif

namespace {

inline float dot_f32(const float* q, const float* row, int64_t d,
                     int normalize) {
#if defined(TPULMI_VEC_F16)
  __m256 acc = _mm256_setzero_ps();
  __m256 nrm = _mm256_setzero_ps();
  int64_t l = 0;
  for (; l + 8 <= d; l += 8) {
    __m256 r = _mm256_loadu_ps(row + l);
    acc = _mm256_fmadd_ps(_mm256_loadu_ps(q + l), r, acc);
    if (normalize) nrm = _mm256_fmadd_ps(r, r, nrm);
  }
  float acc8[8], nrm8[8];
  _mm256_storeu_ps(acc8, acc);
  _mm256_storeu_ps(nrm8, nrm);
  float s = 0.f, n2 = 0.f;
  for (int u = 0; u < 8; ++u) { s += acc8[u]; n2 += nrm8[u]; }
  for (; l < d; ++l) { s += q[l] * row[l]; if (normalize) n2 += row[l] * row[l]; }
#else
  float s8[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  float n8[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int64_t l = 0;
  for (; l + 8 <= d; l += 8) {
    for (int u = 0; u < 8; ++u) {
      s8[u] += q[l + u] * row[l + u];
      if (normalize) n8[u] += row[l + u] * row[l + u];
    }
  }
  float s = 0.f, n2 = 0.f;
  for (int u = 0; u < 8; ++u) { s += s8[u]; n2 += n8[u]; }
  for (; l < d; ++l) { s += q[l] * row[l]; if (normalize) n2 += row[l] * row[l]; }
#endif
  if (normalize) {
    float nrm_s = std::sqrt(n2);
    s /= (nrm_s > 1e-12f ? nrm_s : 1e-12f);
  }
  return s;
}

inline float dot_f16(const float* q, const uint16_t* row, int64_t d,
                     int normalize) {
#if defined(TPULMI_VEC_F16)
  __m256 acc = _mm256_setzero_ps();
  __m256 nrm = _mm256_setzero_ps();
  int64_t l = 0;
  for (; l + 8 <= d; l += 8) {
    __m256 r = _mm256_cvtph_ps(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(row + l)));
    acc = _mm256_fmadd_ps(_mm256_loadu_ps(q + l), r, acc);
    if (normalize) nrm = _mm256_fmadd_ps(r, r, nrm);
  }
  float acc8[8], nrm8[8];
  _mm256_storeu_ps(acc8, acc);
  _mm256_storeu_ps(nrm8, nrm);
  float s = 0.f, n2 = 0.f;
  for (int u = 0; u < 8; ++u) { s += acc8[u]; n2 += nrm8[u]; }
  for (; l < d; ++l) {
    float r = f16_to_f32(row[l]);
    s += q[l] * r;
    if (normalize) n2 += r * r;
  }
#else
  float s = 0.f, n2 = 0.f;
  for (int64_t l = 0; l < d; ++l) {
    float r = f16_to_f32(row[l]);
    s += q[l] * r;
    if (normalize) n2 += r * r;
  }
#endif
  if (normalize) {
    float nrm_s = std::sqrt(n2);
    s /= (nrm_s > 1e-12f ? nrm_s : 1e-12f);
  }
  return s;
}

// bf16 rows: the conversion is a 16-bit left shift — vectorized it is a
// zero-extend + shift + bitcast (AVX2), cheaper than the f16 cvtph path.
// This serves big-corpus reranks directly from the bf16 corpus the
// benches cache on disk, with no f16 shadow copy (at 40M rows the shadow
// alone is ~61 GB of host RAM — see tpulmi/index.py's shadow guard).
inline float dot_bf16(const float* q, const uint16_t* row, int64_t d,
                      int normalize) {
#if defined(__AVX2__) && defined(__FMA__)
  __m256 acc = _mm256_setzero_ps();
  __m256 nrm = _mm256_setzero_ps();
  int64_t l = 0;
  for (; l + 8 <= d; l += 8) {
    __m256i bits = _mm256_cvtepu16_epi32(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(row + l)));
    __m256 r = _mm256_castsi256_ps(_mm256_slli_epi32(bits, 16));
    acc = _mm256_fmadd_ps(_mm256_loadu_ps(q + l), r, acc);
    if (normalize) nrm = _mm256_fmadd_ps(r, r, nrm);
  }
  float acc8[8], nrm8[8];
  _mm256_storeu_ps(acc8, acc);
  _mm256_storeu_ps(nrm8, nrm);
  float s = 0.f, n2 = 0.f;
  for (int u = 0; u < 8; ++u) { s += acc8[u]; n2 += nrm8[u]; }
  for (; l < d; ++l) {
    float r = bf16_to_f32(row[l]);
    s += q[l] * r;
    if (normalize) n2 += r * r;
  }
#else
  float s = 0.f, n2 = 0.f;
  for (int64_t l = 0; l < d; ++l) {
    float r = bf16_to_f32(row[l]);
    s += q[l] * r;
    if (normalize) n2 += r * r;
  }
#endif
  if (normalize) {
    float nrm_s = std::sqrt(n2);
    s /= (nrm_s > 1e-12f ? nrm_s : 1e-12f);
  }
  return s;
}

}  // namespace

extern "C" int tpulmi_rerank_dot(
    const void* corpus, int corpus_dtype,  // 0 = f32, 1 = f16, 2 = bf16
    const int64_t* ids, const float* queries, float* out_sims,
    int64_t q, int64_t k_eff, int64_t d, int64_t n_rows,
    int normalize, int n_threads) {
  if (corpus_dtype != 0 && corpus_dtype != 1 && corpus_dtype != 2) return 1;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > 64) n_threads = 64;
  auto run = [&](int64_t i0, int64_t i1) {
    for (int64_t i = i0; i < i1; ++i) {
      const float* qv = queries + i * d;
      for (int64_t j = 0; j < k_eff; ++j) {
        int64_t id = ids[i * k_eff + j];
        if (id < 0) id = 0;  // sentinel: caller overwrites the distance
        if (id >= n_rows) id = n_rows - 1;
        float s;
        if (corpus_dtype == 0) {
          s = dot_f32(qv, reinterpret_cast<const float*>(corpus) + id * d,
                      d, normalize);
        } else if (corpus_dtype == 1) {
          s = dot_f16(qv,
                      reinterpret_cast<const uint16_t*>(corpus) + id * d,
                      d, normalize);
        } else {
          s = dot_bf16(qv,
                       reinterpret_cast<const uint16_t*>(corpus) + id * d,
                       d, normalize);
        }
        out_sims[i * k_eff + j] = s;
      }
    }
  };
  if (n_threads == 1) {
    run(0, q);
    return 0;
  }
  std::vector<std::thread> threads;
  const int64_t per = (q + n_threads - 1) / n_threads;
  for (int ti = 0; ti < n_threads; ++ti) {
    const int64_t lo = int64_t(ti) * per;
    const int64_t hi = lo + per < q ? lo + per : q;
    if (lo >= hi) break;
    threads.emplace_back(run, lo, hi);
  }
  for (auto& t : threads) t.join();
  return 0;
}
