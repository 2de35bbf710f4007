// The exact host rerank in one threaded pass per query row.
//
// `LearnedIndex._rerank_host` used to prepare the candidates in numpy
// (a stable-argsort dedup of the ids, a normalised float32 copy of the
// queries), call `tpulmi_rerank_dot`, then order the distances with a
// second stable argsort, every numpy step on one core. Here each thread
// takes a range of query rows and, for each row, marks repeated ids
// empty, divides the query by its norm (the caller's, computed in numpy),
// dots every kept candidate with the same inline functions
// `tpulmi_rerank_dot` calls, and keeps the k smallest distances by a
// stable selection. Every step gives the bits of the numpy composition it
// replaces.
//
// layout.cpp is included whole, so that the dot functions are shared and
// the library stays one translation unit; it is kept byte for byte equal
// to the JAX package's source.

#include "layout.cpp"

namespace {

constexpr float kSentinelDist = 10000.0f;  // ops/distance.py SENTINEL_DIST

// The candidate rows lie at random in a corpus far larger than the caches,
// so a dot waits on memory: each candidate asks for the row of the one
// this many places later in the thread's range (one thread, 10k queries
// of 14 candidates over a 768-d float16 corpus: 72.1 -> 57.7 ms on an H100
// machine's host at 10M rows, 86.8 -> 61.1 ms on an Intel Xeon at 1M).
constexpr int64_t kPrefetchAhead = 8;

inline void prefetch_row(const char* p, int64_t bytes) {
  for (int64_t b = 0; b < bytes; b += 64) __builtin_prefetch(p + b);
  __builtin_prefetch(p + bytes - 1);
}

// numpy's sort order for floats: NaN after everything
inline bool sorts_before(float a, float b) {
  return a < b || (b != b && a == a);
}

template <typename Id>
void rerank_rows(const void* corpus, int corpus_dtype, const Id* ids,
                 const float* queries, const float* norms, float* out_dists,
                 Id* out_ids, int64_t i0, int64_t i1, int64_t k_eff,
                 int64_t k, int64_t d, int64_t n_rows, int normalize) {
  std::vector<float> qn(static_cast<size_t>(d));
  std::vector<float> exact(static_cast<size_t>(k_eff));
  std::vector<Id> kept(static_cast<size_t>(k_eff));
  std::vector<int64_t> top(static_cast<size_t>(k));
  const int64_t row_bytes = d * (corpus_dtype == F32 ? 4 : 2);
  const int64_t last = i1 * k_eff;
  for (int64_t i = i0; i < i1; ++i) {
    const Id* row_ids = ids + i * k_eff;
    const float* qv = queries + i * d;
    const float nrm = norms[i];
    for (int64_t l = 0; l < d; ++l) qn[l] = qv[l] / nrm;
    for (int64_t j = 0; j < k_eff; ++j) {
      const int64_t ahead = i * k_eff + j + kPrefetchAhead;
      if (ahead < last && ids[ahead] >= 0) {
        const int64_t r = ids[ahead] < n_rows ? int64_t(ids[ahead])
                                              : n_rows - 1;
        prefetch_row(static_cast<const char*>(corpus) + r * row_bytes,
                     row_bytes);
      }
      const Id id = row_ids[j];
      bool empty = id < 0;
      // a repeat of an earlier id in the row: the first occurrence stays
      for (int64_t p = 0; p < j && !empty; ++p) empty = row_ids[p] == id;
      kept[j] = (id >= 0 && empty) ? Id(-1) : id;
      if (empty) {
        exact[j] = kSentinelDist;
        continue;
      }
      int64_t r = id < n_rows ? int64_t(id) : n_rows - 1;
      float s;
      if (corpus_dtype == F32) {
        s = dot_f32(qn.data(), static_cast<const float*>(corpus) + r * d, d,
                    normalize);
      } else if (corpus_dtype == F16) {
        s = dot_f16(qn.data(), static_cast<const uint16_t*>(corpus) + r * d,
                    d, normalize);
      } else {
        s = dot_bf16(qn.data(), static_cast<const uint16_t*>(corpus) + r * d,
                     d, normalize);
      }
      exact[j] = 1.0f - s;
    }
    // the k smallest, ties in candidate order: each new candidate goes
    // after every kept one it does not sort before
    int64_t n = 0;
    for (int64_t j = 0; j < k_eff; ++j) {
      const float v = exact[j];
      if (n == k && !sorts_before(v, exact[top[k - 1]])) continue;
      int64_t pos = n < k ? n++ : k - 1;
      for (; pos > 0 && sorts_before(v, exact[top[pos - 1]]); --pos) {
        top[pos] = top[pos - 1];
      }
      top[pos] = j;
    }
    for (int64_t r = 0; r < k; ++r) {
      out_dists[i * k + r] = exact[top[r]];
      out_ids[i * k + r] = kept[top[r]];
    }
  }
}

}  // namespace

// ids: (q, k_eff) int32 (ids_64 = 0) or int64 (ids_64 = 1), -1 = empty;
// queries: (q, d) float32 as the caller holds them, norms: (q,) their
// clamped L2 norms; out_dists (q, k) float32 and out_ids (q, k) of the ids'
// type, k <= k_eff.
extern "C" int tpulmi_rerank_fused(
    const void* corpus, int corpus_dtype,  // 0 = f32, 1 = f16, 2 = bf16
    const void* ids, int ids_64, const float* queries, const float* norms,
    float* out_dists, void* out_ids, int64_t q, int64_t k_eff, int64_t k,
    int64_t d, int64_t n_rows, int normalize, int n_threads) {
  if (corpus_dtype != F32 && corpus_dtype != F16 && corpus_dtype != BF16) {
    return 1;
  }
  if (k < 1 || k > k_eff || n_rows < 1) return 2;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > 64) n_threads = 64;
  auto run = [&](int64_t i0, int64_t i1) {
    if (ids_64) {
      rerank_rows(corpus, corpus_dtype, static_cast<const int64_t*>(ids),
                  queries, norms, out_dists, static_cast<int64_t*>(out_ids),
                  i0, i1, k_eff, k, d, n_rows, normalize);
    } else {
      rerank_rows(corpus, corpus_dtype, static_cast<const int32_t*>(ids),
                  queries, norms, out_dists, static_cast<int32_t*>(out_ids),
                  i0, i1, k_eff, k, d, n_rows, normalize);
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
