// The exact float16 rerank on the card, for Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package reranks on the host, and so did
// the port (csrc/rerank_fused.cpp, one threaded pass over a float16 copy of
// the corpus in host RAM). That pass reads its rows from host memory at
// ~17 GB/s, 13-25 ms a request of 10k queries at depth 14-20, while the
// card has nothing to do. Here the float16 copy lies in HBM and the same
// function runs beside the probe kernels, on the same stream.
//
// What it computes, for each query row i (as rerank_fused.cpp does):
//   - the query divided by its L2 norm, clamped at 1e-12;
//   - a repeat of an earlier id in the row becomes empty (id -1), and so is
//     a negative id; an empty place keeps the distance 10000;
//   - every other candidate's distance 1 - q.row, the float32 dot of the
//     divided query with the float16 row (with `normalize`, divided by the
//     row's own clamped norm); an id past the corpus reads its last row;
//   - the k smallest distances, ascending with NaN last, ties in candidate
//     order: the stable order of the host pass and of numpy's argsort.
// The sums are taken in another order than on the host, so distances agree
// to float32 rounding, not to the bit.
//
// Design. One warp a query row, 8 warps a CTA. A lane holds its chunks of
// the divided query in registers (CPL chunks of 8 features; a 768-d row is
// 96 chunks of 16 bytes, 3 a lane) and reads the candidate rows as 16-byte
// loads, neighbouring lanes on neighbouring chunks; R candidate rows (4, or
// 2 for wide rows) are asked for before the first is summed, so that each
// lane keeps R x CPL loads in flight. Each dot ends in a shuffle reduction.
// The dedup and the selection take one candidate a lane (k_eff <= 64: two
// slots a lane): a candidate's place is the number of candidates that sort
// before it, and it is written if that place is below k.
//
// What bounds it: bytes. It reads q k_eff d 2 bytes of rows and q d 4 of
// queries and writes q k (4 + the id's width): 246 MB at the 10M cell's
// shape (q 10k, k_eff 14, d 768), 0.073 ms at 3.35 TB/s, and 338 MB, 0.101
// ms, at 20M (k_eff 20). The rows lie at random in a copy far larger than
// L2, so what the design does about the bound is to keep enough rows in
// flight: each warp has R rows outstanding and every resident warp of the
// card works at once (10k warps for 10k queries).
//
// Limits. k_eff <= 64, 1 <= k <= k_eff, d % 8 == 0 and d <= 2048; ids int32
// or int64, -1 = empty.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_K_EFF = 64;
constexpr int MAX_CPL = 8;  // 16-byte chunks a lane: d <= 8 * 32 * 8
constexpr unsigned FULL = 0xffffffffu;
constexpr float SENTINEL = 10000.0f;  // ops/distance.py SENTINEL_DIST

// numpy's sort order for floats: NaN after everything
__device__ __forceinline__ bool sorts_before(float a, float b) {
  return a < b || (b != b && a == a);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <int CPL, typename Id>
__global__ void __launch_bounds__(THREADS)
rerank_card_kernel(const uint4 *__restrict__ corpus,   // (n_rows, d / 8)
                   const Id *__restrict__ ids,         // (q, k_eff)
                   const float *__restrict__ queries,  // (q, d)
                   float *__restrict__ out_d,          // (q, k)
                   Id *__restrict__ out_i,             // (q, k)
                   int q, int k_eff, int k, int d, long long n_rows,
                   int normalize) {
  constexpr int R = CPL <= 3 ? 4 : 2;  // candidate rows in flight
  const int lane = threadIdx.x & 31;
  const long long i =
      static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (i >= q) return;
  const int nc = d >> 3;  // 16-byte chunks a row

  // the query, then divided by its clamped norm
  float qv[CPL][8];
  float ss = 0.f;
  const float4 *qrow = reinterpret_cast<const float4 *>(queries + i * d);
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int ch = lane + 32 * c;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (ch < nc) {
      a = qrow[2 * ch];
      b = qrow[2 * ch + 1];
    }
    qv[c][0] = a.x, qv[c][1] = a.y, qv[c][2] = a.z, qv[c][3] = a.w;
    qv[c][4] = b.x, qv[c][5] = b.y, qv[c][6] = b.z, qv[c][7] = b.w;
#pragma unroll
    for (int e = 0; e < 8; ++e) ss = fmaf(qv[c][e], qv[c][e], ss);
  }
  const float nrm = fmaxf(sqrtf(warp_sum(ss)), 1e-12f);
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
#pragma unroll
    for (int e = 0; e < 8; ++e) qv[c][e] = qv[c][e] / nrm;
  }

  // candidate j lies in lane j % 32, slot j / 32; a repeat of an earlier id
  // in the row is empty (the first occurrence stays)
  const Id *row_ids = ids + i * k_eff;
  const Id id0 = lane < k_eff ? row_ids[lane] : Id(-1);
  const Id id1 = lane + 32 < k_eff ? row_ids[lane + 32] : Id(-1);
  bool dup0 = false, dup1 = false;
  for (int p = 0; p < k_eff; ++p) {
    const Id idp = __shfl_sync(FULL, p < 32 ? id0 : id1, p & 31);
    dup0 |= p < lane && idp == id0;
    dup1 |= p < lane + 32 && idp == id1;
  }
  const bool empty0 = id0 < 0 || dup0, empty1 = id1 < 0 || dup1;
  const Id kept0 = (id0 >= 0 && empty0) ? Id(-1) : id0;
  const Id kept1 = (id1 >= 0 && empty1) ? Id(-1) : id1;
  const unsigned long long live =
      (static_cast<unsigned long long>(
           __ballot_sync(FULL, !empty1 && lane + 32 < k_eff))
       << 32) |
      __ballot_sync(FULL, !empty0 && lane < k_eff);

  float v0 = SENTINEL, v1 = SENTINEL;
  for (int j0 = 0; j0 < k_eff; j0 += R) {
    uint4 x[R][CPL];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = j0 + r;
      const bool on = j < k_eff && ((live >> (j & 63)) & 1ull);
      const Id id = __shfl_sync(FULL, (j & 32) ? id1 : id0, j & 31);
      const long long row =
          on ? (id < n_rows ? static_cast<long long>(id) : n_rows - 1) : 0;
      const uint4 *p = corpus + row * nc;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int ch = lane + 32 * c;
        x[r][c] = (on && ch < nc) ? __ldg(p + ch) : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = 0.f, n2 = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const __half2 *h = reinterpret_cast<const __half2 *>(&x[r][c]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __half22float2(h[e]);
          s = fmaf(qv[c][2 * e], f.x, s);
          s = fmaf(qv[c][2 * e + 1], f.y, s);
          if (normalize) {
            n2 = fmaf(f.x, f.x, n2);
            n2 = fmaf(f.y, f.y, n2);
          }
        }
      }
      s = warp_sum(s);
      if (normalize) s /= fmaxf(sqrtf(warp_sum(n2)), 1e-12f);
      const int j = j0 + r;
      const bool on = j < k_eff && ((live >> (j & 63)) & 1ull);
      const float v = on ? 1.0f - s : SENTINEL;
      if (j == lane) v0 = v;
      if (j == lane + 32) v1 = v;
    }
  }

  // a candidate's place: the candidates that sort before it, ties in
  // candidate order
  int rank0 = 0, rank1 = 0;
  for (int p = 0; p < k_eff; ++p) {
    const float vp = __shfl_sync(FULL, p < 32 ? v0 : v1, p & 31);
    rank0 += sorts_before(vp, v0) || (p < lane && !sorts_before(v0, vp));
    rank1 += sorts_before(vp, v1) || (p < lane + 32 && !sorts_before(v1, vp));
  }
  if (lane < k_eff && rank0 < k) {
    out_d[i * k + rank0] = v0;
    out_i[i * k + rank0] = kept0;
  }
  if (lane + 32 < k_eff && rank1 < k) {
    out_d[i * k + rank1] = v1;
    out_i[i * k + rank1] = kept1;
  }
}

template <int CPL, typename Id>
int launch(const void *corpus, const void *ids, const void *queries,
           void *out_d, void *out_i, int q, int k_eff, int k, int d,
           long long n_rows, int normalize, cudaStream_t stream) {
  const int grid = (q + WARPS - 1) / WARPS;
  rerank_card_kernel<CPL, Id><<<grid, THREADS, 0, stream>>>(
      static_cast<const uint4 *>(corpus), static_cast<const Id *>(ids),
      static_cast<const float *>(queries), static_cast<float *>(out_d),
      static_cast<Id *>(out_i), q, k_eff, k, d, n_rows, normalize);
  return int(cudaGetLastError());
}

template <typename Id>
int launch_width(const void *corpus, const void *ids, const void *queries,
                 void *out_d, void *out_i, int q, int k_eff, int k, int d,
                 long long n_rows, int normalize, cudaStream_t s) {
#define RERANK_CARD_CASE(CPL)                                              \
  case CPL:                                                                \
    return launch<CPL, Id>(corpus, ids, queries, out_d, out_i, q, k_eff, k, \
                           d, n_rows, normalize, s);
  switch ((d / 8 + 31) / 32) {
    RERANK_CARD_CASE(1)
    RERANK_CARD_CASE(2)
    RERANK_CARD_CASE(3)
    RERANK_CARD_CASE(4)
    RERANK_CARD_CASE(5)
    RERANK_CARD_CASE(6)
    RERANK_CARD_CASE(7)
    RERANK_CARD_CASE(8)
    default:
      return int(cudaErrorInvalidValue);
  }
#undef RERANK_CARD_CASE
}

}  // namespace

extern "C" {

// Rerank on `stream`: corpus (n_rows, d) float16, ids (q, k_eff) int32
// (ids_64 = 0) or int64 (ids_64 = 1), -1 = empty, queries (q, d) float32,
// into out_d (q, k) float32 and out_i (q, k) of the ids' type; `normalize`
// divides each row by its own norm. Every pointer 16-byte aligned. Returns
// the CUDA error code (0 = ok).
int rerank_card_launch(const void *corpus, const void *ids, int ids_64,
                       const void *queries, void *out_d, void *out_i, int q,
                       int k_eff, int k, int d, long long n_rows,
                       int normalize, void *stream) {
  if (q <= 0) return 0;
  if (k_eff < 1 || k_eff > MAX_K_EFF || k < 1 || k > k_eff || d < 8 ||
      d % 8 != 0 || d > MAX_CPL * 32 * 8 || n_rows < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ids_64) {
    return launch_width<long long>(corpus, ids, queries, out_d, out_i, q,
                                   k_eff, k, d, n_rows, normalize, s);
  }
  return launch_width<int>(corpus, ids, queries, out_d, out_i, q, k_eff, k,
                           d, n_rows, normalize, s);
}

}  // extern "C"
