// Fused cosine-distance + running top-k probe kernel for Hopper (sm_90a).
//
// Replaces tpulmi/ops/pallas_topk.py::_kernel_core, the TPU probe kernel on
// its dense grid, in all three of its extract modes ("scalar", "group",
// "group2"): they compute one function, so one kernel serves them all.
//
// What it computes. The wrapper (tpulmi_torch/ops/probe_topk.py) groups every
// (query, probe) slot by its probed bucket into blocks of QB slots, so each
// block belongs to one bucket. For each live slot of a block, the kernel
// returns the k smallest  1 - q . x  over the rows [start, start + count) of
// that bucket, ascending, with the store row of each; where the bucket holds
// fewer than k rows the rest is distance 10000 and row -1. Ties keep the
// lower store row, as a stable sort does.
//
// Design. One CTA owns one block of QB slots and loops over its bucket's
// rows in tiles of NB rows, so a small bucket costs a short loop and an empty
// block exits at once (the TPU's dense grid paid one empty step per missing
// chunk instead). For each tile the CTA stages the slots' query rows
// (gathered through the slot -> query index, so the wrapper never copies
// queries into slot order) and the tile's store rows through shared memory in
// 256-byte row slices, and computes the QB x NB product with float32
// accumulation: bfloat16 and float16 inputs on the tensor cores (WMMA
// 16x16x16, 8 warps in a 4 x 2 grid), float32 inputs on the CUDA cores in
// float32 (the TPU kernel's compute_dtype=float32; tf32 would round the
// inputs). The product goes to shared memory only. Each warp then walks its query
// rows: one ballot per 32 columns finds the candidates that beat the row's
// k-th best, and only those are inserted, one at a time and in column order,
// into the row's sorted list (KPL entries per lane, shifted across lanes with
// a shuffle). After a few tiles almost no column beats the threshold, so the
// top-k costs one compare per distance.
//
// Limits. k <= 128 (as the TPU kernel's 128-lane scratch), d % 8 == 0 (16-byte
// row loads). The TPU kernel's row_align % mc == 0 and d % 128 == 0 were
// tiling needs of the TPU and are dropped: rows are addressed directly and
// the last tile and the last feature slice are masked.
//
// What bounds it. Each probed bucket must be read once (bytes) and
// 2 d slots rows operations done on it; at the 300K x 768 main-path shape in
// bfloat16 the two bounds are of the same order (in float32 the operations,
// at the CUDA cores' rate, bound it). This first version is bound by neither:
// its staged loads are synchronous (no cp.async/TMA pipeline), WMMA issues
// from shared memory far below wgmma's rate, and a bucket is re-read (from
// L2) once per 64-slot block. Latency is hidden only across the 1-3 CTAs an
// SM holds. wgmma with TMA-fed shared-memory rings is the next step.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int QB = 64;          // slots per CTA (the wrapper aligns to this)
constexpr int NB = 64;          // store rows per tile
constexpr int ROW_BYTES = 256;  // bytes of one staged row slice
constexpr int LDS_BYTES = ROW_BYTES + 16;  // padded row stride of the slices
constexpr int VPR = ROW_BYTES / 16;        // 16-byte vectors per staged row
constexpr int LDT = NB + 4;     // float row stride of the product tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float SENTINEL = 10000.0f;

__host__ __device__ constexpr size_t smem_bytes(int kpl) {
  return size_t(QB + NB) * LDS_BYTES + size_t(QB) * LDT * 4 +
         size_t(QB) * 32 * kpl * 8 + size_t(QB) * 8;
}

// The QB x NB product tile of the staged slices, float32 accumulation.
// bf16 / fp16: tensor cores, WMMA 16x16x16, 8 warps in a 4 x 2 grid.
template <typename T>
struct MmaTile {
  static constexpr int LDS = LDS_BYTES / sizeof(T);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];

  __device__ void zero() {
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);
  }
  __device__ void add(const T *qs, const T *xs, int kw) {
    const int warp = threadIdx.x >> 5, wr = warp >> 1, wc = warp & 1;
    for (int kk = 0; kk < kw; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::load_matrix_sync(a, qs + wr * 16 * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // x stored row-major (rows, features) is x^T in column-major
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
        wmma::load_matrix_sync(b, xs + (wc * 32 + j * 16) * LDS + kk, LDS);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
  __device__ void store(float *tile) {
    const int warp = threadIdx.x >> 5, wr = warp >> 1, wc = warp & 1;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(tile + wr * 16 * LDT + wc * 32 + j * 16, acc[j],
                              LDT, wmma::mem_row_major);
  }
};

// float32: CUDA cores, float32 products. Thread (ty, tx) of a 16 x 16 grid
// owns rows 4 ty .. 4 ty + 3 and columns tx + 16 j, j < 4.
struct FmaTile {
  static constexpr int LDS = LDS_BYTES / sizeof(float);
  float acc[4][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  __device__ void add(const float *qs, const float *xs, int kw) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    for (int kk = 0; kk < kw; kk += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4 *>(qs + (ty * 4 + i) * LDS + kk);
        b[i] = *reinterpret_cast<const float4 *>(xs + (tx + 16 * i) * LDS + kk);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] += a[i].x * b[j].x + a[i].y * b[j].y + a[i].z * b[j].z +
                       a[i].w * b[j].w;
    }
  }
  __device__ void store(float *tile) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        tile[(ty * 4 + i) * LDT + tx + 16 * j] = acc[i][j];
  }
};

template <typename T> struct TileOf { using type = MmaTile<T>; };
template <> struct TileOf<float> { using type = FmaTile; };

// Insert the candidates of `mask` (lanes holding distance v, store row
// base + lane) into the warp's sorted list, in lane order; th is the list's
// k-th best and is kept up to date.
template <int KPL>
__device__ __forceinline__ void insert_candidates(unsigned mask, float v,
                                                  int base, float (&L)[KPL],
                                                  int (&I)[KPL], float &th,
                                                  int k) {
  const int lane = threadIdx.x & 31;
  const int kl = (k - 1) / KPL, ks = (k - 1) % KPL;
  while (mask) {
    const int j = __ffs(mask) - 1;
    const float cv = __shfl_sync(FULL, v, j);
    const int cid = base + j;
    // entries <= cv stay ahead of it: equal distances keep the earlier row
    int pos = 0;
#pragma unroll
    for (int s = 0; s < KPL; ++s) pos += __popc(__ballot_sync(FULL, L[s] <= cv));
    const float prev_l = __shfl_up_sync(FULL, L[KPL - 1], 1);
    const int prev_i = __shfl_up_sync(FULL, I[KPL - 1], 1);
#pragma unroll
    for (int s = KPL - 1; s >= 0; --s) {
      const int p = lane * KPL + s;
      if (p > pos) {
        L[s] = s > 0 ? L[s > 0 ? s - 1 : 0] : prev_l;
        I[s] = s > 0 ? I[s > 0 ? s - 1 : 0] : prev_i;
      } else if (p == pos) {
        L[s] = cv;
        I[s] = cid;
      }
    }
    float mine = L[0];
#pragma unroll
    for (int s = 1; s < KPL; ++s)
      if (s == ks) mine = L[s];
    th = __shfl_sync(FULL, mine, kl);
    const unsigned later = j == 31 ? 0u : (FULL << (j + 1));
    mask = __ballot_sync(FULL, v < th) & later;
  }
}

template <typename T, int KPL>
__global__ void __launch_bounds__(THREADS)
probe_topk_kernel(const T *__restrict__ q,              // (Q, d)
                  const int *__restrict__ qidx,         // (blocks*QB,)
                  const T *__restrict__ data,           // (n_rows, d)
                  const int *__restrict__ blocks,       // (blocks, 3)
                  float *__restrict__ out_d,            // (blocks*QB, k)
                  int *__restrict__ out_i,              // (blocks*QB, k)
                  int d, long long n_rows, int k) {
  using Tile = typename TileOf<T>::type;
  constexpr int KW = 32 * KPL;                  // list entries per slot
  constexpr int LDS = LDS_BYTES / sizeof(T);
  constexpr int KC = ROW_BYTES / sizeof(T);     // features per staged slice
  constexpr int EPV = 16 / sizeof(T);           // features per 16-byte vector
  extern __shared__ __align__(128) unsigned char smem[];
  T *qs = reinterpret_cast<T *>(smem);
  T *xs = qs + QB * LDS;
  float *tile = reinterpret_cast<float *>(xs + NB * LDS);
  float *list_d = tile + QB * LDT;
  int *list_i = reinterpret_cast<int *>(list_d + QB * KW);
  float *thr = reinterpret_cast<float *>(list_i + QB * KW);
  int *qrow = reinterpret_cast<int *>(thr + QB);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t blk = blockIdx.x;
  const long long dstart = blocks[blk * 3 + 0];
  const int dcnt = blocks[blk * 3 + 1];
  const int nq = max(0, min(blocks[blk * 3 + 2], QB));

  for (int i = tid; i < QB * KW; i += THREADS) {
    list_d[i] = SENTINEL;
    list_i[i] = -1;
  }
  for (int i = tid; i < QB; i += THREADS) {
    thr[i] = SENTINEL;
    qrow[i] = qidx[blk * QB + i];
  }
  __syncthreads();

  for (int t0 = 0; nq > 0 && t0 < dcnt; t0 += NB) {
    const long long row0 = dstart + t0;
    const int ncol = min(NB, dcnt - t0);
    Tile acc;
    acc.zero();
    for (int kc = 0; kc < d; kc += KC) {
      const int kw = min(KC, d - kc);
      for (int v = tid; v < QB * VPR; v += THREADS) {
        const int r = v / VPR, c = (v % VPR) * EPV;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (r < nq && c < kw)
          val = *reinterpret_cast<const uint4 *>(q + size_t(qrow[r]) * d + kc + c);
        *reinterpret_cast<uint4 *>(qs + r * LDS + c) = val;
      }
      for (int v = tid; v < NB * VPR; v += THREADS) {
        const int r = v / VPR, c = (v % VPR) * EPV;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (r < ncol && c < kw && row0 + r < n_rows)
          val = *reinterpret_cast<const uint4 *>(data + size_t(row0 + r) * d + kc + c);
        *reinterpret_cast<uint4 *>(xs + r * LDS + c) = val;
      }
      __syncthreads();
      acc.add(qs, xs, kw);
      __syncthreads();
    }
    acc.store(tile);
    __syncthreads();

    const float inf = __int_as_float(0x7f800000);
    for (int r = warp; r < nq; r += WARPS) {
      const float *trow = tile + r * LDT;
      const float v0 = lane < ncol ? 1.0f - trow[lane] : inf;
      const float v1 = lane + 32 < ncol ? 1.0f - trow[lane + 32] : inf;
      float th = thr[r];
      const unsigned m0 = __ballot_sync(FULL, v0 < th);
      const unsigned m1 = __ballot_sync(FULL, v1 < th);
      if ((m0 | m1) == 0) continue;
      float L[KPL];
      int I[KPL];
#pragma unroll
      for (int s = 0; s < KPL; ++s) {
        L[s] = list_d[r * KW + lane * KPL + s];
        I[s] = list_i[r * KW + lane * KPL + s];
      }
      insert_candidates<KPL>(m0, v0, int(row0), L, I, th, k);
      insert_candidates<KPL>(__ballot_sync(FULL, v1 < th), v1, int(row0) + 32,
                             L, I, th, k);
#pragma unroll
      for (int s = 0; s < KPL; ++s) {
        list_d[r * KW + lane * KPL + s] = L[s];
        list_i[r * KW + lane * KPL + s] = I[s];
      }
      if (lane == 0) thr[r] = th;
    }
    __syncthreads();
  }

  for (int i = tid; i < QB * k; i += THREADS) {
    const int r = i / k, p = i % k;
    out_d[blk * QB * k + i] = list_d[r * KW + p];
    out_i[blk * QB * k + i] = list_i[r * KW + p];
  }
}

template <typename T, int KPL>
int launch(const void *q, const void *qidx, const void *data,
           const void *blocks, void *out_d, void *out_i, int n_blocks, int d,
           long long n_rows, int k, cudaStream_t stream) {
  const size_t smem = smem_bytes(KPL);
  cudaError_t err = cudaFuncSetAttribute(
      probe_topk_kernel<T, KPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  probe_topk_kernel<T, KPL><<<n_blocks, THREADS, smem, stream>>>(
      static_cast<const T *>(q), static_cast<const int *>(qidx),
      static_cast<const T *>(data), static_cast<const int *>(blocks),
      static_cast<float *>(out_d), static_cast<int *>(out_i), d, n_rows, k);
  return int(cudaGetLastError());
}

template <typename T>
int launch_k(const void *q, const void *qidx, const void *data,
             const void *blocks, void *out_d, void *out_i, int n_blocks,
             int d, long long n_rows, int k, cudaStream_t s) {
  if (k <= 32) return launch<T, 1>(q, qidx, data, blocks, out_d, out_i, n_blocks, d, n_rows, k, s);
  if (k <= 64) return launch<T, 2>(q, qidx, data, blocks, out_d, out_i, n_blocks, d, n_rows, k, s);
  return launch<T, 4>(q, qidx, data, blocks, out_d, out_i, n_blocks, d, n_rows, k, s);
}

}  // namespace

extern "C" {

// Slots per block: the wrapper lays slots out in blocks of this size.
int probe_topk_block_slots() { return QB; }

// Launch on `stream`; `dtype` is the type of q and data: 0 bfloat16,
// 1 float16, 2 float32. Returns the CUDA error code of the launch (0 = ok).
int probe_topk_launch(const void *q, const void *qidx, const void *data,
                      const void *blocks, void *out_d, void *out_i,
                      int n_blocks, int d, long long n_rows, int k, int dtype,
                      void *stream) {
  if (n_blocks <= 0) return 0;
  if (k < 1 || k > 128 || d < 8 || d % 8 != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_k<__nv_bfloat16>(q, qidx, data, blocks, out_d, out_i, n_blocks, d, n_rows, k, s);
    case 1: return launch_k<__half>(q, qidx, data, blocks, out_d, out_i, n_blocks, d, n_rows, k, s);
    case 2: return launch_k<float>(q, qidx, data, blocks, out_d, out_i, n_blocks, d, n_rows, k, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
