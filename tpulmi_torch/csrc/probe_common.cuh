// The probe kernel shared by probe_topk.cu (full-precision stores) and
// probe_topk_quant.cu (int8 and packed-int4 stores, int8 queries).
//
// One CTA owns one block of QB slots of one bucket and loops over that
// bucket's rows in tiles of NB rows. For each tile it stages the slots'
// query rows (gathered through the slot -> query index) and the tile's store
// rows through shared memory in slices of KC features, computes the QB x NB
// product tile, turns it into distances and inserts the columns that beat a
// row's k-th best into that row's sorted list. The variants differ in three
// places only:
//
//   - how a staged vector of store features is made (`load_store_vec`): a
//     16-byte load of the query's type; int8 codes converted to the query's
//     type; packed int4 nibbles sign-extended and converted;
//   - the product tile (`TileOf`): WMMA with float32 sums for bfloat16 and
//     float16, float32 FMAs on the CUDA cores for float32, WMMA with int32
//     sums for int8 x int8;
//   - the distance of a column: 1 - s for a full-precision store,
//     1 - s * scales[row] / q_levels for a quantized one.
//
// The list insert and its tie rule (strict <, entries <= stay ahead, so
// equal distances keep the lower store row) are the same for all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace probe {

using namespace nvcuda;

constexpr int QB = 64;          // slots per CTA (the wrapper aligns to this)
constexpr int NB = 64;          // store rows per tile
constexpr int ROW_BYTES = 256;  // bytes of one staged row slice
constexpr int LDS_BYTES = ROW_BYTES + 16;  // padded row stride of the slices
constexpr int LDT = NB + 4;     // row stride of the product tile, in words
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float SENTINEL = 10000.0f;

// How the store's rows lie in device memory.
constexpr int SRC_SAME = 0;  // vectors of the query's type
constexpr int SRC_INT8 = 8;  // int8 codes, d bytes a row
constexpr int SRC_INT4 = 4;  // packed int4 codes, d/2 bytes a row: byte j
                             // holds dim j (low nibble) and dim j + d/2

__host__ __device__ constexpr size_t smem_bytes(int kpl) {
  return size_t(QB + NB) * LDS_BYTES + size_t(QB) * LDT * 4 +
         size_t(QB) * 32 * kpl * 8 + size_t(QB) * 8 + size_t(NB) * 4;
}

// Shared-memory layout of a staged row slice of element type T: vectors of
// EPV features, one every CELL bytes. The int8 cells are 32 bytes wide (16
// used) so that every WMMA fragment pointer is 32-byte aligned.
template <typename T>
struct Stage {
  static constexpr int EPV = 16 / sizeof(T);
  static constexpr int CELL = 16;
};
template <>
struct Stage<signed char> {
  static constexpr int EPV = 16;
  static constexpr int CELL = 32;
};

// The QB x NB product tile of the staged slices.
// bf16 / fp16: tensor cores, WMMA 16x16x16 with float32 sums, 8 warps in a
// 4 x 2 grid.
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
  static __device__ __forceinline__ float value(const float *trow, int c) {
    return trow[c];
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
  static __device__ __forceinline__ float value(const float *trow, int c) {
    return trow[c];
  }
};

// int8 x int8: tensor cores, WMMA 16x16x16 with int32 sums, the same 4 x 2
// warp grid. The tile holds the int32 sums; `value` casts one to float32.
// Feature kk of a staged row lies at byte 2 kk (16 features per 32-byte
// cell, see Stage<signed char>).
struct IMmaTile {
  static constexpr int LDS = LDS_BYTES;
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2];

  __device__ void zero() {
    wmma::fill_fragment(acc[0], 0);
    wmma::fill_fragment(acc[1], 0);
  }
  __device__ void add(const signed char *qs, const signed char *xs, int kw) {
    const int warp = threadIdx.x >> 5, wr = warp >> 1, wc = warp & 1;
    for (int kk = 0; kk < kw; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
      wmma::load_matrix_sync(a, qs + wr * 16 * LDS + 2 * kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b;
        wmma::load_matrix_sync(b, xs + (wc * 32 + j * 16) * LDS + 2 * kk, LDS);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
  __device__ void store(float *tile) {
    const int warp = threadIdx.x >> 5, wr = warp >> 1, wc = warp & 1;
    int *itile = reinterpret_cast<int *>(tile);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(itile + wr * 16 * LDT + wc * 32 + j * 16, acc[j],
                              LDT, wmma::mem_row_major);
  }
  static __device__ __forceinline__ float value(const float *trow, int c) {
    return float(reinterpret_cast<const int *>(trow)[c]);
  }
};

template <typename T> struct TileOf { using type = MmaTile<T>; };
template <> struct TileOf<float> { using type = FmaTile; };
template <> struct TileOf<signed char> { using type = IMmaTile; };

// An integer code in the staged type T, as the bits that are stored
// (`raw`); every code is exact in each of the types.
template <typename T> struct Code;
template <> struct Code<__nv_bfloat16> {
  using raw = unsigned short;
  static __device__ __forceinline__ raw make(int c) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(float(c)));
  }
};
template <> struct Code<__half> {
  using raw = unsigned short;
  static __device__ __forceinline__ raw make(int c) {
    return __half_as_ushort(__float2half_rn(float(c)));
  }
};
template <> struct Code<float> {
  using raw = float;
  static __device__ __forceinline__ raw make(int c) { return float(c); }
};
template <> struct Code<signed char> {
  using raw = signed char;
  static __device__ __forceinline__ raw make(int c) {
    return static_cast<signed char>(c);
  }
};

template <int N> struct RawBytes;
template <> struct RawBytes<4> { using type = uint32_t; };
template <> struct RawBytes<8> { using type = uint2; };
template <> struct RawBytes<16> { using type = uint4; };

// The staged 16-byte vector of features [f0, f0 + EPV) of store row `row`.
template <typename T, int SRC>
__device__ __forceinline__ uint4 load_store_vec(const void *data, size_t row,
                                                int d, int f0) {
  constexpr int EPV = Stage<T>::EPV;
  if constexpr (SRC == SRC_SAME) {
    return *reinterpret_cast<const uint4 *>(static_cast<const T *>(data) +
                                            row * d + f0);
  } else {
    // EPV code bytes, one aligned load. Packed int4: EPV divides d/2, so
    // the EPV features lie in one nibble of EPV neighbouring bytes.
    const int half = d >> 1;
    const bool high = SRC == SRC_INT4 && f0 >= half;
    const size_t byte0 = SRC == SRC_INT4
                             ? row * size_t(half) + (high ? f0 - half : f0)
                             : row * size_t(d) + f0;
    union {
      typename RawBytes<EPV>::type raw;
      signed char b[EPV];
    } in;
    in.raw = *reinterpret_cast<const typename RawBytes<EPV>::type *>(
        static_cast<const signed char *>(data) + byte0);
    union {
      uint4 raw;
      typename Code<T>::raw e[EPV];
    } out;
#pragma unroll
    for (int i = 0; i < EPV; ++i) {
      int c = in.b[i];
      if (SRC == SRC_INT4)
        c = high ? (c >> 4) : (int(uint32_t(c) << 28) >> 28);
      out.e[i] = Code<T>::make(c);
    }
    return out.raw;
  }
}

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

// T: type of the queries and of the staged slices. SRC: how the store's
// rows lie in memory. scales / levels are read only when SRC != SRC_SAME.
template <typename T, int SRC, int KPL>
__global__ void __launch_bounds__(THREADS)
probe_kernel(const T *__restrict__ q,              // (Q, d)
             const int *__restrict__ qidx,         // (blocks*QB,)
             const void *__restrict__ data,        // (n_rows, d) of SRC
             const float *__restrict__ scales,     // (n_rows,) or null
             const int *__restrict__ blocks,       // (blocks, 3)
             float *__restrict__ out_d,            // (blocks*QB, k)
             int *__restrict__ out_i,              // (blocks*QB, k)
             int d, long long n_rows, int k, float levels) {
  using Tile = typename TileOf<T>::type;
  constexpr int KW = 32 * KPL;                  // list entries per slot
  constexpr int EPV = Stage<T>::EPV;            // features per staged vector
  constexpr int CELL = Stage<T>::CELL;          // bytes between staged vectors
  constexpr int VPR = ROW_BYTES / CELL;         // staged vectors per row
  constexpr int KC = VPR * EPV;                 // features per staged slice
  constexpr bool SCALED = SRC != SRC_SAME;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char *qs = smem;
  unsigned char *xs = qs + QB * LDS_BYTES;
  float *tile = reinterpret_cast<float *>(xs + NB * LDS_BYTES);
  float *list_d = tile + QB * LDT;
  int *list_i = reinterpret_cast<int *>(list_d + QB * KW);
  float *thr = reinterpret_cast<float *>(list_i + QB * KW);
  int *qrow = reinterpret_cast<int *>(thr + QB);
  float *sc = reinterpret_cast<float *>(qrow + QB);   // (NB,) column scales

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
    if (SCALED) {
      // read after the barrier that follows the product, written before
      // the barriers inside it
      for (int c = tid; c < NB; c += THREADS)
        sc[c] = (c < ncol && row0 + c < n_rows)
                    ? __fdiv_rn(scales[row0 + c], levels) : 0.0f;
    }
    Tile acc;
    acc.zero();
    for (int kc = 0; kc < d; kc += KC) {
      const int kw = min(KC, d - kc);
      for (int v = tid; v < QB * VPR; v += THREADS) {
        const int r = v / VPR, vi = v % VPR, c = vi * EPV;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (r < nq && c < kw)
          val = *reinterpret_cast<const uint4 *>(q + size_t(qrow[r]) * d + kc + c);
        *reinterpret_cast<uint4 *>(qs + r * LDS_BYTES + vi * CELL) = val;
      }
      for (int v = tid; v < NB * VPR; v += THREADS) {
        const int r = v / VPR, vi = v % VPR, c = vi * EPV;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (r < ncol && c < kw && row0 + r < n_rows)
          val = load_store_vec<T, SRC>(data, size_t(row0 + r), d, kc + c);
        *reinterpret_cast<uint4 *>(xs + r * LDS_BYTES + vi * CELL) = val;
      }
      __syncthreads();
      acc.add(reinterpret_cast<const T *>(qs), reinterpret_cast<const T *>(xs),
              kw);
      __syncthreads();
    }
    acc.store(tile);
    __syncthreads();

    const float inf = __int_as_float(0x7f800000);
    for (int r = warp; r < nq; r += WARPS) {
      const float *trow = tile + r * LDT;
      float v0 = inf, v1 = inf;
      if (lane < ncol) {
        const float s = Tile::value(trow, lane);
        v0 = SCALED ? __fsub_rn(1.0f, __fmul_rn(s, sc[lane])) : 1.0f - s;
      }
      if (lane + 32 < ncol) {
        const float s = Tile::value(trow, lane + 32);
        v1 = SCALED ? __fsub_rn(1.0f, __fmul_rn(s, sc[lane + 32])) : 1.0f - s;
      }
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

template <typename T, int SRC, int KPL>
int launch(const void *q, const void *qidx, const void *data,
           const void *scales, const void *blocks, void *out_d, void *out_i,
           int n_blocks, int d, long long n_rows, int k, float levels,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(KPL);
  cudaError_t err = cudaFuncSetAttribute(
      probe_kernel<T, SRC, KPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  probe_kernel<T, SRC, KPL><<<n_blocks, THREADS, smem, stream>>>(
      static_cast<const T *>(q), static_cast<const int *>(qidx), data,
      static_cast<const float *>(scales), static_cast<const int *>(blocks),
      static_cast<float *>(out_d), static_cast<int *>(out_i), d, n_rows, k,
      levels);
  return int(cudaGetLastError());
}

// The list holds 32 KPL entries a slot; the smallest that holds k is used.
template <typename T, int SRC>
int launch_k(const void *q, const void *qidx, const void *data,
             const void *scales, const void *blocks, void *out_d, void *out_i,
             int n_blocks, int d, long long n_rows, int k, float levels,
             cudaStream_t s) {
  if (k <= 32)
    return launch<T, SRC, 1>(q, qidx, data, scales, blocks, out_d, out_i,
                             n_blocks, d, n_rows, k, levels, s);
  if (k <= 64)
    return launch<T, SRC, 2>(q, qidx, data, scales, blocks, out_d, out_i,
                             n_blocks, d, n_rows, k, levels, s);
  return launch<T, SRC, 4>(q, qidx, data, scales, blocks, out_d, out_i,
                           n_blocks, d, n_rows, k, levels, s);
}

}  // namespace probe
