// The probe kernel shared by probe_topk.cu (full-precision stores) and
// probe_topk_quant.cu (int8 and packed-int4 stores, int8 queries).
//
// One CTA owns one block of QB slots of one bucket and loops over that
// bucket's rows in tiles of NB rows. For each tile the staged loop stages
// the slots' query rows (gathered through the slot -> query index) and the
// tile's store rows through shared memory in slices of KC features
// (probe_wgmma.cuh says how the wgmma loop feeds them), computes the QB x NB
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
//
// Three further configurations of the same kernel, each chosen at the launch
// (they replace the `pair`, `pool` and flat-worklist configurations of
// tpulmi/ops/pallas_topk.py::_kernel_core / _kernel_flat):
//
//   - the tile height NB (template parameter): 64 store rows a tile, or 128
//     (the "paired" tile: half as many passes over the staged query rows and
//     half as many barriers for every store row). The result does not depend
//     on it: a product element is summed over the features in one order
//     whatever the tile, and candidates are inserted in row order;
//   - the worklist (`items` not null): a work item is a (block, chunk)
//     pair, rows [chunk * span, (chunk + 1) * span) of its block's bucket.
//     Here a CTA is one item: it writes each slot's sorted partial list to
//     the item's scratch rows and marks the item in `written`. The wgmma
//     loop runs it on a persistent grid instead (probe_wgmma.cuh): a CTA
//     walks a range of items, carrying a block's lists across the block's
//     consecutive items, and writes them once per such piece.
//     merge_items.cu merges a block's written pieces in chunk order. A long
//     bucket becomes many items instead of one long CTA;
//   - the rerank pool (k_out > k): beside the exact k-list, every slot keeps
//     for each of the POOL residue classes (row - bucket start) mod POOL the
//     best row it has seen, as one 64-bit key (distance, row) that orders
//     like the pair: one compare and one store per column, no serial insert.
//     Rows [k, k_out) of the output are the k_out - k smallest keys whose row
//     is not in the exact top-k, ascending. With a worklist the CTA's pool is
//     folded into the block's pool in global memory with a 64-bit atomicMin:
//     the minimum does not depend on the order of the items, so the result is
//     the same on every run, and no per-item pool has to be written and read
//     again.
//
// What bounds them. The 128-row tile and the pool change no byte or
// operation that must be done: K1's bound (each probed bucket read once,
// 2 d slots rows operations). The worklist adds the pieces' partial lists,
// written once and read once by the merge kernel (pieces * 64 * k * 8
// bytes).
//
// Two main loops. `probe_kernel` below is the staged loop: plain loads into
// shared memory, a barrier, WMMA or FMA from shared memory, a barrier, the
// whole product tile through shared memory. It serves float32 queries
// (FmaTile) and the shapes that the other loop's plan does not fit, and
// stays the reference of the other loop for every query type (IMmaTile for
// int8 queries). For bfloat16, float16 and int8 queries probe_wgmma.cuh
// holds the loop built for this card (queries resident in shared memory,
// the store through a TMA ring, wgmma, the threshold test in registers, the
// pool behind a gate), which takes away the staged loop's exposed latency,
// its re-staging of the queries and its round trip of the tile; `loop_of`
// below is the rule that chooses, and every configuration here (tile
// height, worklist, pool) runs in either. In both a bucket is read once
// per 64-slot block, from L2 (the 128-row tile's wgmma launch: once per
// group of CTAs of a thread-block cluster). Beside 96 KB of resident bfloat16
// queries (d = 768) the pool's 64 KB leave the wgmma loop rings of 3 to 5
// stages with the 64-row tile and none with the 128-row tile over int4
// codes, which there keeps the staged loop; int8 queries take half the
// bytes (48 KB), and every pool plan at d = 768 fits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace probe {

using namespace nvcuda;

constexpr int QB = 64;          // slots per CTA (the wrapper aligns to this)
constexpr int POOL = 128;       // residue classes of the rerank pool
constexpr int ROW_BYTES = 256;  // bytes of one staged row slice
constexpr int LDS_BYTES = ROW_BYTES + 16;  // padded row stride of the slices
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float SENTINEL = 10000.0f;

// How the store's rows lie in device memory.
constexpr int SRC_SAME = 0;  // vectors of the query's type
constexpr int SRC_INT8 = 8;  // int8 codes, d bytes a row
constexpr int SRC_INT4 = 4;  // packed int4 codes, d/2 bytes a row: byte j
                             // holds dim j (low nibble) and dim j + d/2

using PoolKey = unsigned long long;
constexpr PoolKey EMPTY_KEY = ~PoolKey(0);

// Shared memory of one CTA: the staged slices of QB query and nb store rows,
// the product tile (row stride nb + 4 words), the lists of 32 kpl entries a
// slot, thresholds and query rows, nb column scales, and the pool's keys.
__host__ __device__ constexpr size_t smem_bytes(int kpl, int nb, bool pool) {
  return size_t(QB + nb) * LDS_BYTES + size_t(QB) * (nb + 4) * 4 +
         size_t(QB) * 32 * kpl * 8 + size_t(QB) * 8 + size_t(nb) * 4 +
         (pool ? size_t(QB) * POOL * sizeof(PoolKey) : 0);
}

// (distance, row) as one key: keys compare as the pairs do, distance first
// (any sign), then the lower row.
__device__ __forceinline__ PoolKey make_key(float dist, int row) {
  unsigned u = __float_as_uint(dist);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (PoolKey(u) << 32) | unsigned(row);
}
__device__ __forceinline__ float key_dist(PoolKey key) {
  unsigned u = unsigned(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
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
// 4 x 2 grid; a warp owns 16 rows and NB / 2 columns.
template <typename T, int NB>
struct MmaTile {
  static constexpr int LDS = LDS_BYTES / sizeof(T);
  static constexpr int LDT = NB + 4;
  static constexpr int NF = NB / 32;   // 16-column fragments per warp
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];

  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.0f);
  }
  __device__ void add(const T *qs, const T *xs, int kw) {
    const int warp = threadIdx.x >> 5, wr = warp >> 1, wc = warp & 1;
    for (int kk = 0; kk < kw; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::load_matrix_sync(a, qs + wr * 16 * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        // x stored row-major (rows, features) is x^T in column-major
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
        wmma::load_matrix_sync(b, xs + (wc * (NB / 2) + j * 16) * LDS + kk,
                               LDS);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
  __device__ void store(float *tile) {
    const int warp = threadIdx.x >> 5, wr = warp >> 1, wc = warp & 1;
#pragma unroll
    for (int j = 0; j < NF; ++j)
      wmma::store_matrix_sync(
          tile + wr * 16 * LDT + wc * (NB / 2) + j * 16, acc[j], LDT,
          wmma::mem_row_major);
  }
  static __device__ __forceinline__ float value(const float *trow, int c) {
    return trow[c];
  }
};

// float32: CUDA cores, float32 products. Thread (ty, tx) of a 16 x 16 grid
// owns rows 4 ty .. 4 ty + 3 and columns tx + 16 j, j < NB / 16.
template <int NB>
struct FmaTile {
  static constexpr int LDS = LDS_BYTES / sizeof(float);
  static constexpr int LDT = NB + 4;
  static constexpr int NC = NB / 16;   // columns per thread
  float acc[4][NC];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;
  }
  __device__ void add(const float *qs, const float *xs, int kw) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    for (int kk = 0; kk < kw; kk += 4) {
      float4 a[4], b[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4 *>(qs + (ty * 4 + i) * LDS + kk);
#pragma unroll
      for (int j = 0; j < NC; ++j)
        b[j] = *reinterpret_cast<const float4 *>(xs + (tx + 16 * j) * LDS + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j)
          acc[i][j] += a[i].x * b[j].x + a[i].y * b[j].y + a[i].z * b[j].z +
                       a[i].w * b[j].w;
    }
  }
  __device__ void store(float *tile) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j)
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
template <int NB>
struct IMmaTile {
  static constexpr int LDS = LDS_BYTES;
  static constexpr int LDT = NB + 4;
  static constexpr int NF = NB / 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[NF];

  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0);
  }
  __device__ void add(const signed char *qs, const signed char *xs, int kw) {
    const int warp = threadIdx.x >> 5, wr = warp >> 1, wc = warp & 1;
    for (int kk = 0; kk < kw; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
      wmma::load_matrix_sync(a, qs + wr * 16 * LDS + 2 * kk, LDS);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b;
        wmma::load_matrix_sync(
            b, xs + (wc * (NB / 2) + j * 16) * LDS + 2 * kk, LDS);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
  __device__ void store(float *tile) {
    const int warp = threadIdx.x >> 5, wr = warp >> 1, wc = warp & 1;
    int *itile = reinterpret_cast<int *>(tile);
#pragma unroll
    for (int j = 0; j < NF; ++j)
      wmma::store_matrix_sync(
          itile + wr * 16 * LDT + wc * (NB / 2) + j * 16, acc[j], LDT,
          wmma::mem_row_major);
  }
  static __device__ __forceinline__ float value(const float *trow, int c) {
    return float(reinterpret_cast<const int *>(trow)[c]);
  }
};

template <typename T, int NB> struct TileOf { using type = MmaTile<T, NB>; };
template <int NB> struct TileOf<float, NB> { using type = FmaTile<NB>; };
template <int NB> struct TileOf<signed char, NB> {
  using type = IMmaTile<NB>;
};

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

// Insert the candidates of `mask` (lanes holding distance v and store row
// vid) into the warp's sorted list, in lane order; th is the list's k-th
// best and is kept up to date.
template <int KPL>
__device__ __forceinline__ void insert_candidates(unsigned mask, float v,
                                                  int vid, float (&L)[KPL],
                                                  int (&I)[KPL], float &th,
                                                  int k) {
  const int lane = threadIdx.x & 31;
  const int kl = (k - 1) / KPL, ks = (k - 1) % KPL;
  while (mask) {
    const int j = __ffs(mask) - 1;
    const float cv = __shfl_sync(FULL, v, j);
    const int cid = __shfl_sync(FULL, vid, j);
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

// Rows [k, k_out) of one slot, written by its warp: the k_out - k smallest
// keys of the slot's POOL pool keys whose row is not among the slot's exact
// top-k (`topk`, k store rows `stride` words apart, ascending by distance,
// -1 past the last),
// ascending; (10000, -1) where fewer are left. Lane l holds classes l + 32 g.
__device__ __forceinline__ void write_extras(const PoolKey *pool,
                                             const int *topk, int k, int k_out,
                                             float *od, int *oi,
                                             int stride = 1) {
  constexpr int G = POOL / 32;
  const int lane = threadIdx.x & 31;
  PoolKey key[G];
#pragma unroll
  for (int g = 0; g < G; ++g) key[g] = pool[lane + 32 * g];
  for (int t = 0; t < k; ++t) {
    const int id = topk[t * stride];
    if (id < 0) break;
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (key[g] != EMPTY_KEY && int(unsigned(key[g])) == id)
        key[g] = EMPTY_KEY;
  }
  for (int e = k; e < k_out; ++e) {
    PoolKey m = key[0];
#pragma unroll
    for (int g = 1; g < G; ++g) m = key[g] < m ? key[g] : m;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const PoolKey o = __shfl_xor_sync(FULL, m, off);
      m = o < m ? o : m;
    }
    if (lane == 0) {
      od[e] = m == EMPTY_KEY ? SENTINEL : key_dist(m);
      oi[e] = m == EMPTY_KEY ? -1 : int(unsigned(m));
    }
    // rows are distinct, so at most one key equals m
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (key[g] == m) key[g] = EMPTY_KEY;
  }
}

// The kernels' arguments. At most 128 bytes: past that (and past 256 with
// the wgmma loop's 128-byte tensor map beside it) the kernels ran 3-9%
// slower on an H100 for the same work (PERF.md, "The kernels' arguments"),
// so what only the launch needs (the worklist grid's size) is passed
// beside it, and the worklist's total is read from `block_items`.
struct ProbeArgs {
  const void *q;           // (Q, d) of T
  const int *qidx;         // (blocks*QB,) query of each slot row
  const void *data;        // (n_rows, d) of SRC
  const float *scales;     // (n_rows,) or null
  const int *blocks;       // (n_blocks, 3): first store row, rows, live
                           // slots
  const int *items;        // (n_items, 2): block (-1: none) and chunk of
                           // each work item, or null: CTA b is block b
  const int *block_items;  // (n_blocks, 2): first item and item count, with
                           // items
  signed char *written;    // (n_items,): 1 where an item starts a written
                           // piece, with items
  float *out_d;            // (blocks*QB, k_out); with items (n_items*QB, k)
  int *out_i;
  PoolKey *pool;             // (blocks*QB, POOL) keys, with items and a pool
  long long n_rows;
  int d;
  int k, k_out;            // k_out > k: keep the pool
  int span;                // store rows of one work item
  int n_items;             // items the scratch holds, with items
  int n_blocks;            // rows of `blocks`
  float levels;
};
static_assert(sizeof(ProbeArgs) <= 128, "the kernels' arguments grew");

// T: type of the queries and of the staged slices. SRC: how the store's
// rows lie in memory. scales / levels are read only when SRC != SRC_SAME.
template <typename T, int SRC, int KPL, int NB>
__global__ void __launch_bounds__(THREADS) probe_kernel(const ProbeArgs a) {
  using Tile = typename TileOf<T, NB>::type;
  constexpr int KW = 32 * KPL;                  // list entries per slot
  constexpr int NG = NB / 32;                   // columns per lane and tile
  constexpr int LDT = Tile::LDT;
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
  PoolKey *pool_s = reinterpret_cast<PoolKey *>(sc + NB);  // (QB, POOL) keys

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T *q = static_cast<const T *>(a.q);
  const int d = a.d, k = a.k;
  const long long n_rows = a.n_rows;
  const bool flat = a.items != nullptr;
  const bool pooled = a.k_out > k;
  long long blk = blockIdx.x;
  int chunk = 0;
  if (flat) {
    blk = a.items[2 * blockIdx.x];
    chunk = a.items[2 * blockIdx.x + 1];
    if (blk < 0) return;   // padding past the worklist's end
    if (threadIdx.x == 0) a.written[blockIdx.x] = 1;   // a piece of one item
  }
  const long long dstart = a.blocks[blk * 3 + 0];
  const int dcnt = a.blocks[blk * 3 + 1];
  const int nq = max(0, min(a.blocks[blk * 3 + 2], QB));
  // the rows of the bucket that this CTA scans
  const int t_lo = flat ? chunk * a.span : 0;
  const int t_hi = flat ? min(dcnt, t_lo + a.span) : dcnt;

  for (int i = tid; i < QB * KW; i += THREADS) {
    list_d[i] = SENTINEL;
    list_i[i] = -1;
  }
  for (int i = tid; i < QB; i += THREADS) {
    thr[i] = SENTINEL;
    qrow[i] = a.qidx[blk * QB + i];
  }
  if (pooled)
    for (int i = tid; i < QB * POOL; i += THREADS) pool_s[i] = EMPTY_KEY;
  __syncthreads();

  for (int t0 = t_lo; nq > 0 && t0 < t_hi; t0 += NB) {
    const long long row0 = dstart + t0;
    const int ncol = min(NB, t_hi - t0);
    if (SCALED) {
      // read after the barrier that follows the product, written before
      // the barriers inside it
      for (int c = tid; c < NB; c += THREADS)
        sc[c] = (c < ncol && row0 + c < n_rows)
                    ? __fdiv_rn(a.scales[row0 + c], a.levels) : 0.0f;
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
          val = load_store_vec<T, SRC>(a.data, size_t(row0 + r), d, kc + c);
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
      float v[NG];
      float th = thr[r];
      unsigned any = 0;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int c = lane + 32 * g;
        v[g] = inf;
        if (c < ncol) {
          const float s = Tile::value(trow, c);
          v[g] = SCALED ? __fsub_rn(1.0f, __fmul_rn(s, sc[c])) : 1.0f - s;
          if (pooled) {
            // rows come in ascending order and only a smaller key is
            // stored, so equal distances keep the lower row
            const PoolKey key = make_key(v[g], int(row0) + c);
            PoolKey *slot = pool_s + r * POOL + ((t0 + c) & (POOL - 1));
            if (key < *slot) *slot = key;
          }
        }
        any |= __ballot_sync(FULL, v[g] < th);
      }
      if (any == 0) continue;
      float L[KPL];
      int I[KPL];
#pragma unroll
      for (int s = 0; s < KPL; ++s) {
        L[s] = list_d[r * KW + lane * KPL + s];
        I[s] = list_i[r * KW + lane * KPL + s];
      }
#pragma unroll
      for (int g = 0; g < NG; ++g)
        insert_candidates<KPL>(__ballot_sync(FULL, v[g] < th), v[g],
                               int(row0) + lane + 32 * g, L, I, th, k);
#pragma unroll
      for (int s = 0; s < KPL; ++s) {
        list_d[r * KW + lane * KPL + s] = L[s];
        list_i[r * KW + lane * KPL + s] = I[s];
      }
      if (lane == 0) thr[r] = th;
    }
    __syncthreads();
  }

  // with items: the item's partial lists; else the block's final rows
  const size_t orow = size_t(flat ? blockIdx.x : blk) * QB;
  const int ko = flat ? k : a.k_out;
  for (int i = tid; i < QB * k; i += THREADS) {
    const int r = i / k, p = i % k;
    a.out_d[(orow + r) * ko + p] = list_d[r * KW + p];
    a.out_i[(orow + r) * ko + p] = list_i[r * KW + p];
  }
  if (!pooled) return;
  if (flat) {
    PoolKey *pool_g = a.pool + size_t(blk) * QB * POOL;
    for (int i = tid; i < QB * POOL; i += THREADS)
      if (pool_s[i] != EMPTY_KEY) atomicMin(pool_g + i, pool_s[i]);
  } else {
    for (int r = warp; r < QB; r += WARPS)
      write_extras(pool_s + r * POOL, list_i + r * KW, k, a.k_out,
                   a.out_d + (orow + r) * ko, a.out_i + (orow + r) * ko);
  }
}

template <typename T, int SRC, int KPL, int NB>
int launch(const ProbeArgs &a, int n_ctas, cudaStream_t stream) {
  const size_t smem = smem_bytes(KPL, NB, a.k_out > a.k);
  cudaError_t err = cudaFuncSetAttribute(
      probe_kernel<T, SRC, KPL, NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  probe_kernel<T, SRC, KPL, NB><<<n_ctas, THREADS, smem, stream>>>(a);
  return int(cudaGetLastError());
}

// Entries per lane of the list that holds k: 32 KPL >= k.
__host__ __device__ constexpr int kpl_of(int k) {
  return k <= 32 ? 1 : (k <= 64 ? 2 : 4);
}

}  // namespace probe

#include "probe_wgmma.cuh"

namespace probe {

// Which main loop a launch takes, a function of the queries' width in bytes,
// the store's layout, d, k, the pool and the tile height alone (the wrapper,
// tpulmi_torch/ops/probe_topk.py::probe_loop, holds the same rule): the
// wgmma loop for 2-byte queries, and for int8 queries over int8 or
// packed-int4 codes, whenever its shared memory, which grows with d for the
// resident queries, fits the opt-in limit of an H100; else the staged loop
// of probe_kernel, which also serves float32 queries.
constexpr int LOOP_STAGED = 0, LOOP_WGMMA = 1;
inline int loop_of(int query_bytes, int src, int d, int k, bool pool, int nb) {
  const bool takes = query_bytes == 2 || (query_bytes == 1 && src != SRC_SAME);
  return takes && hopper::stages(d, src, query_bytes, k, nb, pool) > 0
             ? LOOP_WGMMA : LOOP_STAGED;
}
inline size_t loop_smem_bytes(int loop, int query_bytes, int src, int d, int k,
                              bool pool, int nb) {
  return loop == LOOP_WGMMA
             ? hopper::smem_bytes(
                   d, src, query_bytes, k, nb, pool,
                   hopper::stages(d, src, query_bytes, k, nb, pool))
             : smem_bytes(kpl_of(k), nb, pool);
}

// The CTAs of a thread-block cluster that a launch takes (1: none), a
// function of its main loop, tile height and worklist alone (the wrapper,
// ops/probe_topk.py::probe_cluster, holds the same rule): clusters of
// hopper::CLUSTER_CTAS for the 128-row tile's one-CTA-per-block launch in
// the wgmma loop, whose CTAs on one bucket then share each store tile
// (probe_wgmma.cuh, "Clusters"); none for the worklist's persistent grid,
// the 64-row tile and the staged loop.
inline int cluster_of(int loop, int nb, bool worklist) {
  return loop == LOOP_WGMMA && nb == 128 && !worklist ? hopper::CLUSTER_CTAS
                                                       : 1;
}

// The list holds 32 KPL entries a slot; the smallest that holds k is used.
// `loop`: LOOP_STAGED or LOOP_WGMMA to ask for that loop (the wgmma loop is
// refused where the rule would not choose it), anything else for the rule.
// `ctas`: the wgmma loop's worklist grid (0: as many as the card holds).
// `cluster`: CTAs of a cluster, 0 for cluster_of's; above 1 only the wgmma
// loop without a worklist takes one (else the launch is refused).
template <typename T, int SRC, int NB>
int launch_k(const ProbeArgs &a, int n_ctas, int ctas, int loop, int cluster,
             cudaStream_t s) {
  const int rule = loop_of(sizeof(T), SRC, a.d, a.k, a.k_out > a.k, NB);
  if (loop == LOOP_WGMMA && rule != LOOP_WGMMA)
    return int(cudaErrorInvalidValue);
  if (loop != LOOP_STAGED && loop != LOOP_WGMMA) loop = rule;
  if (cluster == 0) cluster = cluster_of(loop, NB, a.items != nullptr);
  if (cluster < 1 || (cluster > 1 && loop != LOOP_WGMMA))
    return int(cudaErrorInvalidValue);
  if constexpr (sizeof(T) <= 2) {
    if (loop == LOOP_WGMMA)
      return hopper::launch<T, SRC, NB>(a, n_ctas, ctas, cluster, s);
  }
  switch (kpl_of(a.k)) {
    case 1: return launch<T, SRC, 1, NB>(a, n_ctas, s);
    case 2: return launch<T, SRC, 2, NB>(a, n_ctas, s);
    default: return launch<T, SRC, 4, NB>(a, n_ctas, s);
  }
}

// What every entry point checks of the sizes it is given.
inline bool sizes_ok(const ProbeArgs &a) {
  return a.k >= 1 && a.k <= 128 && a.k_out >= a.k && a.k_out <= POOL &&
         (a.items == nullptr ||
          (a.span > 0 && a.span % POOL == 0 && a.block_items != nullptr &&
           a.written != nullptr && a.n_items > 0 && a.n_blocks > 0 &&
           (a.k_out == a.k || a.pool != nullptr)));
}

}  // namespace probe
