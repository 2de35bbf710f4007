// The probe kernel's main loop for Hopper: queries resident in shared
// memory, the store streamed through a TMA-fed ring, the product on wgmma,
// the top-k test from the accumulator registers. Included by
// probe_common.cuh, which holds what both loops share (the pool's keys and
// extras, ProbeArgs) and the rule that chooses between them.
//
// It serves the instantiations with bfloat16 and float16 queries: a store of
// the queries' type (SRC_SAME) and int8 / packed-int4 codes (SRC_INT8,
// SRC_INT4). The function is probe_kernel's, element for element; only the
// order in which the tensor cores sum a product differs.
//
// One CTA, as in probe_kernel, owns one block of QB = 64 slots (or a work
// item of it) and walks its bucket's rows in tiles of NB. Its warps have three
// roles, which meet only at mbarriers after the start:
//
//   - warps 0-3, the consumer warpgroup. The 64 slots' query rows are
//     gathered once, at the start, into the 128-byte-swizzled K-major layout
//     that wgmma reads (64 x 64 features a slice, 8 KB); they are the A
//     operand for the CTA's whole life. For each tile the warpgroup waits
//     for each slice of NB store rows x 64 features in the operand ring,
//     issues four wgmma m64nNBk16 on it (float32 sums in registers) and
//     hands the stage back once those have read it. Then each warp, which
//     owns 16 of the 64 slot rows in the accumulator layout, turns its
//     fragment into distances and tests them against its rows' k-th bests
//     in registers. One vote skips the tile when nothing beats any of them.
//     Otherwise the warp writes its own 16 rows to its part of the
//     shared-memory tile, the four threads of a row join their marks (one
//     bit a column), and one thread per row inserts that row's marked
//     columns, in column order, into the row's list. For k <= 32 that
//     thread holds the list in its registers (16 or 32 entries, shifted by
//     one unrolled pass without a branch or a load); for a longer list it
//     is k 64-bit (distance, row) keys in shared memory, shifted the same
//     way. Sixteen rows insert at once in a warp, where probe_kernel's
//     warp-wide insert takes them one by one: with only four warps to hide
//     its latency that insert took a third of this loop's time, and the
//     list in shared memory still a third of what was left. A column must
//     be strictly below the k-th best to enter and entries that equal it
//     stay ahead, so the tie rule is probe_kernel's. The rerank pool is
//     folded from the registers: a row's class belongs to the one thread
//     that holds its columns;
//   - warp 4, the loader: one thread keeps a ring full with TMA tile loads
//     through a tensor map over the whole store (rows past the store's end
//     and features past d arrive as zeros; rows past the bucket's end are
//     masked by the consumers). It starts before the queries are gathered;
//   - warps 5-8, only over a quantized store, the converters: the loader's
//     ring then carries the raw code bytes (64 or 32 a row and slice), and
//     each of these warps turns whole raw stages into swizzled operand
//     stages of the queries' type (every code is exact in it), several
//     stages at once. A packed-int4 slice of 32 bytes holds features
//     [32 s, 32 s + 32) in its low and [d/2 + 32 s, d/2 + 32 s + 32) in its
//     high nibbles; the resident queries are gathered in that order, so the
//     product needs no shuffle.
//
// After the start there is no __syncthreads(): a stage is full when its
// mbarrier has the bytes (TMA) or a converter warp's arrivals, and empty
// when the four consumer warps have arrived after wgmma.wait_group. The
// rings take what shared memory the rest leaves (`stages`); a launch whose
// plan does not fit takes the staged loop, by probe_common.cuh::loop_of and
// never by a failed launch.
//
// What bounds it now. A bucket is read once per 64-slot block, so about
// three times at 2 probes, from L2; with wgmma m64n64k16 reading both
// operands from shared memory (4 KB for 32 cycles of the tensor cores),
// the TMA writes and, over codes, the converters' reads and writes, shared
// memory is as busy as the tensor cores. One CTA fills an SM, so blocks run
// in waves whose tail the longest bucket sets.

#pragma once

#include <cuda.h>

#include <type_traits>

// Parts of the loop that a build can leave out, to time what is left
// (-DPROBE_PARTS_OFF=bits, tpulmi_torch/tools/time_probe.py; the results are
// then wrong): 1 the list inserts, 2 the whole epilogue, 4 the wgmmas, 8 a
// quantized store's column scales (distances as over a full-precision one).
#ifndef PROBE_PARTS_OFF
#define PROBE_PARTS_OFF 0
#endif

// -DPROBE_CLOCKS=1 (the same tool, --clocks): the second consumer warp of
// every 97th CTA counts the cycles it spends waiting for a stage, between a
// stage's arrival and the end of its wgmmas, in the epilogue up to the
// vote, and from there to the tile's end (tile write, marks, inserts), and
// prints them at its end. Where no profiler reads the card's counters, this
// says which part of a CTA's life to look at.
#ifndef PROBE_CLOCKS
#define PROBE_CLOCKS 0
#endif
#if PROBE_CLOCKS
#include <cstdio>
#define PROBE_TICK(t) const long long t = clock64()
#define PROBE_TOCK(sum, t) sum += clock64() - t
#else
#define PROBE_TICK(t)
#define PROBE_TOCK(sum, t)
#endif

namespace probe {
namespace hopper {

constexpr int SLICE = 64;                  // features of one ring stage
constexpr int SLICE_BYTES = 128;           // one operand row of a stage
constexpr int A_SLICE_BYTES = QB * SLICE_BYTES;
constexpr int CONSUMER_WARPS = 4;
constexpr int CONVERTER_WARPS = 4;
constexpr int CONVERTERS = CONVERTER_WARPS * 32;
constexpr int FIRST_CONVERTER = (CONSUMER_WARPS + 1) * 32;
constexpr int BARRIER_BYTES = 512;
// what the plan may take of one SM: the opt-in limit of an H100
constexpr size_t SMEM_LIMIT = 232448;
// Most stages of the rings. Over a store of the queries' type the operand
// ring is what the TMA loads fill, and what is in flight hides their
// latency; over codes the converters fill it from the raw ring, and more
// than 8 stages of either gained nothing on the card.
constexpr int MAX_STAGES = 12, MAX_CODE_STAGES = 8, MIN_STAGES = 2;

__host__ __device__ constexpr int raw_row_bytes(int src) {
  return src == SRC_INT8 ? 64 : (src == SRC_INT4 ? 32 : 0);
}
__host__ __device__ constexpr int slices(int d) {
  return (d + SLICE - 1) / SLICE;
}
__host__ __device__ constexpr int threads(int src) {
  return FIRST_CONVERTER + (src == SRC_SAME ? 0 : CONVERTERS);
}

// Shared memory of one CTA with rings of `n_stages`: 1 KB to align the
// swizzled buffers, the resident queries, the operand ring, the raw ring of
// a quantized store, the barriers, the pool's keys, the distance tile, the
// lists (k keys a slot), thresholds and query rows, and each consumer
// warp's column scales.
__host__ __device__ constexpr size_t smem_bytes(int d, int src, int k, int nb,
                                                bool pool, int n_stages) {
  return 1024 + size_t(slices(d)) * A_SLICE_BYTES +
         size_t(n_stages) * nb * (SLICE_BYTES + raw_row_bytes(src)) +
         BARRIER_BYTES + (pool ? size_t(QB) * POOL * sizeof(PoolKey) : 0) +
         size_t(QB) * (nb + 4) * 4 + size_t(QB) * k * 8 + size_t(QB) * 8 +
         size_t(CONSUMER_WARPS) * nb * 4;
}

// Stages of the rings: as many as fit beside the rest, up to the most; 0
// when not even MIN_STAGES fit, and the launch takes the staged loop. Over
// codes 8, 4, 3 or 2: with at most CONVERTER_WARPS warps at work, each
// taking every such stage, a stage is then always converted by the same
// warp, which a wait on a phase's parity relies on.
__host__ __device__ constexpr int stages(int d, int src, int k, int nb,
                                         bool pool) {
  const bool codes = src != SRC_SAME;
  for (int n = codes ? MAX_CODE_STAGES : MAX_STAGES; n >= MIN_STAGES; --n) {
    if (codes && n > CONVERTER_WARPS && n % CONVERTER_WARPS != 0) continue;
    if (smem_bytes(d, src, k, nb, pool, n) <= SMEM_LIMIT) return n;
  }
  return 0;
}

// ------------------------------------------------------------ PTX wrappers
__device__ __forceinline__ uint32_t smem_addr(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}
// Wait until the barrier has left the phase of `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// Generic-proxy writes to shared memory made visible to wgmma and TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap *map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: rows of 128 bytes, groups of 8 rows 1024 bytes apart.
__device__ __forceinline__ uint64_t operand_desc(uint32_t addr) {
  return uint64_t((addr & 0x3ffff) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// d += A B^T for one k-step of 16 features: A 64 x 16 and B NB x 16 from
// shared memory (descriptors `da`, `db`), float32 sums in registers;
// scale_d = 0 starts a new sum.
#define PROBE_WGMMA_64(TY)                                                   \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %34, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                    \
      " %8, %9, %10, %11, %12, %13, %14, %15, "                              \
      " %16, %17, %18, %19, %20, %21, %22, %23, "                            \
      " %24, %25, %26, %27, %28, %29, %30, %31}, "                           \
      "%32, %33, p, 1, 1, 0, 0;\n"                                           \
      "}\n"                                                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31])                                             \
      : "l"(da), "l"(db), "r"(scale_d))

#define PROBE_WGMMA_128(TY)                                                  \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %66, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                    \
      " %8, %9, %10, %11, %12, %13, %14, %15, "                              \
      " %16, %17, %18, %19, %20, %21, %22, %23, "                            \
      " %24, %25, %26, %27, %28, %29, %30, %31, "                            \
      " %32, %33, %34, %35, %36, %37, %38, %39, "                            \
      " %40, %41, %42, %43, %44, %45, %46, %47, "                            \
      " %48, %49, %50, %51, %52, %53, %54, %55, "                            \
      " %56, %57, %58, %59, %60, %61, %62, %63}, "                           \
      "%64, %65, p, 1, 1, 0, 0;\n"                                           \
      "}\n"                                                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),     \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),     \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),     \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),     \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),     \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),     \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                   \
      : "l"(da), "l"(db), "r"(scale_d))

template <typename T, int NB>
__device__ __forceinline__ void wgmma_k16(float (&d)[NB / 2], uint64_t da,
                                          uint64_t db, int scale_d) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (NB == 64) {
    if constexpr (BF16) PROBE_WGMMA_64("bf16"); else PROBE_WGMMA_64("f16");
  } else {
    if constexpr (BF16) PROBE_WGMMA_128("bf16"); else PROBE_WGMMA_128("f16");
  }
}

// Keeps the compiler from moving reads of the sums above the wait.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Two codes as two values of T in one word, by integer and packed
// half-precision instructions alone (a conversion instruction runs at a
// quarter of their rate). `w` holds four codes as bytes: int8 codes as they
// are stored, int4 codes as nibbles in 0..15; `sel` picks bytes 0 and 1
// (0x4140) or 2 and 3 (0x4342) into the low bytes of the two halves, with
// byte 0 of `high` above each.
//   float16: 0x6400 | u is 1024 + u for a byte u, so the code plus a bias,
//   as a byte, goes under 0x64 and the bias comes off in one subtraction.
//   bfloat16: 0x4300 | u is 128 + u for u < 128 only. An int4 code plus 8
//   fits. An int8 code x is its low seven bits less 128 times its top bit:
//   (128 + low) - (128 or 256), the second built from the top bit.
// Every step is exact.
template <typename T, int SRC>
__device__ __forceinline__ uint32_t two_codes(uint32_t w, uint32_t sel) {
  if constexpr (std::is_same<T, __half>::value) {
    constexpr uint32_t FLIP = SRC == SRC_INT8 ? 0x80808080u : 0x08080808u;
    constexpr uint32_t BIAS = SRC == SRC_INT8 ? 0x64806480u : 0x64086408u;
    const uint32_t u = __byte_perm(w ^ FLIP, 0x64646464u, sel);
    const __half2 r = __hsub2(*reinterpret_cast<const __half2 *>(&u),
                              *reinterpret_cast<const __half2 *>(&BIAS));
    return *reinterpret_cast<const uint32_t *>(&r);
  } else if constexpr (SRC == SRC_INT4) {
    constexpr uint32_t BIAS = 0x43084308u;
    const uint32_t u = __byte_perm(w ^ 0x08080808u, 0x43434343u, sel);
    const __nv_bfloat162 r =
        __hsub2(*reinterpret_cast<const __nv_bfloat162 *>(&u),
                *reinterpret_cast<const __nv_bfloat162 *>(&BIAS));
    return *reinterpret_cast<const uint32_t *>(&r);
  } else {
    const uint32_t t = __byte_perm(w, 0u, sel);
    const uint32_t low = (t & 0x007f007fu) | 0x43004300u;
    const uint32_t off = (t & 0x00800080u) | 0x43004300u;
    const __nv_bfloat162 r =
        __hsub2(*reinterpret_cast<const __nv_bfloat162 *>(&low),
                *reinterpret_cast<const __nv_bfloat162 *>(&off));
    return *reinterpret_cast<const uint32_t *>(&r);
  }
}

// Eight codes (`lo`, `hi`: four bytes each, as `two_codes` takes them) as
// eight values of T.
template <typename T, int SRC>
__device__ __forceinline__ uint4 codes_to(uint32_t lo, uint32_t hi) {
  return make_uint4(two_codes<T, SRC>(lo, 0x4140), two_codes<T, SRC>(lo, 0x4342),
                    two_codes<T, SRC>(hi, 0x4140), two_codes<T, SRC>(hi, 0x4342));
}

// Where chunk `ch` (16 bytes, 8 features) of row `r` lies in a swizzled
// slice or stage.
__device__ __forceinline__ int swizzled(int r, int ch) {
  return r * SLICE_BYTES + ((ch ^ (r & 7)) << 4);
}

// One raw stage (NB rows of RAWB code bytes) into one operand stage, by one
// warp; `ct` is the lane.
template <typename T, int SRC, int NB>
__device__ __forceinline__ void convert_stage(const unsigned char *raw,
                                              unsigned char *op, int ct) {
  constexpr int RAWB = raw_row_bytes(SRC);
  constexpr int VPR = RAWB / 16;          // 16-byte raw vectors per row
  // every lane's raw vectors are loaded before the first is converted
  constexpr int PER_LANE = NB * VPR / 32;
  uint4 in_flight[PER_LANE];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int v = ct + 32 * i;
    in_flight[i] = *reinterpret_cast<const uint4 *>(raw + (v / VPR) * RAWB +
                                                    (v % VPR) * 16);
  }
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int v = ct + 32 * i;
    const int r = v / VPR, vi = v % VPR;
    const uint4 w = in_flight[i];
    if constexpr (SRC == SRC_INT8) {
      // 16 codes: features 16 vi .. 16 vi + 15 of the slice
      *reinterpret_cast<uint4 *>(op + swizzled(r, 2 * vi)) =
          codes_to<T, SRC>(w.x, w.y);
      *reinterpret_cast<uint4 *>(op + swizzled(r, 2 * vi + 1)) =
          codes_to<T, SRC>(w.z, w.w);
    } else {
      // 16 bytes: the low nibbles are positions 16 vi .. 16 vi + 15 of the
      // slice, the high nibbles positions 32 + 16 vi ..
      constexpr uint32_t NIB = 0x0f0f0f0fu;
      const uint32_t in[4] = {w.x, w.y, w.z, w.w};
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[i] = in[i] & NIB;
        hi[i] = (in[i] >> 4) & NIB;
      }
      *reinterpret_cast<uint4 *>(op + swizzled(r, 2 * vi)) =
          codes_to<T, SRC>(lo[0], lo[1]);
      *reinterpret_cast<uint4 *>(op + swizzled(r, 2 * vi + 1)) =
          codes_to<T, SRC>(lo[2], lo[3]);
      *reinterpret_cast<uint4 *>(op + swizzled(r, 4 + 2 * vi)) =
          codes_to<T, SRC>(hi[0], hi[1]);
      *reinterpret_cast<uint4 *>(op + swizzled(r, 4 + 2 * vi + 1)) =
          codes_to<T, SRC>(hi[2], hi[3]);
    }
  }
}

// Insert `key`, which is below the list's last, into the sorted list of one
// slot row, by one thread. A list is k (distance, row) keys, ascending,
// QB keys apart (entry p of slot row r at [p * QB + r], so the threads of a
// warp, one row each, meet no bank twice). Every entry is read and written
// once, with no branch and no load that waits for another: the k loads go
// out together. Keys order by distance, then by row, so equal distances
// keep the lower store row.
__device__ __forceinline__ void insert_key(PoolKey *list, int k, PoolKey key) {
  PoolKey here = list[(k - 1) * QB];
#pragma unroll 4
  for (int p = k - 1; p >= 1; --p) {
    const PoolKey ahead = list[(p - 1) * QB];
    list[p * QB] = ahead > key ? ahead : (here > key ? key : here);
    here = ahead;
  }
  list[0] = here > key ? key : here;
}

// The same insert into a list of KL entries held in one thread's registers
// (`ld` ascending, `li` their store rows), which keeps the KL best; every
// index is a constant once unrolled, so nothing waits for shared memory.
// Returns the list's k-th best, k <= KL.
template <int KL>
__device__ __forceinline__ float insert_held(float (&ld)[KL], int (&li)[KL],
                                             int k, float cv, int cid) {
#pragma unroll
  for (int p = KL - 1; p >= 1; --p) {
    const bool shift = ld[p - 1] > cv, here = ld[p] > cv;
    li[p] = shift ? li[p - 1] : (here ? cid : li[p]);
    ld[p] = shift ? ld[p - 1] : (here ? cv : ld[p]);
  }
  if (ld[0] > cv) {
    ld[0] = cv;
    li[0] = cid;
  }
  float th = ld[0];
#pragma unroll
  for (int p = 1; p < KL; ++p) th = p < k ? ld[p] : th;
  return th;
}

// T: bfloat16 or float16, the type of the queries and of the operand
// stages. KL: the capacity of a slot row's list when the thread that
// inserts into it holds it in registers (16 or 32, at least k), or 0 for a
// list in shared memory (k above 32). SRC and NB as in probe_kernel; `map`
// is the tensor map over the store (`store_map`).
template <typename T, int SRC, int NB, int KL>
__global__ void __launch_bounds__(threads(SRC))
    probe_kernel_wgmma(const __grid_constant__ CUtensorMap map,
                       const ProbeArgs a) {
  constexpr int NW = NB / 64;              // 64-bit words of a row's columns
  constexpr int LDT = NB + 4;
  constexpr int RAWB = raw_row_bytes(SRC);
  constexpr int STAGE_BYTES = NB * SLICE_BYTES;
  constexpr int RAW_BYTES = NB * RAWB;
  constexpr int NTHREADS = threads(SRC);
  constexpr int GATHERERS = NTHREADS - 32;   // all but the loader's warp
  constexpr bool SCALED = SRC != SRC_SAME;
  extern __shared__ unsigned char smem_raw[];
  unsigned char *as = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T *q = static_cast<const T *>(a.q);
  const int d = a.d, k = a.k;
  const int ks = slices(d);
  const long long n_rows = a.n_rows;
  const bool flat = a.items != nullptr;
  const bool pooled = a.k_out > k;
  const int S = stages(d, SRC, k, NB, pooled);
  long long blk = blockIdx.x;
  int chunk = 0;
  if (flat) {
    blk = a.items[2 * blockIdx.x];
    chunk = a.items[2 * blockIdx.x + 1];
    if (blk < 0) return;   // padding past the worklist's end
  }
  const long long dstart = a.blocks[blk * 3 + 0];
  const int dcnt = a.blocks[blk * 3 + 1];
  const int nq = max(0, min(a.blocks[blk * 3 + 2], QB));
  const int t_lo = flat ? chunk * a.span : 0;
  const int t_hi = flat ? min(dcnt, t_lo + a.span) : dcnt;
  const int n_tiles = (nq > 0 && t_hi > t_lo) ? (t_hi - t_lo + NB - 1) / NB : 0;

  unsigned char *bs = as + size_t(ks) * A_SLICE_BYTES;       // operand ring
  unsigned char *raws = bs + S * STAGE_BYTES;                // raw ring
  uint64_t *bars = reinterpret_cast<uint64_t *>(raws + S * RAW_BYTES);
  PoolKey *pool_s = reinterpret_cast<PoolKey *>(
      reinterpret_cast<unsigned char *>(bars) + BARRIER_BYTES);
  float *tile = reinterpret_cast<float *>(pool_s + (pooled ? QB * POOL : 0));
  PoolKey *list = reinterpret_cast<PoolKey *>(tile + QB * LDT);   // (k, QB)
  float *thr = reinterpret_cast<float *>(list + QB * k);
  int *qrow = reinterpret_cast<int *>(thr + QB);
  float *sc = reinterpret_cast<float *>(qrow + QB);  // (consumer warps, NB)
  // barriers of stage i: operand stage full, operand stage empty, raw stage
  // full, raw stage empty
  const uint32_t bar0 = smem_addr(bars);
  auto op_full = [&](int i) { return bar0 + 8 * i; };
  auto op_empty = [&](int i) { return bar0 + 8 * (MAX_STAGES + i); };
  auto raw_full = [&](int i) { return bar0 + 8 * (2 * MAX_STAGES + i); };
  auto raw_empty = [&](int i) { return bar0 + 8 * (3 * MAX_STAGES + i); };

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(op_full(i), 1);
      mbar_init(op_empty(i), CONSUMER_WARPS);
      mbar_init(raw_full(i), 1);
      mbar_init(raw_empty(i), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < QB * k; i += NTHREADS) list[i] = make_key(SENTINEL, -1);
  for (int i = tid; i < QB; i += NTHREADS) {
    thr[i] = SENTINEL;
    qrow[i] = a.qidx[blk * QB + i];
  }
  if (pooled)
    for (int i = tid; i < QB * POOL; i += NTHREADS) pool_s[i] = EMPTY_KEY;
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // ---------------------------------------------------------- the loader
    // It starts at once: the ring fills while the other warps gather.
    if (lane != 0) return;
    const uint32_t dst0 = smem_addr(SCALED ? raws : bs);
    constexpr int BYTES = SCALED ? RAW_BYTES : STAGE_BYTES;
    constexpr int STEP = SCALED ? RAWB : SLICE;   // elements of the map
    int st = 0, ph = 0;
    for (int t = 0; t < n_tiles; ++t) {
      const int row = int(dstart) + t_lo + t * NB;
      for (int s = 0; s < ks; ++s) {
        mbar_wait(SCALED ? raw_empty(st) : op_empty(st), ph ^ 1);
        const uint32_t full = SCALED ? raw_full(st) : op_full(st);
        mbar_expect_tx(full, BYTES);
        tma_load_2d(dst0 + st * BYTES, &map, full, s * STEP, row);
        if (++st == S) { st = 0; ph ^= 1; }
      }
    }
    return;
  }

  // The resident queries, gathered once by every warp but the loader's:
  // chunk ch of slice s of slot row r holds features [f0, f0 + 8) of its
  // query, zeros past the width and for a dead slot. Four loads are in
  // flight for each thread.
  {
    const int gt = tid < CONSUMER_WARPS * 32 ? tid : tid - 32;
    const int half = d >> 1, total = QB * ks * 8;
    for (int v0 = gt; v0 < total; v0 += 4 * GATHERERS) {
      uint4 val[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int v = v0 + u * GATHERERS;
        const int r = v / (ks * 8), s = (v % (ks * 8)) >> 3, ch = v & 7;
        int f0 = s * SLICE + ch * 8;
        bool live = v < total && r < nq && f0 < d;
        if constexpr (SRC == SRC_INT4) {
          const int j0 = s * 32 + (ch & 3) * 8;   // byte of the packed row
          f0 = j0 + (ch >= 4 ? half : 0);
          live = v < total && r < nq && j0 < half;
        }
        val[u] = make_uint4(0, 0, 0, 0);
        if (live)
          val[u] = __ldg(reinterpret_cast<const uint4 *>(
              q + size_t(qrow[r]) * d + f0));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int v = v0 + u * GATHERERS;
        if (v < total)
          *reinterpret_cast<uint4 *>(as + ((v % (ks * 8)) >> 3) * A_SLICE_BYTES +
                                     swizzled(v / (ks * 8), v & 7)) = val[u];
      }
    }
    fence_async_smem();
    asm volatile("bar.sync 1, %0;\n" ::"r"(GATHERERS) : "memory");
  }

  if (warp > CONSUMER_WARPS) {
    // ------------------------------------------------------ the converters
    // Each converter warp takes whole stages, every `step`-th one, so
    // several stages are under conversion at once and one's latency hides
    // behind the others'. No more warps than stages convert: a wait on a
    // phase's parity tells two phases apart, not three, so a warp's first
    // stage must lie in the ring's first round.
    if constexpr (SCALED) {
      const int cw = warp - CONSUMER_WARPS - 1;
      const int step = min(CONVERTER_WARPS, S);
      int st = cw, ph = 0;
      for (int it = cw; cw < step && it < n_tiles * ks; it += step) {
        mbar_wait(raw_full(st), ph);
        mbar_wait(op_empty(st), ph ^ 1);
        convert_stage<T, SRC, NB>(raws + st * RAW_BYTES, bs + st * STAGE_BYTES,
                                  lane);
        // every lane's writes are fenced for wgmma, then one lane arrives
        fence_async_smem();
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(op_full(st));
          mbar_arrive(raw_empty(st));
        }
        st += step;
        if (st >= S) { st -= S; ph ^= 1; }
      }
    }
    return;
  }

  // --------------------------------------------------------- the consumers
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const float inf = __int_as_float(0x7f800000);
  const uint64_t adesc = operand_desc(smem_addr(as));
  const uint64_t bdesc = operand_desc(smem_addr(bs));
  float *scw = sc + warp * NB;
  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.0f;
  // the list of the slot row that this thread inserts into (threads 0 and 1
  // of each four: rows r0 and r1), when it is held in registers
  constexpr int HELD = KL > 0 ? KL : 1;
  float held_d[HELD];
  int held_i[HELD];
#pragma unroll
  for (int p = 0; p < HELD; ++p) {
    held_d[p] = SENTINEL;
    held_i[p] = -1;
  }
#if PROBE_CLOCKS
  long long c_wait = 0, c_mma = 0, c_test = 0, c_insert = 0;
#endif
  PROBE_TICK(c_start);
  int st = 0, ph = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t_lo + t * NB;
    const long long row0 = dstart + t0;
    const int ncol = min(NB, t_hi - t0);
    // the tile's column scales (lane l: columns l + 32 g), asked for before
    // the product and used after it
    float scl[NB / 32];
    if constexpr (SCALED && !(PROBE_PARTS_OFF & 8)) {
#pragma unroll
      for (int gg = 0; gg < NB / 32; ++gg) {
        const int c = lane + 32 * gg;
        scl[gg] = (c < ncol && row0 + c < n_rows) ? a.scales[row0 + c] : 0.0f;
      }
    }
    int prev = 0;
    for (int s = 0; s < ks; ++s) {
      PROBE_TICK(c0);
      mbar_wait(op_full(st), ph);
      PROBE_TOCK(c_wait, c0);
      PROBE_TICK(c1);
      wgmma_fence();
      if constexpr (!(PROBE_PARTS_OFF & 4)) {
#pragma unroll
        for (int kk = 0; kk < SLICE / 16; ++kk)
          wgmma_k16<T, NB>(acc, adesc + ((s * A_SLICE_BYTES + kk * 32) >> 4),
                           bdesc + ((st * STAGE_BYTES + kk * 32) >> 4),
                           (s | kk) != 0);
      }
      wgmma_commit();
      if (s > 0) {
        // the slice before this one has been read
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(op_empty(prev));
      }
      prev = st;
      if (++st == S) { st = 0; ph ^= 1; }
      PROBE_TOCK(c_mma, c1);
    }
    PROBE_TICK(c2);
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(op_empty(prev));
    pin(acc);
    PROBE_TOCK(c_mma, c2);
    PROBE_TICK(c3);
    if constexpr ((PROBE_PARTS_OFF & 2) != 0) continue;

    if constexpr (SCALED && !(PROBE_PARTS_OFF & 8)) {
#pragma unroll
      for (int gg = 0; gg < NB / 32; ++gg)
        scw[lane + 32 * gg] = __fdiv_rn(scl[gg], a.levels);
      __syncwarp();
    }
    // Thread (g, tq) of a warp holds, for j < NB / 8, columns 8 j + 2 tq and
    // + 1 of slot rows r0 (acc[4 j], [4 j + 1]) and r1 (acc[4 j + 2],
    // [4 j + 3]). It turns them into distances, folds them into the pool,
    // and marks in hit0 / hit1 (one bit a column, before the shift by 2 tq)
    // those under the row's k-th best.
    const float th0 = r0 < nq ? thr[r0] : -inf;
    const float th1 = r1 < nq ? thr[r1] : -inf;
    unsigned long long hit0[NW], hit1[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) hit0[w] = hit1[w] = 0;
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * tq + (e & 1);
        const int r = (e & 2) ? r1 : r0;
        const float s = acc[4 * j + e];
        float v = 1.0f - s;
        if constexpr (SCALED && !(PROBE_PARTS_OFF & 8))
          v = __fsub_rn(1.0f, __fmul_rn(s, scw[c]));
        v = c < ncol ? v : inf;
        acc[4 * j + e] = v;
        if (pooled && c < ncol && r < nq) {
          // a class of a row belongs to the one thread that holds its
          // columns; rows come in ascending order and only a smaller key
          // is stored, so equal distances keep the lower row
          const PoolKey key = make_key(v, int(row0) + c);
          PoolKey *slot = pool_s + r * POOL + ((t0 + c) & (POOL - 1));
          if (key < *slot) *slot = key;
        }
        const unsigned long long bit = 1ull << ((8 * j + (e & 1)) & 63);
        if (e & 2) hit1[j / 8] |= v < th1 ? bit : 0;
        else hit0[j / 8] |= v < th0 ? bit : 0;
      }
    }
    unsigned long long some = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) some |= hit0[w] | hit1[w];
    // the common case after the first tiles: nothing beats any threshold
    PROBE_TOCK(c_test, c3);
    if (!__any_sync(FULL, some != 0) || (PROBE_PARTS_OFF & 1)) continue;
    PROBE_TICK(c4);
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      const int c = 8 * j + 2 * tq;
      *reinterpret_cast<float2 *>(tile + r0 * LDT + c) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2 *>(tile + r1 * LDT + c) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    // the four threads of a row join their marks; the first of them then
    // inserts row r0's marked columns, the second row r1's, in column order
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      hit0[w] <<= 2 * tq;
      hit1[w] <<= 2 * tq;
      hit0[w] |= __shfl_xor_sync(FULL, hit0[w], 1);
      hit0[w] |= __shfl_xor_sync(FULL, hit0[w], 2);
      hit1[w] |= __shfl_xor_sync(FULL, hit1[w], 1);
      hit1[w] |= __shfl_xor_sync(FULL, hit1[w], 2);
    }
    __syncwarp();
    const int r = tq == 0 ? r0 : r1;
    if (tq < 2 && r < nq) {
      const float *trow = tile + r * LDT;
      float th = thr[r];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        unsigned long long marks = tq == 0 ? hit0[w] : hit1[w];
        while (marks) {
          const int c = 64 * w + __ffsll(marks) - 1;
          marks &= marks - 1;
          const float v = trow[c];
          if (v < th) {
            if constexpr (KL > 0) {
              th = insert_held<KL>(held_d, held_i, k, v, int(row0) + c);
            } else {
              insert_key(list + r, k, make_key(v, int(row0) + c));
              th = key_dist(list[(k - 1) * QB + r]);
            }
          }
        }
      }
      thr[r] = th;
    }
    __syncwarp();
    PROBE_TOCK(c_insert, c4);
  }
#if PROBE_CLOCKS
  if (warp == 1 && lane == 0 && blockIdx.x % 97 == 5 && n_tiles > 0)
    printf("[clocks] cta %d: %d tiles of %d slices, %lld cycles: %lld waiting "
           "for a stage, %lld in wgmma, %lld testing, %lld inserting\n",
           int(blockIdx.x), n_tiles, ks, clock64() - c_start, c_wait, c_mma,
           c_test, c_insert);
#endif

  // lists held in registers go to the shared-memory lists, as keys
  if constexpr (KL > 0) {
    const int r = tq == 0 ? r0 : r1;
    if (tq < 2) {
#pragma unroll
      for (int p = 0; p < KL; ++p)
        if (p < k) list[p * QB + r] = make_key(held_d[p], held_i[p]);
    }
  }
  // each warp writes its own 16 slot rows: with items the item's partial
  // lists, else the block's final rows
  __syncwarp();
  const size_t orow = size_t(flat ? blockIdx.x : blk) * QB;
  const int ko = flat ? k : a.k_out;
  for (int i = lane; i < 16 * k; i += 32) {
    const int r = warp * 16 + i / k, p = i % k;
    const PoolKey key = list[p * QB + r];
    a.out_d[(orow + r) * ko + p] = key_dist(key);
    a.out_i[(orow + r) * ko + p] = int(unsigned(key));
  }
  if (!pooled) return;
  if (flat) {
    const PoolKey *wp = pool_s + warp * 16 * POOL;
    PoolKey *pool_g = a.pool + (size_t(blk) * QB + warp * 16) * POOL;
    for (int i = lane; i < 16 * POOL; i += 32)
      if (wp[i] != EMPTY_KEY) atomicMin(pool_g + i, wp[i]);
  } else {
    for (int r = warp * 16; r < warp * 16 + 16; ++r)
      // a key's low word is its row
      write_extras(pool_s + r * POOL, reinterpret_cast<const int *>(list + r),
                   k, a.k_out, a.out_d + (orow + r) * ko,
                   a.out_i + (orow + r) * ko, 2 * QB);
  }
}

// The tensor map over the store that the loader's TMA loads go through:
// rows of `d` values of T (SRC_SAME, boxes of NB rows x 64 values in the
// 128-byte swizzle) or of code bytes (boxes of NB rows x 64 or 32 bytes as
// they lie). cuTensorMapEncodeTiled lives in libcuda; the runtime hands out
// its address, so nothing links against libcuda. Returns a CUDA error code.
using EncodeTiled = CUresult (*)(CUtensorMap *, CUtensorMapDataType,
                                 cuuint32_t, void *, const cuuint64_t *,
                                 const cuuint64_t *, const cuuint32_t *,
                                 const cuuint32_t *, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void *p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

template <typename T, int SRC, int NB>
int store_map(CUtensorMap *map, const ProbeArgs &a) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return int(cudaErrorNotSupported);
  if (a.n_rows < 1 || reinterpret_cast<uintptr_t>(a.data) % 16 != 0)
    return int(cudaErrorInvalidValue);
  constexpr bool CODES = SRC != SRC_SAME;
  const CUtensorMapDataType type =
      CODES ? CU_TENSOR_MAP_DATA_TYPE_UINT8
            : (std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  const cuuint64_t width = SRC == SRC_INT4 ? a.d / 2 : a.d;
  const cuuint64_t dims[2] = {width, cuuint64_t(a.n_rows)};
  const cuuint64_t strides[1] = {width * (CODES ? 1 : sizeof(T))};
  const cuuint32_t box[2] = {cuuint32_t(CODES ? raw_row_bytes(SRC) : SLICE),
                             cuuint32_t(NB)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(
      map, type, 2, const_cast<void *>(a.data), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      CODES ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : int(cudaErrorInvalidValue);
}

template <typename T, int SRC, int NB, int KL>
int launch_held(const CUtensorMap &map, const ProbeArgs &a, int n_ctas,
                size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      probe_kernel_wgmma<T, SRC, NB, KL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  probe_kernel_wgmma<T, SRC, NB, KL>
      <<<n_ctas, threads(SRC), smem, stream>>>(map, a);
  return int(cudaGetLastError());
}

template <typename T, int SRC, int NB>
int launch(const ProbeArgs &a, int n_ctas, cudaStream_t stream) {
  CUtensorMap map;
  const int bad = store_map<T, SRC, NB>(&map, a);
  if (bad != 0) return bad;
  const bool pool = a.k_out > a.k;
  const size_t smem =
      smem_bytes(a.d, SRC, a.k, NB, pool, stages(a.d, SRC, a.k, NB, pool));
  // a list of up to 32 entries is held in registers
  if (a.k <= 16)
    return launch_held<T, SRC, NB, 16>(map, a, n_ctas, smem, stream);
  if (a.k <= 32)
    return launch_held<T, SRC, NB, 32>(map, a, n_ctas, smem, stream);
  return launch_held<T, SRC, NB, 0>(map, a, n_ctas, smem, stream);
}

}  // namespace hopper
}  // namespace probe
