// The probe kernel's main loop for Hopper: queries resident in shared
// memory, the store streamed through a TMA-fed ring, the product on wgmma,
// the top-k test from the accumulator registers. Included by
// probe_common.cuh, which holds what both loops share (the pool's keys and
// extras, ProbeArgs) and the rule that chooses between them.
//
// It serves the instantiations with bfloat16 and float16 queries over a
// store of the queries' type (SRC_SAME) and over int8 / packed-int4 codes
// (SRC_INT8, SRC_INT4), and those with int8 query codes over int8 or
// packed-int4 codes (int8 x int8, K3). The function is probe_kernel's,
// element for element; with float queries only the order in which the
// tensor cores sum a product differs, with int8 queries not even that: the
// int32 sums are exact, so the result equals the staged loop's to the bit.
//
// One CTA, as in probe_kernel, owns one block of QB = 64 slots and walks its
// bucket's rows in tiles of NB. With the worklist (`items`) the grid is
// persistent instead: as many CTAs as the card holds at once, each taking a
// contiguous range of the block-major items, balanced to within one item.
// A CTA keeps a block's resident queries, lists and pool across the block's
// consecutive items (a piece), writes the piece's partial lists once and
// marks its first item in `written`; at a block change it folds the old
// block's pool and gathers the new block's queries, while the loader, which
// walks the same pieces, keeps the ring full across the change. A slice is
// 128 bytes of the queries' type: 64 features of bfloat16 / float16, 128 of
// int8. Its warps have three roles, which meet only at mbarriers after the
// start:
//
//   - warps 0-3, the consumer warpgroup. The 64 slots' query rows are
//     gathered once a block, at the start or at a block change, into the
//     128-byte-swizzled K-major layout that wgmma reads (64 rows x 128
//     bytes a slice, 8 KB); they are the A operand for the whole block.
//     For each tile the warpgroup waits for each slice of NB store rows x
//     128 bytes in the operand ring,
//     starts four wgmma on it (m64nNBk16 with float32 sums, or m64nNBk32
//     s8 x s8 with int32 sums, in the same registers and fragment layout)
//     and hands the stage back once those have read it. Then each warp,
//     which owns 16 of the 64 slot rows in the accumulator layout, turns its
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
//     stay ahead, so the tie rule is probe_kernel's. The same thread folds
//     the row's columns that pass the pool's gate (below) into the row's
//     rerank pool, from the tile, in column order;
//   - warp 4, the loader: one thread keeps a ring full with TMA tile loads
//     through a tensor map over the whole store (rows past the store's end
//     and features past d arrive as zeros; rows past the bucket's end are
//     masked by the consumers). It starts before the queries are gathered.
//     Over a store of the queries' type, and over int8 codes with int8
//     queries, the codes already are the B operand: the loads land in the
//     operand ring in the 128-byte swizzle and no warp converts them;
//   - warps 5-8, only where the codes are not the operand, the converters:
//     the loader's ring then carries the raw code bytes (64 or 32 a row and
//     slice of bfloat16 / float16, 64 of packed int4 under int8 queries),
//     and each of these warps turns whole raw stages into swizzled operand
//     stages of the queries' type (every code is exact in it), several
//     stages at once. A packed-int4 slice of 2-byte queries holds features
//     [32 s, 32 s + 32) in its low and [d/2 + 32 s, d/2 + 32 s + 32) in its
//     high nibbles; under int8 queries the 16-byte chunk ch < 4 of a slice
//     holds features 64 s + 16 ch .. + 15 (low nibbles) and chunk ch >= 4
//     features d/2 + 64 s + 16 (ch - 4) .. + 15 (high nibbles). The
//     resident queries are gathered in that order, so the product needs no
//     shuffle.
//
// The rerank pool (k_out > k), a template parameter: the kernels without it
// carry none of its registers. Slot row r keeps, for each of the POOL
// residue classes c, its best key at pool_s[r * POOL + (c ^ pool_swz(r))].
// The XOR spreads the 16 rows of a warp, which fold one class at the same
// time while every column passes (a CTA's first tiles), over 16 bank pairs
// where they would all meet one (rows 1024 bytes apart); it also keeps an
// access by the accumulator layout (lanes (g, tq): rows 16 w + g, columns
// 8 j + 2 tq + e) at 2 wavefronts, not 8. A permutation inside a row changes
// no result: write_extras ranks keys, which carry their rows, and the fold
// of a work item into the global pool undoes it. In front of the pool
// stands a gate: each row keeps a bound U_r, the distance of the k_out-th
// smallest key its pool holds (+inf while fewer than k_out classes are
// filled), in the registers of the threads that hold its columns. A column
// is marked for the pool only if v <= U_r; the marks are joined like the
// list's, the tile's vote skips it only when no column beats either a
// row's k-th best or its U_r, and the row's inserting thread folds just
// the marked columns (a predicated pass over every register costs as much
// when few pass as when all do). The warp recomputes U_r of its 16 rows
// after tiles 2, 4, 8, 16, ... of the CTA, by a radix select over the
// keys' distance bits, four rows side by side and to 16 bits (the bound
// rounded up, still a bound). Why the gate is exact:
//   - class bests only fall, so a stale U_r is still an upper bound of the
//     true k_out-th class best;
//   - take the dropped column of least distance m whose class c lost its
//     true best by it. When it was dropped, at least k_out classes other
//     than c held keys at most U_r < m, and none of them can have lost its
//     own best (that best would lie under m), so they hold their exact
//     bests. The exact top-k removes at most k of them, so k_out - k keys
//     under m are left, and no class whose stored key is wrong (all at or
//     above m) can be among the k_out - k extras; every class that does
//     reach the extras holds its exact best;
//   - it holds per work item too: the atomicMin fold takes the minimum of
//     item bests, and a class dropped in one item is beaten by k_out
//     classes of that item.
// So rows [k, k_out) come out identical to the bit to the plain definition
// and to the staged loop, which keeps no gate.
//
// After the start there is no __syncthreads(): a stage is full when its
// mbarrier has the bytes (TMA) or a converter warp's arrivals, and empty
// when the four consumer warps have arrived after wgmma.wait_group. The
// rings take what shared memory the rest leaves (`stages`); a launch whose
// plan does not fit takes the staged loop, by probe_common.cuh::loop_of and
// never by a failed launch.
//
// What bounds it now. Without a cluster a bucket is read once per 64-slot
// block, so about three times at 2 probes, from L2; the 128-row tile's
// clusters (below) read it once per group, and were no faster for it: the
// loop's time with its wgmmas left out rose with the cluster's size, and a
// consumer warp waits for a stage for a tenth of its cycles or less, so
// L2's re-reads are not what holds it (PERF.md). With wgmma reading
// both operands from shared memory (4 KB for 32 cycles of the tensor cores
// at m64n64), the TMA writes and, over codes, the converters' reads and
// writes, shared memory is as busy as the tensor cores. One CTA fills an
// SM, so the
// one-CTA-per-block launch runs in waves whose tail the longest bucket sets;
// the persistent worklist has no such tail (every CTA takes about as many
// items), and pays instead for a piece's partial lists, the merge, and a
// gather of queries and a fold of the pool at each block change.

#pragma once

#include <cuda.h>

#include <type_traits>

// Parts of the loop that a build can leave out, to time what is left
// (-DPROBE_PARTS_OFF=bits, tpulmi_torch/tools/time_probe.py; the results are
// then wrong, but for 16): 1 the list inserts, 2 the whole epilogue, 4 the
// wgmmas, 8 a quantized store's column scales (distances as over a
// full-precision one), 16 the pool's gate (the pool without one: every
// column folded from the registers that hold it, by its own thread), 32
// the pool's folds (no column touches it), 64 the pool's extras and a work
// item's fold into the global pool.
#ifndef PROBE_PARTS_OFF
#define PROBE_PARTS_OFF 0
#endif

// -DPROBE_CLOCKS=1 (the same tool, --clocks): the second consumer warp of
// every 97th CTA counts the cycles it spends waiting for a stage, between a
// stage's arrival and the end of its wgmmas, in the epilogue up to the
// vote, in the pool's pass and gate, from there to the tile's end (tile
// write, marks, inserts), and after the last tile (lists out, the pool's
// extras or fold), and prints them at its end. Where no profiler reads the card's counters, this
// says which part of a CTA's life to look at.
#ifndef PROBE_CLOCKS
#define PROBE_CLOCKS 0
#endif

// The thread-block cluster (see "Clusters" above the kernel) is compiled
// into the 128-row tile's kernels only; -DPROBE_CLUSTER_ALL=1 compiles it
// into the 64-row tile's too, so that time_probe can time them with it.
#ifndef PROBE_CLUSTER_ALL
#define PROBE_CLUSTER_ALL 0
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

constexpr int SLICE_BYTES = 128;           // one operand row of a stage
constexpr int A_SLICE_BYTES = QB * SLICE_BYTES;
constexpr int CONSUMER_WARPS = 4;
constexpr int CONVERTER_WARPS = 4;
constexpr int CONVERTERS = CONVERTER_WARPS * 32;
constexpr int FIRST_CONVERTER = (CONSUMER_WARPS + 1) * 32;
constexpr int BARRIER_BYTES = 512;
// what the plan may take of one SM: the opt-in limit of an H100
constexpr size_t SMEM_LIMIT = 232448;
// Most stages of the rings. Where the loads land in the operand ring, what
// is in flight hides their latency; where converters fill it from the raw
// ring, more than 8 stages of either gained nothing on the card.
constexpr int MAX_STAGES = 12, MAX_CODE_STAGES = 8, MIN_STAGES = 2;
// CTAs of a cluster where the rule (cluster_of) gives one; a stage is then
// loaded as CLUSTER_CTAS boxes of NB / CLUSTER_CTAS rows.
constexpr int CLUSTER_CTAS = 2;
template <int NB>
__host__ __device__ constexpr bool clustered_tile() {
  return NB == 128 || PROBE_CLUSTER_ALL != 0;
}
// The cluster sizes a launch may ask for.
__host__ __device__ constexpr bool cluster_ok(int c) {
  return c == 1 || c == 2 || c == 4;
}

// Features of one slice for queries of `qb` bytes a value.
__host__ __device__ constexpr int slice_of(int qb) { return SLICE_BYTES / qb; }
// Code bytes of one row and slice in the raw ring, or 0 where the loads land
// in the operand ring: a store of the queries' type, int8 codes under int8
// queries.
__host__ __device__ constexpr int raw_row_bytes(int src, int qb) {
  return src == SRC_SAME || (src == SRC_INT8 && qb == 1)
             ? 0
             : (src == SRC_INT8 ? slice_of(qb) : slice_of(qb) / 2);
}
__host__ __device__ constexpr int slices(int d, int qb) {
  return (d + slice_of(qb) - 1) / slice_of(qb);
}
__host__ __device__ constexpr int threads(int src, int qb) {
  return FIRST_CONVERTER + (raw_row_bytes(src, qb) > 0 ? CONVERTERS : 0);
}

// Shared memory of one CTA with rings of `n_stages`: 1 KB to align the
// swizzled buffers, the resident queries, the operand ring, the raw ring
// where there is one, the barriers, the pool's keys, the distance tile, the
// lists (k keys a slot), thresholds and query rows, and each consumer
// warp's column scales.
__host__ __device__ constexpr size_t smem_bytes(int d, int src, int qb, int k,
                                                int nb, bool pool,
                                                int n_stages) {
  return 1024 + size_t(slices(d, qb)) * A_SLICE_BYTES +
         size_t(n_stages) * nb * (SLICE_BYTES + raw_row_bytes(src, qb)) +
         BARRIER_BYTES + (pool ? size_t(QB) * POOL * sizeof(PoolKey) : 0) +
         size_t(QB) * (nb + 4) * 4 + size_t(QB) * k * 8 + size_t(QB) * 8 +
         size_t(CONSUMER_WARPS) * nb * 4;
}

// Stages of the rings: as many as fit beside the rest, up to the most; 0
// when not even MIN_STAGES fit, and the launch takes the staged loop. With
// converters 8, 4, 3 or 2: with at most CONVERTER_WARPS warps at work, each
// taking every such stage, a stage is then always converted by the same
// warp, which a wait on a phase's parity relies on.
__host__ __device__ constexpr int stages(int d, int src, int qb, int k, int nb,
                                         bool pool) {
  const bool raw = raw_row_bytes(src, qb) > 0;
  for (int n = raw ? MAX_CODE_STAGES : MAX_STAGES; n >= MIN_STAGES; --n) {
    if (raw && n > CONVERTER_WARPS && n % CONVERTER_WARPS != 0) continue;
    if (smem_bytes(d, src, qb, k, nb, pool, n) <= SMEM_LIMIT) return n;
  }
  return 0;
}

// Where class c of slot row r lies in the row's POOL keys (see the header).
__host__ __device__ constexpr int pool_swz(int r) {
  return (r & 1) | ((r & 2) << 2) | ((r & 12) >> 1);
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
// 16 bytes from global to shared memory without registers (`bytes` 16, or
// 0 for zeros), in flight until `cp_async_wait`.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void *src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap *map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// The same box, written at `dst` and counted on the barrier at `bar` in
// every CTA of the cluster whose bit `mask` holds (both addresses are this
// CTA's, and stand for the same offsets in the others).
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst,
                                                      const CUtensorMap *map,
                                                      uint32_t bar, int c0,
                                                      int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(c0),
      "r"(c1)
      : "memory");
}
// The CTAs of this CTA's cluster and its rank there (1 and 0 when the launch
// has no cluster).
__device__ __forceinline__ int cluster_ctas() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return int(n);
}
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return int(r);
}
// Every thread of every CTA of the cluster meets here; what a thread wrote
// before (an mbarrier's init among it) is seen by all after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
}
// Arrive on the barrier at this CTA's offset `bar` in CTA `cta` of the
// cluster (this one too). CLUSTER_SCOPE: every earlier memory operation of
// the thread, its arrives on peers among them, is seen by the cluster
// first; else by the CTA (as CUTLASS's cluster barriers arrive), which is
// what handing back a stage that wgmma has finished reading needs: a
// release at the cluster's scope waits for the thread's outstanding memory
// operations, and cost ~2 us a stage on an H100 (PERF.md).
template <bool CLUSTER_SCOPE>
__device__ __forceinline__ void mbar_arrive_at(uint32_t bar, int cta) {
  if constexpr (CLUSTER_SCOPE) {
    asm volatile(
        "{\n"
        ".reg .b32 remote;\n"
        "mapa.shared::cluster.u32 remote, %0, %1;\n"
        "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n"
        "}\n" ::"r"(bar),
        "r"(cta)
        : "memory");
  } else {
    asm volatile(
        "{\n"
        ".reg .b32 remote;\n"
        "mapa.shared::cluster.u32 remote, %0, %1;\n"
        "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
        "}\n" ::"r"(bar),
        "r"(cta)
        : "memory");
  }
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

// d += A B^T for one k-step of 32 bytes (16 bfloat16 / float16 or 32 int8
// features): A 64 x 32 bytes and B NB x 32 bytes from shared memory
// (descriptors `da`, `db`), sums in registers (float32, or int32 for s8 x
// s8, in the same fragment layout); scale_d = 0 starts a new sum. OP names
// the instruction, ARGS its operands after the predicate, CON the sums'
// register constraint.
#define PROBE_WGMMA_64(OP, ARGS, CON)                                        \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %34, 0;\n"                                             \
      OP " "                                                                 \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                    \
      " %8, %9, %10, %11, %12, %13, %14, %15, "                              \
      " %16, %17, %18, %19, %20, %21, %22, %23, "                            \
      " %24, %25, %26, %27, %28, %29, %30, %31}, "                           \
      "%32, %33, p" ARGS ";\n"                                               \
      "}\n"                                                                  \
      : CON(d[0]), CON(d[1]), CON(d[2]), CON(d[3]), CON(d[4]), CON(d[5]),    \
        CON(d[6]), CON(d[7]), CON(d[8]), CON(d[9]), CON(d[10]), CON(d[11]),  \
        CON(d[12]), CON(d[13]), CON(d[14]), CON(d[15]), CON(d[16]),          \
        CON(d[17]), CON(d[18]), CON(d[19]), CON(d[20]), CON(d[21]),          \
        CON(d[22]), CON(d[23]), CON(d[24]), CON(d[25]), CON(d[26]),          \
        CON(d[27]), CON(d[28]), CON(d[29]), CON(d[30]), CON(d[31])           \
      : "l"(da), "l"(db), "r"(scale_d))

#define PROBE_WGMMA_128(OP, ARGS, CON)                                       \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %66, 0;\n"                                             \
      OP " "                                                                 \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                    \
      " %8, %9, %10, %11, %12, %13, %14, %15, "                              \
      " %16, %17, %18, %19, %20, %21, %22, %23, "                            \
      " %24, %25, %26, %27, %28, %29, %30, %31, "                            \
      " %32, %33, %34, %35, %36, %37, %38, %39, "                            \
      " %40, %41, %42, %43, %44, %45, %46, %47, "                            \
      " %48, %49, %50, %51, %52, %53, %54, %55, "                            \
      " %56, %57, %58, %59, %60, %61, %62, %63}, "                           \
      "%64, %65, p" ARGS ";\n"                                               \
      "}\n"                                                                  \
      : CON(d[0]), CON(d[1]), CON(d[2]), CON(d[3]), CON(d[4]), CON(d[5]),    \
        CON(d[6]), CON(d[7]), CON(d[8]), CON(d[9]), CON(d[10]), CON(d[11]),  \
        CON(d[12]), CON(d[13]), CON(d[14]), CON(d[15]), CON(d[16]),          \
        CON(d[17]), CON(d[18]), CON(d[19]), CON(d[20]), CON(d[21]),          \
        CON(d[22]), CON(d[23]), CON(d[24]), CON(d[25]), CON(d[26]),          \
        CON(d[27]), CON(d[28]), CON(d[29]), CON(d[30]), CON(d[31]),          \
        CON(d[32]), CON(d[33]), CON(d[34]), CON(d[35]), CON(d[36]),          \
        CON(d[37]), CON(d[38]), CON(d[39]), CON(d[40]), CON(d[41]),          \
        CON(d[42]), CON(d[43]), CON(d[44]), CON(d[45]), CON(d[46]),          \
        CON(d[47]), CON(d[48]), CON(d[49]), CON(d[50]), CON(d[51]),          \
        CON(d[52]), CON(d[53]), CON(d[54]), CON(d[55]), CON(d[56]),          \
        CON(d[57]), CON(d[58]), CON(d[59]), CON(d[60]), CON(d[61]),          \
        CON(d[62]), CON(d[63])                                               \
      : "l"(da), "l"(db), "r"(scale_d))

#define PROBE_F32(N, TY)                                                     \
  "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY
#define PROBE_S32(N) "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8"

// The sums' type: int32 for int8 queries, else float32.
template <typename T>
using AccOf = typename std::conditional<std::is_same<T, signed char>::value,
                                        int, float>::type;

template <typename T, int NB>
__device__ __forceinline__ void wgmma_step(AccOf<T> (&d)[NB / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, signed char>::value) {
    if constexpr (NB == 64) PROBE_WGMMA_64(PROBE_S32(64), "", "+r");
    else PROBE_WGMMA_128(PROBE_S32(128), "", "+r");
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if constexpr (NB == 64) PROBE_WGMMA_64(PROBE_F32(64, "bf16"), ", 1, 1, 0, 0", "+f");
    else PROBE_WGMMA_128(PROBE_F32(128, "bf16"), ", 1, 1, 0, 0", "+f");
  } else {
    if constexpr (NB == 64) PROBE_WGMMA_64(PROBE_F32(64, "f16"), ", 1, 1, 0, 0", "+f");
    else PROBE_WGMMA_128(PROBE_F32(128, "f16"), ", 1, 1, 0, 0", "+f");
  }
}

// Keeps the compiler from moving reads of the sums above the wait.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// A sum as float32 (an int32 sum rounded as IMmaTile::value rounds it), and
// a distance kept in, and read back from, a sum's register.
__device__ __forceinline__ float sum_of(float s) { return s; }
__device__ __forceinline__ float sum_of(int s) { return float(s); }
__device__ __forceinline__ void keep(float &slot, float v) { slot = v; }
__device__ __forceinline__ void keep(int &slot, float v) {
  slot = __float_as_int(v);
}
__device__ __forceinline__ float kept(float slot) { return slot; }
__device__ __forceinline__ float kept(int slot) { return __int_as_float(slot); }

// Sixteen packed int4 codes (`w`: nibbles in 0..15, two to a byte) as
// sign-extended int8 bytes: the low nibbles into `lo`, the high into `hi`,
// by masks and one multiply a word (a nibble's sign bit 0x08 times 0x1e is
// 0xf0, which stays in its byte), with no conversion instruction.
__device__ __forceinline__ void nibbles_to_s8(uint4 w, uint4 &lo, uint4 &hi) {
  constexpr uint32_t NIB = 0x0f0f0f0fu, SIGN = 0x08080808u;
  const uint32_t in[4] = {w.x, w.y, w.z, w.w};
  uint32_t l[4], h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = in[i] & NIB;
    h[i] = (in[i] >> 4) & NIB;
    l[i] |= (l[i] & SIGN) * 0x1eu;
    h[i] |= (h[i] & SIGN) * 0x1eu;
  }
  lo = make_uint4(l[0], l[1], l[2], l[3]);
  hi = make_uint4(h[0], h[1], h[2], h[3]);
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
  constexpr int RAWB = raw_row_bytes(SRC, sizeof(T));
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
    if constexpr (std::is_same<T, signed char>::value) {
      // packed int4 under int8 queries: 16 bytes, whose low nibbles are
      // features 16 vi .. 16 vi + 15 of the slice's first half (chunk vi)
      // and whose high nibbles are those of its second half (chunk 4 + vi)
      uint4 lo, hi;
      nibbles_to_s8(w, lo, hi);
      *reinterpret_cast<uint4 *>(op + swizzled(r, vi)) = lo;
      *reinterpret_cast<uint4 *>(op + swizzled(r, 4 + vi)) = hi;
    } else if constexpr (SRC == SRC_INT8) {
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

// The gate's select takes four rows side by side (their chains of
// reductions interleave) and resolves the top 16 bits of a distance, the
// rest taken as ones: a bound rounded up is still a bound, and 16 bits
// timed faster than 8 or 32 (PERF.md, the pool's costs).
constexpr int GATE_ROWS = 4, GATE_BITS = 16;

// For R consecutive slot rows (`rows`: POOL keys each, in any order; R a
// multiple of 4), the distance of each row's kk-th smallest key, or +inf
// while fewer than kk are filled; by the whole warp, each lane holding
// POOL / 32 of a row's distance words, and a radix select over their top
// bits: the answer's bits from the top, each set when fewer than kk words
// lie at or under the prefix with that bit clear. A lane counts at most
// POOL / 32 words a row, so four rows' counts (at most POOL each) share one
// 32-bit reduction in bytes.
template <int R>
__device__ __forceinline__ void kth_class_best(const PoolKey *rows, int kk,
                                               int lane, float (&out)[R]) {
  constexpr int G = POOL / 32;
  static_assert(R % 4 == 0 && POOL < 256, "four counts a word");
  const uint32_t *words = reinterpret_cast<const uint32_t *>(rows);
  uint32_t u[R][G], ans[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    ans[i] = 0;
#pragma unroll
    for (int g = 0; g < G; ++g)
      u[i][g] = words[2 * (i * POOL + lane + 32 * g) + 1];
  }
#pragma unroll 2
  for (int b = 31; b >= 32 - GATE_BITS; --b) {
    unsigned n[R / 4];
#pragma unroll
    for (int i = 0; i < R / 4; ++i) n[i] = 0;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const uint32_t x = ans[i] | ((1u << b) - 1u);
#pragma unroll
      for (int g = 0; g < G; ++g)
        n[i / 4] += u[i][g] <= x ? 1u << (8 * (i % 4)) : 0u;
    }
#pragma unroll
    for (int i = 0; i < R / 4; ++i) n[i] = __reduce_add_sync(FULL, n[i]);
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (int((n[i / 4] >> (8 * (i % 4))) & 0xffu) < kk) ans[i] |= 1u << b;
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    // the bits left unresolved, as ones; an empty key's word is all ones
    const uint32_t a = ans[i] | ((1u << (32 - GATE_BITS)) - 1u);
    out[i] = a == ~0u ? __int_as_float(0x7f800000)
                      : key_dist(PoolKey(a) << 32);
  }
}

// One piece of a CTA's work: the run of one block's work items that the CTA
// takes one after the other (without a worklist, the CTA's whole block):
// rows [t_lo, t_hi) of the block's bucket, scanned with the block's queries,
// lists and pool kept across the items, and written once, to the part row of
// the piece's first item (`first`; without a worklist, the block's own rows).
struct Piece {
  long long blk, dstart;
  int nq, t_lo, t_hi, first, n_tiles;
};

// Store rows a worklist item of block `b` scans, in tiles of NB: the
// block's rows when it has live slots (an empty bucket's one item: none),
// else none (a block without live slots has no items).
template <int NB>
__device__ __forceinline__ int block_tiles(const ProbeArgs &a, int b) {
  return __ldg(a.blocks + 3 * b + 2) > 0
             ? (__ldg(a.blocks + 3 * b + 1) + NB - 1) / NB
             : 0;
}

// The CTA's range [pos, end) of the worklist: contiguous, and balanced by
// the tiles its items scan to within one item. Items are weighed by tiles,
// not counted: a block's last item is short, so ranges of equal counts
// differ by up to a third in work. With T the tiles of all items, CTA c of
// G = min(CTAs, N) takes the items that start at a tile in [c T / G,
// (c + 1) T / G); N = min(true total, items the scratch holds), the true
// total read here from the last block's first item and count, so that the
// host never reads it, ends the last range. All threads
// take part: a prefix sum of the blocks' tiles over the threads, then two
// sums of the items that start before each bound, through `red` (2 (warps
// + 1) words of shared memory). Without a worklist the CTA's own block.
// False for a CTA without items, or past the last block (a cluster launch
// rounds the grid up to whole clusters), which has nothing to do.
template <int NB, int NTHREADS>
__device__ __forceinline__ bool cta_range(const ProbeArgs &a, long long *red,
                                          int &pos, int &end) {
  if (a.items == nullptr) {
    pos = blockIdx.x;
    end = pos + 1;
    return pos < a.n_blocks;
  }
  constexpr int NWARPS = NTHREADS / 32;
  const int *last = a.block_items + 2 * (a.n_blocks - 1);
  const long long n =
      min((long long)__ldg(last) + __ldg(last + 1), (long long)a.n_items);
  const long long g = min((long long)gridDim.x, n);
  if (blockIdx.x >= g) return false;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this thread's blocks, their tiles, and the tiles before them
  const int b0 = int((long long)tid * a.n_blocks / NTHREADS);
  const int b1 = int((long long)(tid + 1) * a.n_blocks / NTHREADS);
  long long mine = 0;
  for (int b = b0; b < b1; ++b) mine += block_tiles<NB>(a, b);
  long long x = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(FULL, x, o);
    x += lane >= o ? y : 0;
  }
  if (lane == 31) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    // the warps' sums, scanned: red[w] the tiles before warp w, red[NWARPS]
    // all of them
    const long long w = lane < NWARPS ? red[lane] : 0;
    long long y = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long z = __shfl_up_sync(FULL, y, o);
      y += lane >= o ? z : 0;
    }
    if (lane <= NWARPS) red[lane] = lane < NWARPS ? y - w : y;
  }
  __syncthreads();
  const long long total = red[NWARPS];
  long long off = red[warp] + x - mine;
  __syncthreads();
  const long long t0 = blockIdx.x * total / g;
  const long long t1 = blockIdx.x + 1 < g ? (blockIdx.x + 1) * total / g
                                           : total + 1;
  // a full item scans span / NB tiles; item j of block b starts at tile
  // off_b + j span / NB
  const int per = a.span / NB;
  long long lo = 0, hi = 0;
  for (int b = b0; b < b1; ++b) {
    const int items = __ldg(a.block_items + 2 * b + 1);
    lo += t0 > off ? min((long long)items, (t0 - off + per - 1) / per) : 0;
    hi += t1 > off ? min((long long)items, (t1 - off + per - 1) / per) : 0;
    off += block_tiles<NB>(a, b);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo += __shfl_xor_sync(FULL, lo, o);
    hi += __shfl_xor_sync(FULL, hi, o);
  }
  if (lane == 0) {
    red[2 * warp] = lo;
    red[2 * warp + 1] = hi;
  }
  __syncthreads();
  lo = hi = 0;
  for (int w = 0; w < NWARPS; ++w) {
    lo += red[2 * w];
    hi += red[2 * w + 1];
  }
  __syncthreads();
  pos = int(min(lo, n));
  end = int(min(hi, n));
  return pos < end;
}

// The piece that starts at `pos`, with `pos` moved past it; false at `end`.
// Items of one block with consecutive chunks, one after the other in the
// list, make one piece. Every role of a CTA walks its pieces from the same
// arrays, so none has to tell another where a piece ends.
template <int NB>
__device__ __forceinline__ bool next_piece(const ProbeArgs &a, int &pos,
                                           int end, Piece &p) {
  if (pos >= end) return false;
  const bool flat = a.items != nullptr;
  int c0 = 0, c1 = 0;
  if (!flat) {
    p.blk = pos++;
  } else {
    p.blk = __ldg(a.items + 2 * pos);
    c0 = c1 = __ldg(a.items + 2 * pos + 1);
    for (++pos; pos < end && __ldg(a.items + 2 * pos) == p.blk &&
                __ldg(a.items + 2 * pos + 1) == c1 + 1;
         ++pos)
      ++c1;
  }
  p.dstart = __ldg(a.blocks + p.blk * 3);
  const int dcnt = __ldg(a.blocks + p.blk * 3 + 1);
  p.nq = max(0, min(__ldg(a.blocks + p.blk * 3 + 2), QB));
  p.t_lo = flat ? c0 * a.span : 0;
  p.t_hi = flat ? min(dcnt, (c1 + 1) * a.span) : dcnt;
  p.first = flat ? __ldg(a.block_items + 2 * p.blk) + c0 : int(p.blk);
  p.n_tiles = (p.nq > 0 && p.t_hi > p.t_lo) ? (p.t_hi - p.t_lo + NB - 1) / NB
                                             : 0;
  return true;
}

// The CTAs of this CTA's cluster that share its store tiles: ranks
// [first, first + size), this one the j-th; a contiguous run of ranks whose
// blocks have live slots and the same store rows (the first row and the
// count in `blocks`), so they walk the same tiles. A block without live
// slots or rows, and every block outside a cluster, is a group of its own.
struct Group {
  int first, size, j;
  __device__ uint16_t mask() const {
    return uint16_t(((1u << size) - 1u) << first);
  }
};

__device__ __forceinline__ Group cluster_group(const ProbeArgs &a, int C) {
  const int rank = C > 1 ? cluster_rank() : 0;
  Group g{rank, 1, 0};
  if (C == 1) return g;
  const long long base = (long long)blockIdx.x - rank;
  auto rows_of = [&](int r, int &start, int &cnt) {
    const long long b = base + r;
    if (b >= a.n_blocks) return false;
    start = __ldg(a.blocks + 3 * b);
    cnt = __ldg(a.blocks + 3 * b + 1);
    return __ldg(a.blocks + 3 * b + 2) > 0 && cnt > 0;
  };
  int s0, c0, s, c;
  if (!rows_of(rank, s0, c0)) return g;
  int lo = rank, hi = rank + 1;
  while (lo > 0 && rows_of(lo - 1, s, c) && s == s0 && c == c0) --lo;
  while (hi < C && rows_of(hi, s, c) && s == s0 && c == c0) ++hi;
  return Group{lo, hi - lo, rank - lo};
}

// The resident queries of a block (`qrow`: the query of each slot row),
// gathered by `n` threads, `gt` this thread's place among them: chunk ch of
// slice s of slot row r holds features [f0, f0 + EPC) of its query, zeros
// past the width and for a dead slot. The copies go from global to shared
// memory asynchronously, all of a thread's in flight at once (with loads
// into registers the gather was a chain of round trips, a few tiles' time
// for each block).
template <typename T, int SRC>
__device__ __forceinline__ void gather_queries(unsigned char *as, const T *q,
                                               const int *qrow, int d, int nq,
                                               int gt, int n) {
  constexpr int QBYTES = sizeof(T);
  constexpr int SL = slice_of(QBYTES);       // features of a slice
  constexpr int EPC = 16 / QBYTES;           // features of a 16-byte chunk
  const int ks = slices(d, QBYTES);
  const int half = d >> 1, total = QB * ks * 8;
  const uint32_t as0 = smem_addr(as);
  for (int v = gt; v < total; v += n) {
    const int r = v / (ks * 8), s = (v % (ks * 8)) >> 3, ch = v & 7;
    int f0 = s * SL + ch * EPC;
    bool live = r < nq && f0 < d;
    if constexpr (SRC == SRC_INT4) {
      // byte of the packed row: its low nibble in the first four chunks,
      // its high nibble in the last four
      const int j0 = s * (SL / 2) + (ch & 3) * EPC;
      f0 = j0 + (ch >= 4 ? half : 0);
      live = r < nq && j0 < half;
    }
    cp_async_16(as0 + s * A_SLICE_BYTES + swizzled(r, ch),
                live ? q + size_t(qrow[r]) * d + f0 : q, live ? 16 : 0);
  }
  cp_async_wait();
}

// Clusters. The 128-row tile's one-CTA-per-block launch runs as clusters of
// C CTAs (cluster_of gives C; the launch's tensor map then has boxes of
// NB / C rows, and a stage is C such boxes). CTA b still owns block b. The
// CTAs of a cluster whose blocks share a bucket (`Group`) walk the same
// tiles, so each store tile is read once for the group: its j-th loader
// loads boxes j, j + G, ... of every stage with one TMA multicast to the
// whole group, which lands at the same offset in each CTA and completes the
// bytes on each one's full barrier; each loader arms its own barrier for
// the whole stage. A stage is refilled only when every CTA of the group has
// released it: each consumer warp (over codes that are not the operand,
// each converter, since the raw ring is what is multicast and each CTA
// converts its own stages) arrives on the empty barrier of every CTA of
// the group, whose count is G times its own. So no CTA's stage can run a
// phase ahead of a peer's, and a parity wait stays within two phases. A
// box past the bucket's last row is not loaded (nor counted). The edges of
// a cluster's life:
//   - every thread of every CTA meets at one cluster barrier after the
//     mbarriers are initialised, before any multicast or remote arrive;
//   - no CTA of a group exits while a peer may still arrive on its
//     barriers: each arriving warp, after its last remote arrive, arrives
//     on the `done` barrier of every CTA of the group (at the cluster's
//     scope, so its arrives before land first), and the consumers wait
//     for all of them before they exit. A multicast into a CTA is
//     waited for by its own consumers. A CTA outside any group (an empty
//     block, a group of one, a CTA past the last block) meets no peer
//     after the start.
// The epilogue, the lists and the pool are those of the launch without a
// cluster, so the result is the same to the bit. It is slower than the
// launch without one (2 CTAs by 8-9%, 4 by 22-23% on the 300K store,
// PERF.md): each stage waits for the slowest CTA of its group, and the
// reads it saves were not what held the loop.
//
// T: the type of the queries and of the operand stages: bfloat16 or
// float16, or signed char for int8 query codes (SRC_INT8 or SRC_INT4 only).
// KL: the capacity of a slot row's list when the thread that inserts into
// it holds it in registers (16 or 32, at least k), or 0 for a list in
// shared memory (k above 32). POOL_ON: the launch keeps the rerank pool
// (k_out > k); the kernels without it carry none of its registers. SRC and
// NB as in probe_kernel; `map` is the tensor map over the store
// (`store_map`).
template <typename T, int SRC, int NB, int KL, bool POOL_ON>
__global__ void __launch_bounds__(threads(SRC, sizeof(T)))
    probe_kernel_wgmma(const __grid_constant__ CUtensorMap map,
                       const ProbeArgs a) {
  using Acc = AccOf<T>;
  constexpr int QBYTES = sizeof(T);
  constexpr int SL = slice_of(QBYTES);       // features of a slice
  constexpr int NW = NB / 64;                // 64-bit words of a row's columns
  constexpr int LDT = NB + 4;
  constexpr int RAWB = raw_row_bytes(SRC, QBYTES);
  constexpr bool RAW = RAWB > 0;             // a raw ring and converters
  constexpr int STAGE_BYTES = NB * SLICE_BYTES;
  constexpr int RAW_BYTES = NB * RAWB;
  constexpr int NTHREADS = threads(SRC, QBYTES);
  constexpr int GATHERERS = NTHREADS - 32;   // all but the loader's warp
  constexpr int CONSUMERS = CONSUMER_WARPS * 32;
  constexpr bool SCALED = SRC != SRC_SAME;
  extern __shared__ unsigned char smem_raw[];
  unsigned char *as = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T *q = static_cast<const T *>(a.q);
  const int d = a.d, k = a.k;
  const int ks = slices(d, QBYTES);
  const long long n_rows = a.n_rows;
  const bool flat = a.items != nullptr;
  constexpr bool pooled = POOL_ON;
  const int S = stages(d, SRC, QBYTES, k, NB, pooled);

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
  // full, raw stage empty; then the group's `done`
  const uint32_t bar0 = smem_addr(bars);
  auto op_full = [&](int i) { return bar0 + 8 * i; };
  auto op_empty = [&](int i) { return bar0 + 8 * (MAX_STAGES + i); };
  auto raw_full = [&](int i) { return bar0 + 8 * (2 * MAX_STAGES + i); };
  auto raw_empty = [&](int i) { return bar0 + 8 * (3 * MAX_STAGES + i); };
  const uint32_t done = bar0 + 8 * (4 * MAX_STAGES);
  // CTAs of the cluster (1: none) and this CTA's group in it
  const int C = clustered_tile<NB>() ? cluster_ctas() : 1;

  // the range, worked out in the distance tile's memory, unused till then
  int pos0, end;
  if (!cta_range<NB, NTHREADS>(a, reinterpret_cast<long long *>(tile), pos0,
                               end)) {
    if (C > 1) cluster_sync();   // the peers' start
    return;
  }
  const Group grp = clustered_tile<NB>() ? cluster_group(a, C)
                                         : Group{0, 1, 0};
  // A stage handed back by a whole warp, to every CTA of the group: lane r
  // arrives on the group's r-th CTA, all at once, and only ever on that
  // one (which the end's `done` relies on).
  auto give_back = [&](uint32_t bar) {
    if (grp.size == 1) {
      if (lane == 0) mbar_arrive(bar);
    } else if (lane < grp.size) {
      mbar_arrive_at<false>(bar, grp.first + lane);
    }
  };
  // A warp's last arrive: on each CTA of the group's `done`, at the
  // cluster's scope, after the lane's arrives on that CTA.
  auto say_done = [&]() {
    if (lane < grp.size) mbar_arrive_at<true>(done, grp.first + lane);
  };
  int pos = pos0;
  Piece pc;
  next_piece<NB>(a, pos, end, pc);   // a range holds at least one item

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(op_full(i), 1);
      // the ring the loaders fill is released by the whole group
      mbar_init(op_empty(i), CONSUMER_WARPS * (RAW ? 1 : grp.size));
      mbar_init(raw_full(i), 1);
      mbar_init(raw_empty(i), grp.size);
    }
    mbar_init(done, grp.size * (CONSUMER_WARPS + (RAW ? CONVERTER_WARPS : 0)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < QB * k; i += NTHREADS) list[i] = make_key(SENTINEL, -1);
  for (int i = tid; i < QB; i += NTHREADS) {
    thr[i] = SENTINEL;
    qrow[i] = a.qidx[pc.blk * QB + i];
  }
  if (pooled)
    for (int i = tid; i < QB * POOL; i += NTHREADS) pool_s[i] = EMPTY_KEY;
  __syncthreads();
  if (C > 1) cluster_sync();   // every peer's barriers are initialised

  if (warp == CONSUMER_WARPS) {
    // ---------------------------------------------------------- the loader
    // It starts at once: the ring fills while the other warps gather. It
    // runs through every piece of the CTA's range without a pause, so the
    // ring is full when the consumers come back from a piece's end. Its
    // stage and phase run on across pieces, as the consumers' do. In a
    // cluster a stage is C boxes of NB / C rows, of which this loader loads
    // every G-th into the whole group.
    if (lane != 0) return;
    const uint32_t dst0 = smem_addr(RAW ? raws : bs);
    constexpr int BYTES = RAW ? RAW_BYTES : STAGE_BYTES;
    constexpr int STEP = RAW ? RAWB : SL;   // elements of the map
    const int box_rows = NB / C, box_bytes = BYTES / C;
    const uint16_t mask = grp.mask();
    int st = 0, ph = 0;
    Piece lp;
    for (int lpos = pos0; next_piece<NB>(a, lpos, end, lp);) {
      for (int t = 0; t < lp.n_tiles; ++t) {
        const int t0 = lp.t_lo + t * NB;
        const int row = int(lp.dstart) + t0;
        // the boxes that hold a row of the bucket
        const int boxes = min(C, (lp.t_hi - t0 + box_rows - 1) / box_rows);
        for (int s = 0; s < ks; ++s) {
          mbar_wait(RAW ? raw_empty(st) : op_empty(st), ph ^ 1);
          const uint32_t full = RAW ? raw_full(st) : op_full(st);
          mbar_expect_tx(full, boxes * box_bytes);
          for (int i = grp.j; i < boxes; i += grp.size) {
            const uint32_t dst = dst0 + st * BYTES + i * box_bytes;
            if (grp.size > 1)
              tma_load_2d_multicast(dst, &map, full, s * STEP,
                                    row + i * box_rows, mask);
            else
              tma_load_2d(dst, &map, full, s * STEP, row + i * box_rows);
          }
          if (++st == S) { st = 0; ph ^= 1; }
        }
      }
    }
    return;
  }

  // The first piece's resident queries, gathered by every warp but the
  // loader's; a later piece's by the consumers alone.
  gather_queries<T, SRC>(as, q, qrow, d, pc.nq,
                         tid < CONSUMERS ? tid : tid - 32, GATHERERS);
  fence_async_smem();
  asm volatile("bar.sync 1, %0;\n" ::"r"(GATHERERS) : "memory");

  if (warp > CONSUMER_WARPS) {
    // ------------------------------------------------------ the converters
    // Each converter warp takes whole stages, every `step`-th one, so
    // several stages are under conversion at once and one's latency hides
    // behind the others'. No more warps than stages convert: a wait on a
    // phase's parity tells two phases apart, not three, so a warp's first
    // stage must lie in the ring's first round. The stages of all pieces
    // are one sequence.
    if constexpr (RAW) {
      const int cw = warp - CONSUMER_WARPS - 1;
      const int step = min(CONVERTER_WARPS, S);
      int n_stages = 0;
      Piece cp;
      for (int cpos = pos0; next_piece<NB>(a, cpos, end, cp);)
        n_stages += cp.n_tiles * ks;
      int st = cw, ph = 0;
      for (int it = cw; cw < step && it < n_stages; it += step) {
        mbar_wait(raw_full(st), ph);
        mbar_wait(op_empty(st), ph ^ 1);
        convert_stage<T, SRC, NB>(raws + st * RAW_BYTES, bs + st * STAGE_BYTES,
                                  lane);
        // every lane's writes are fenced for wgmma, then one lane arrives
        fence_async_smem();
        __syncwarp();
        if (lane == 0) mbar_arrive(op_full(st));
        give_back(raw_empty(st));
        st += step;
        if (st >= S) { st -= S; ph ^= 1; }
      }
      if (grp.size > 1) say_done();
    }
    return;
  }

  // --------------------------------------------------------- the consumers
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const float inf = __int_as_float(0x7f800000);
  const uint64_t adesc = operand_desc(smem_addr(as));
  const uint64_t bdesc = operand_desc(smem_addr(bs));
  // an operand stage read: back to the group's loaders, or, where
  // converters fill the operand ring, to this CTA's converters
  auto release = [&](uint32_t bar) {
    if constexpr (RAW) {
      if (lane == 0) mbar_arrive(bar);
    } else {
      give_back(bar);
    }
  };
  float *scw = sc + warp * NB;
  Acc acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0;
  // the list of the slot row that this thread inserts into (threads 0 and 1
  // of each four: rows r0 and r1), when it is held in registers
  constexpr int HELD = KL > 0 ? KL : 1;
  float held_d[HELD];
  int held_i[HELD];
#if PROBE_CLOCKS
  long long c_wait = 0, c_mma = 0, c_test = 0, c_pool = 0, c_insert = 0,
            c_between = 0;
  int n_pieces = 0, tiles_seen = 0;
#endif
  PROBE_TICK(c_start);
  // the ring's stage and phase run on across pieces, as the loader's do
  int st = 0, ph = 0;
  for (;;) {
    const long long dstart = pc.dstart;
    const int nq = pc.nq, t_lo = pc.t_lo, t_hi = pc.t_hi;
    const int n_tiles = pc.n_tiles;
    // the pool's gate of rows r0 and r1: a live row's starts open, a dead
    // row's stays shut
    float u0 = r0 < nq ? inf : -inf, u1 = r1 < nq ? inf : -inf;
#pragma unroll
    for (int p = 0; p < HELD; ++p) {
      held_d[p] = SENTINEL;
      held_i[p] = -1;
    }
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
          // four steps of 32 bytes a slice
#pragma unroll
          for (int kk = 0; kk < SLICE_BYTES / 32; ++kk)
            wgmma_step<T, NB>(acc, adesc + ((s * A_SLICE_BYTES + kk * 32) >> 4),
                              bdesc + ((st * STAGE_BYTES + kk * 32) >> 4),
                              (s | kk) != 0);
        }
        wgmma_commit();
        if (s > 0) {
          // the slice before this one has been read
          wgmma_wait<1>();
          release(op_empty(prev));
        }
        prev = st;
        if (++st == S) { st = 0; ph ^= 1; }
        PROBE_TOCK(c_mma, c1);
      }
      PROBE_TICK(c2);
      wgmma_wait<0>();
      release(op_empty(prev));
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
      // [4 j + 3]). It turns them into distances (kept in the sums'
      // registers), marks in hit0 / hit1 (one bit a column, before the shift
      // by 2 tq) those under the row's k-th best, and notes whether any
      // passes its row's pool gate.
      const float th0 = r0 < nq ? thr[r0] : -inf;
      const float th1 = r1 < nq ? thr[r1] : -inf;
      unsigned long long hit0[NW], hit1[NW], pm0[NW], pm1[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) hit0[w] = hit1[w] = pm0[w] = pm1[w] = 0;
#pragma unroll
      for (int j = 0; j < NB / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * tq + (e & 1);
          const float s = sum_of(acc[4 * j + e]);
          float v = 1.0f - s;
          if constexpr (SCALED && !(PROBE_PARTS_OFF & 8))
            v = __fsub_rn(1.0f, __fmul_rn(s, scw[c]));
          v = c < ncol ? v : inf;
          keep(acc[4 * j + e], v);
          const unsigned long long bit = 1ull << ((8 * j + (e & 1)) & 63);
          if (e & 2) hit1[j / 8] |= v < th1 ? bit : 0;
          else hit0[j / 8] |= v < th0 ? bit : 0;
          if constexpr (pooled && !(PROBE_PARTS_OFF & 48)) {
            // the pool's gate: dead rows' are -inf
            if (e & 2) pm1[j / 8] |= c < ncol && v <= u1 ? bit : 0;
            else pm0[j / 8] |= c < ncol && v <= u0 ? bit : 0;
          } else if constexpr (pooled && (PROBE_PARTS_OFF & 48) == 16) {
            // no gate: each column folded by the thread that holds it
            const int r = (e & 2) ? r1 : r0;
            PoolKey *slot = pool_s + r * POOL +
                            (((t0 + c) & (POOL - 1)) ^ pool_swz(r));
            const PoolKey key = make_key(v, int(row0) + c);
            if (c < ncol && r < nq && key < *slot) *slot = key;
          }
        }
      }
      unsigned long long some = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) some |= hit0[w] | hit1[w] | pm0[w] | pm1[w];
      PROBE_TOCK(c_test, c3);
      // the common case after the first tiles: no column beats its row's k-th
      // best or passes its row's pool gate
      if (__any_sync(FULL, some != 0) && !(PROBE_PARTS_OFF & 1)) {
        PROBE_TICK(c4);
#pragma unroll
        for (int j = 0; j < NB / 8; ++j) {
          const int c = 8 * j + 2 * tq;
          *reinterpret_cast<float2 *>(tile + r0 * LDT + c) =
              make_float2(kept(acc[4 * j]), kept(acc[4 * j + 1]));
          *reinterpret_cast<float2 *>(tile + r1 * LDT + c) =
              make_float2(kept(acc[4 * j + 2]), kept(acc[4 * j + 3]));
        }
        // the four threads of a row join their marks; the first of them then
        // inserts row r0's marked columns, the second row r1's, in column
        // order, and folds those that passed the row's pool gate
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          hit0[w] <<= 2 * tq;
          hit1[w] <<= 2 * tq;
          hit0[w] |= __shfl_xor_sync(FULL, hit0[w], 1);
          hit0[w] |= __shfl_xor_sync(FULL, hit0[w], 2);
          hit1[w] |= __shfl_xor_sync(FULL, hit1[w], 1);
          hit1[w] |= __shfl_xor_sync(FULL, hit1[w], 2);
          if constexpr (pooled) {
            pm0[w] <<= 2 * tq;
            pm1[w] <<= 2 * tq;
            pm0[w] |= __shfl_xor_sync(FULL, pm0[w], 1);
            pm0[w] |= __shfl_xor_sync(FULL, pm0[w], 2);
            pm1[w] |= __shfl_xor_sync(FULL, pm1[w], 1);
            pm1[w] |= __shfl_xor_sync(FULL, pm1[w], 2);
          }
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
          if constexpr (pooled) {
            // the row's classes belong to this thread; rows come in
            // ascending order and only a smaller key is stored, so equal
            // distances keep the lower row
            PROBE_TICK(c5);
            PoolKey *prow = pool_s + r * POOL;
            const int swz = pool_swz(r);
#pragma unroll
            for (int w = 0; w < NW; ++w) {
              unsigned long long marks = tq == 0 ? pm0[w] : pm1[w];
              while (marks) {
                const int c = 64 * w + __ffsll(marks) - 1;
                marks &= marks - 1;
                const PoolKey key = make_key(trow[c], int(row0) + c);
                PoolKey *slot = prow + (((t0 + c) & (POOL - 1)) ^ swz);
                if (key < *slot) *slot = key;
              }
            }
            PROBE_TOCK(c_pool, c5);
          }
        }
        __syncwarp();
        PROBE_TOCK(c_insert, c4);
      }
      if constexpr (pooled) {
        if (t > 0 && ((t + 1) & t) == 0 && !(PROBE_PARTS_OFF & 16)) {
          // after tiles 2, 4, 8, ...: the warp's 16 rows' gates anew, R rows
          // side by side (the warp's folds are behind the __syncwarp above)
          PROBE_TICK(c6);
          constexpr int R = GATE_ROWS;
          for (int i0 = 0; i0 < 16 && warp * 16 + i0 < nq; i0 += R) {
            float u[R];
            kth_class_best<R>(pool_s + (warp * 16 + i0) * POOL, a.k_out, lane,
                              u);
#pragma unroll
            for (int i = 0; i < R; ++i) {
              const bool live = warp * 16 + i0 + i < nq;
              u0 = live && i0 + i == g ? u[i] : u0;
              u1 = live && i0 + i == g + 8 ? u[i] : u1;
            }
          }
          PROBE_TOCK(c_pool, c6);
        }
      }
    }
    PROBE_TICK(c_out);
#if PROBE_CLOCKS
    ++n_pieces;
    tiles_seen += n_tiles;
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
    // each warp writes its own 16 slot rows: with items the piece's partial
    // lists, at the part row of its first item, else the block's final rows
    __syncwarp();
    const size_t orow = size_t(pc.first) * QB;
    const int ko = flat ? k : a.k_out;
    for (int i = lane; i < 16 * k; i += 32) {
      const int r = warp * 16 + i / k, p = i % k;
      const PoolKey key = list[p * QB + r];
      a.out_d[(orow + r) * ko + p] = key_dist(key);
      a.out_i[(orow + r) * ko + p] = int(unsigned(key));
    }
    if constexpr (pooled && !(PROBE_PARTS_OFF & 64)) {
      if (flat) {
        // the global pool keeps classes in order: the swizzle is undone here
        PoolKey *pool_g = a.pool + (size_t(pc.blk) * QB + warp * 16) * POOL;
        for (int i = lane; i < 16 * POOL; i += 32) {
          const int r = warp * 16 + i / POOL, c = i % POOL;
          const PoolKey key = pool_s[r * POOL + (c ^ pool_swz(r))];
          if (key != EMPTY_KEY) atomicMin(pool_g + i, key);
        }
      } else {
        for (int r = warp * 16; r < warp * 16 + 16; ++r)
          // a key's low word is its row
          write_extras(pool_s + r * POOL,
                       reinterpret_cast<const int *>(list + r), k, a.k_out,
                       a.out_d + (orow + r) * ko, a.out_i + (orow + r) * ko,
                       2 * QB);
      }
    }
    if (flat && tid == 0) a.written[pc.first] = 1;
    if (!next_piece<NB>(a, pos, end, pc)) break;

    // The next piece, of another block (or of the same block, past another
    // CTA's items). The warp's own rows first: lists, thresholds, pool.
    __syncwarp();
    for (int i = lane; i < 16 * k; i += 32)
      list[(i % k) * QB + warp * 16 + i / k] = make_key(SENTINEL, -1);
    if (lane < 16) thr[warp * 16 + lane] = SENTINEL;
    if constexpr (pooled)
      for (int i = lane; i < 16 * POOL; i += 32)
        pool_s[warp * 16 * POOL + i] = EMPTY_KEY;
    // Then the queries: every consumer warp has waited for its last wgmma
    // (wgmma_wait<0> after the last slice), so once all four are here no
    // wgmma reads the old ones. The loader and the converters run on.
    asm volatile("bar.sync 2, %0;\n" ::"n"(CONSUMERS) : "memory");
    for (int i = tid; i < QB; i += CONSUMERS) qrow[i] = a.qidx[pc.blk * QB + i];
    asm volatile("bar.sync 2, %0;\n" ::"n"(CONSUMERS) : "memory");
    gather_queries<T, SRC>(as, q, qrow, d, pc.nq, tid, CONSUMERS);
    fence_async_smem();
    asm volatile("bar.sync 2, %0;\n" ::"n"(CONSUMERS) : "memory");
    PROBE_TOCK(c_between, c_out);
  }
#if PROBE_CLOCKS
  if (warp == 1 && lane == 0 && blockIdx.x % 97 == 5 && tiles_seen > 0)
    printf("[clocks] cta %d: %d pieces, %d tiles of %d slices, %lld cycles: "
           "%lld waiting for a stage, %lld in wgmma, %lld testing, %lld "
           "writing the tile, inserting and folding into the pool, %lld in "
           "the pool's folds and gates, %lld between pieces (the next "
           "piece's queries)\n",
           int(blockIdx.x), n_pieces, tiles_seen, ks, clock64() - c_start,
           c_wait, c_mma, c_test, c_insert, c_pool, c_between);
#endif
  if (grp.size > 1) {
    // the warp's last arrive on a peer is behind it; the CTA exits once
    // every peer's arriving warps have said the same
    say_done();
    mbar_wait(done, 0);
  }
}

// The tensor map over the store that the loader's TMA loads go through:
// rows of `d` values of T (SRC_SAME) or of code bytes. Where the loads land
// in the operand ring, boxes of NB / `cluster` rows x 128 bytes (64 values,
// or 128 int8 codes under int8 queries) in the 128-byte swizzle; else boxes
// of NB / `cluster` rows x the raw ring's bytes as they lie. A box of a
// stage of `cluster` boxes starts at a multiple of 1 KB (the swizzle's
// period) or lies as the rows do, so the stage's layout is the same. cuTensorMapEncodeTiled lives in libcuda; the runtime hands out
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
int store_map(CUtensorMap *map, const ProbeArgs &a, int cluster) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return int(cudaErrorNotSupported);
  if (a.n_rows < 1 || reinterpret_cast<uintptr_t>(a.data) % 16 != 0)
    return int(cudaErrorInvalidValue);
  constexpr bool CODES = SRC != SRC_SAME;
  constexpr int RAWB = raw_row_bytes(SRC, sizeof(T));
  const CUtensorMapDataType type =
      CODES ? CU_TENSOR_MAP_DATA_TYPE_UINT8
            : (std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  const cuuint64_t width = SRC == SRC_INT4 ? a.d / 2 : a.d;
  const cuuint64_t dims[2] = {width, cuuint64_t(a.n_rows)};
  const cuuint64_t strides[1] = {width * (CODES ? 1 : sizeof(T))};
  const cuuint32_t box[2] = {
      cuuint32_t(RAWB > 0 ? RAWB : slice_of(sizeof(T))),
      cuuint32_t(NB / cluster)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(
      map, type, 2, const_cast<void *>(a.data), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      RAWB > 0 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : int(cudaErrorInvalidValue);
}

// With a worklist the grid is persistent: `ctas` CTAs, or as many as the
// card holds at once at this launch's shared memory (the SMs times the CTAs
// an SM takes), never more than the items the scratch holds; the kernel
// caps it again by the true total, which only the device knows. Without
// one, one CTA a block, in clusters of `cluster` CTAs (the grid rounded up
// to whole clusters) when it is above 1; a cluster shape that the card
// cannot hold at once is refused (cudaErrorInvalidConfiguration), never
// launched otherwise.
template <typename T, int SRC, int NB, int KL, bool POOL_ON>
int launch_pooled(const CUtensorMap &map, const ProbeArgs &a, int n_ctas,
                  int ctas, int cluster, size_t smem, cudaStream_t stream) {
  const auto kernel = probe_kernel_wgmma<T, SRC, NB, KL, POOL_ON>;
  constexpr int NTHREADS = threads(SRC, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (a.items != nullptr) {
    int grid = ctas;
    if (grid <= 0) {
      int dev = 0, sms = 0, per_sm = 0;
      if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
          (err = cudaDeviceGetAttribute(
               &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, kernel, NTHREADS, smem)) != cudaSuccess)
        return int(err);
      grid = sms * max(per_sm, 1);
    }
    n_ctas = min(n_ctas, grid);
  }
  if (cluster == 1) {
    kernel<<<n_ctas, NTHREADS, smem, stream>>>(map, a);
    return int(cudaGetLastError());
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned((n_ctas + cluster - 1) / cluster * cluster));
  cfg.blockDim = dim3(unsigned(NTHREADS));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fits = 0;
  err = cudaOccupancyMaxActiveClusters(&fits, (const void *)kernel, &cfg);
  if (err != cudaSuccess) return int(err);
  if (fits == 0) return int(cudaErrorInvalidConfiguration);
  void *args[] = {const_cast<CUtensorMap *>(&map),
                  const_cast<ProbeArgs *>(&a)};
  err = cudaLaunchKernelExC(&cfg, (const void *)kernel, args);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

template <typename T, int SRC, int NB, int KL>
int launch_held(const CUtensorMap &map, const ProbeArgs &a, int n_ctas,
                int ctas, int cluster, size_t smem, cudaStream_t stream) {
  return a.k_out > a.k
             ? launch_pooled<T, SRC, NB, KL, true>(map, a, n_ctas, ctas,
                                                   cluster, smem, stream)
             : launch_pooled<T, SRC, NB, KL, false>(map, a, n_ctas, ctas,
                                                    cluster, smem, stream);
}

// `cluster`: CTAs of a cluster (1: none), for a launch without a worklist
// of a kernel that has the cluster path (clustered_tile).
template <typename T, int SRC, int NB>
int launch(const ProbeArgs &a, int n_ctas, int ctas, int cluster,
           cudaStream_t stream) {
  if (!cluster_ok(cluster) ||
      (cluster > 1 && (!clustered_tile<NB>() || a.items != nullptr)))
    return int(cudaErrorInvalidValue);
  CUtensorMap map;
  const int bad = store_map<T, SRC, NB>(&map, a, cluster);
  if (bad != 0) return bad;
  const bool pool = a.k_out > a.k;
  constexpr int QBYTES = sizeof(T);
  const size_t smem = smem_bytes(a.d, SRC, QBYTES, a.k, NB, pool,
                                 stages(a.d, SRC, QBYTES, a.k, NB, pool));
  // a list of up to 32 entries is held in registers
  if (a.k <= 16)
    return launch_held<T, SRC, NB, 16>(map, a, n_ctas, ctas, cluster, smem,
                                       stream);
  if (a.k <= 32)
    return launch_held<T, SRC, NB, 32>(map, a, n_ctas, ctas, cluster, smem,
                                       stream);
  return launch_held<T, SRC, NB, 0>(map, a, n_ctas, ctas, cluster, smem,
                                    stream);
}

}  // namespace hopper
}  // namespace probe
