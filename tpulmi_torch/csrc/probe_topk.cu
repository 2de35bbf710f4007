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
// The kernel itself is csrc/probe_common.cuh::probe_kernel, shared with the
// quantized-store variants of probe_topk_quant.cu; this file instantiates it
// for stores that hold vectors of the queries' type. It is compiled twice:
// as it is (tiles of 64 store rows) and with -DPROBE_NB=128 (the paired tile,
// which replaces the `pair` grid of the TPU kernel). Either library also runs
// the worklist (`items`) and the rerank pool (`k_out > k`), see the header.
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

#include "probe_common.cuh"

#ifndef PROBE_NB
#define PROBE_NB 64
#endif

extern "C" {

// Slots per block: the wrapper lays slots out in blocks of this size.
int probe_topk_block_slots() { return probe::QB; }

// Store rows per tile of this library, and the shared memory one CTA takes
// for lists of k entries, with or without the pool.
int probe_topk_tile_rows() { return PROBE_NB; }
long long probe_topk_smem_bytes(int k, int pool) {
  return (long long)probe::smem_bytes(probe::kpl_of(k), PROBE_NB, pool != 0);
}

// Launch `n_ctas` CTAs on `stream`: one per block of `blocks`, or, with
// `items` (n_ctas, 2), one per work item of `span` store rows, which writes
// partial lists (n_ctas * QB, k) to out_d / out_i and folds its pool into
// `pool`. `k_out` > k asks for the pool (k_out = k: none). `dtype` is the
// type of q and data: 0 bfloat16, 1 float16, 2 float32. Returns the CUDA
// error code of the launch (0 = ok).
int probe_topk_launch(const void *q, const void *qidx, const void *data,
                      const void *blocks, const void *items, void *out_d,
                      void *out_i, void *pool, int n_ctas, int d,
                      long long n_rows, int k, int k_out, int span, int dtype,
                      void *stream) {
  using namespace probe;
  if (n_ctas <= 0) return 0;
  const ProbeArgs a{q, static_cast<const int *>(qidx), data, nullptr,
                    static_cast<const int *>(blocks),
                    static_cast<const int *>(items),
                    static_cast<float *>(out_d), static_cast<int *>(out_i),
                    static_cast<PoolKey *>(pool), d, n_rows, k, k_out, span,
                    1.0f};
  if (!sizes_ok(a) || d < 8 || d % 8 != 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_k<__nv_bfloat16, SRC_SAME, PROBE_NB>(a, n_ctas, s);
    case 1:
      return launch_k<__half, SRC_SAME, PROBE_NB>(a, n_ctas, s);
    case 2:
      return launch_k<float, SRC_SAME, PROBE_NB>(a, n_ctas, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
